"""The port's checkpointing against the JAX package's.

``repro_torch.checkpointing`` writes its own file format on the standard
library, numpy and torch (the reference's writer needs msgpack and
zstandard).  What it copies is held bit for bit against the reference:
``pack_json`` / ``unpack_json``, the path-key ``_flatten`` / ``_unflatten``
on nested dict/list/tuple trees, ``PeriodicSnapshotter``'s cadence and
``CheckpointManager``'s rotation, best retention and index reload on the
same step and metric sequence.  The writer round-trips every leaf kind a
snapshot holds (f32, bf16, 0-d int32, int64 and float64 numpy values that
do not fit 32 bits, empty subtrees, a (0, 4) float64 array), leaves no
temporary file, stores aliased leaves apart and touches no live tensor.

Then the Simulators: the port's ``_fingerprint`` equals the reference's
hex digest for the same configurations, and a snapshot that both write at
the same tick of one async run, from the reference's initial state
(``bridge.load_reference_state``), has the same keys, the same
fingerprint, the same discrete-event state (losses within 1e-4) and arrays
within the parity tolerances of tests/test_torch_event.py.
"""
import os

# the JAX reference runs on the CPU in these comparisons
os.environ["JAX_PLATFORMS"] = "cpu"

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro_torch import bridge
from repro_torch import fed as t_fed
from repro_torch.checkpointing import checkpoint as t_ckpt
from repro_torch.checkpointing import manager as t_mgr
from repro_torch.configs import REGISTRY, reduced
from repro_torch.data import make_emotion_dataset
from repro_torch.numerics import set_fp32_policy
from repro_torch.optim import AdamW

set_fp32_policy()

# a mean loss after AdamW steps (tests/test_torch_event.py), and adapters
# and moments within 2 * lr a step (tests/test_torch_simulator.py)
LOSS_RTOL = 1e-4
LR = 1e-3


def _trees():
    return {
        "nested": {"b": {"z": np.arange(6, dtype=np.float32).reshape(2, 3),
                         "a": (np.int64(2 ** 62 + 1), [np.float64(1 / 3), np.zeros((0, 4))])},
                   "a": [np.uint8(7), (np.ones(3, np.int32),)]},
        "list_root": [{"x": np.float32(1.5)}, {"y": np.arange(3)}, (np.float64(-0.0),)],
        "tuple_root": (np.int32(1), {"k": np.float64(2.0), "1:2": {"ver": np.int64(3)}}),
        "scalars": {"f": 0.1, "i": 7, "s": np.array("text")},
    }


def _same(got, want) -> bool:
    """Same container types all the way down and leaves equal in dtype,
    shape and bits."""
    if isinstance(want, dict):
        return type(got) is dict and list(got) == list(want) and all(
            _same(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return type(got) is type(want) and len(got) == len(want) and all(
            _same(g, w) for g, w in zip(got, want))
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape and \
        got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", list(_trees()))
def test_flatten_and_unflatten_are_the_reference_copies(name):
    pytest.importorskip("jax")
    from repro.checkpointing import checkpoint as j_ckpt

    tree = _trees()[name]
    want, got = j_ckpt._flatten(tree), t_ckpt._flatten(tree)
    assert list(got) == list(want) and got
    assert all(_same(got[k], want[k]) for k in want)
    assert _same(t_ckpt._unflatten(got), j_ckpt._unflatten(want))


@pytest.mark.parametrize("obj", [
    {"t": 1.5, "u": [0.1, 1e-300, -0.0, 2 ** 60 + 1], "n": None, "s": "x"},
    [float("nan"), float("inf"), -float("inf"), {"nested": [[1, 2], [3.141592653589793]]}],
    "plain", 12345678901234567890,
])
def test_pack_json_is_the_reference_copy(obj):
    pytest.importorskip("jax")
    from repro.checkpointing import checkpoint as j_ckpt

    want, got = j_ckpt.pack_json(obj), t_ckpt.pack_json(obj)
    assert got.dtype == want.dtype == np.uint8 and got.tobytes() == want.tobytes()
    assert json.dumps(t_ckpt.unpack_json(got)) == json.dumps(j_ckpt.unpack_json(want))


def _manager_trace(mgr_mod, directory):
    """The reference's test_rotation_and_best and test_reload_index_from_disk
    sequences, with everything the manager reports after each save."""
    out = []
    mgr = mgr_mod.CheckpointManager(os.path.join(directory, "best"), keep_last=2, keep_best=1)
    for step, metric in [(1, 0.1), (2, 0.9), (3, 0.3), (4, 0.2), (5, None), (6, 0.95)]:
        path = mgr.save(step, {"x": np.full(3, step)}, metric=metric)
        out.append((os.path.basename(path), mgr.all_steps(), mgr.best_step(),
                    mgr.latest_step(), sorted(os.listdir(mgr.dir))))
    out.append([np.asarray(mgr.restore(s)["x"]).tolist() for s in mgr.all_steps()])
    out.append(np.asarray(mgr.restore()["x"]).tolist())
    reopened = mgr_mod.CheckpointManager(mgr.dir, keep_last=2, keep_best=1)
    out.append((reopened.all_steps(), reopened.best_step(), reopened.latest_step()))
    with open(os.path.join(mgr.dir, "index.json")) as f:
        index = json.load(f)
    out.append({"steps": {s: (os.path.basename(r["path"]), r["metric"])
                          for s, r in index["steps"].items()}, "best": index["best"]})
    mgr = mgr_mod.CheckpointManager(os.path.join(directory, "reload"), keep_last=2)
    mgr.save(7, {"a": np.ones(2)})
    out.append(mgr_mod.CheckpointManager(mgr.dir, keep_last=2).latest_step())
    return out


def test_checkpoint_manager_rotates_like_reference(tmp_path):
    pytest.importorskip("jax")
    from repro.checkpointing import manager as j_mgr

    want = _manager_trace(j_mgr, str(tmp_path / "ref"))
    got = _manager_trace(t_mgr, str(tmp_path / "port"))
    assert got == want
    assert got[3][1] == [2, 3, 4] and got[3][2] == 2      # last 2 + best


def _snapshotter_trace(mgr_mod, directory):
    out = []
    snap = mgr_mod.PeriodicSnapshotter(directory, 0.3, keep_last=2)
    for now in (0.1, 0.25, 0.3, 0.31, 0.9, 0.95, 1.7, 2.0, 2.05):
        due = snap.due(now)
        path = snap.maybe_save(now, lambda: {"now": np.float64(now)})
        out.append((now, due, None if path is None else os.path.basename(path),
                    snap.next_due, snap.manager.all_steps()))
    snap.fast_forward(3.1)
    out.append(snap.next_due)
    # a snapshotter reopened on the directory continues the series
    again = mgr_mod.PeriodicSnapshotter(directory, 0.3, keep_last=2)
    again.fast_forward(2.05)
    out.append((again.next_due, again.maybe_save(2.4, lambda: {"n": np.int64(1)}) is not None,
                again.manager.all_steps()))
    out.append(float(np.asarray(mgr_mod.load_snapshot(directory)["n"])))
    with pytest.raises(ValueError):
        mgr_mod.PeriodicSnapshotter(directory, 0.0)
    return out


def test_periodic_snapshotter_like_reference(tmp_path):
    pytest.importorskip("jax")
    from repro.checkpointing import manager as j_mgr

    want = _snapshotter_trace(j_mgr, str(tmp_path / "ref"))
    got = _snapshotter_trace(t_mgr, str(tmp_path / "port"))
    assert got == want
    assert [row[2] for row in got[:9]].count(None) == 5


# -- the port's writer -------------------------------------------------------------

def _snapshot_like_tree():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(4, 6, generator=gen)
    opt = AdamW(1e-3).init({"w": a})
    return {
        "f32": a,
        "bf16": torch.randn(3, 5, generator=gen).to(torch.bfloat16),
        "opt": tuple(opt._replace(step=torch.tensor(7, dtype=torch.int32))),
        "i64": np.array([2 ** 62 + 1, -(2 ** 40) - 3], np.int64),
        "f64": np.float64(0.1) + np.float64(2.0 ** -52),
        "loss_events": np.zeros((0, 4), np.float64),
        "round_pull": {},
        "hist": [],
        "empty_tuple": (),
        "nested": {"L0": {"t": torch.arange(5, dtype=torch.int64)}, "json": t_ckpt.pack_json({"x": 1})},
    }


def test_writer_round_trips_every_leaf_kind(tmp_path):
    tree = _snapshot_like_tree()
    path = str(tmp_path / "deep" / "snap.ckpt")
    t_ckpt.save(path, tree)
    assert os.listdir(tmp_path / "deep") == ["snap.ckpt"]      # no .tmp left
    got = t_ckpt.load(path, device="cpu")

    assert set(got) == set(tree)
    for key in ("f32", "bf16"):
        assert got[key].dtype == tree[key].dtype and got[key].is_contiguous()
        assert torch.equal(got[key].view(torch.int16 if key == "bf16" else torch.int32),
                           tree[key].view(torch.int16 if key == "bf16" else torch.int32))
    step, mu, nu = got["opt"]
    assert step.dtype == torch.int32 and step.dim() == 0 and int(step) == 7
    assert torch.equal(mu["w"], tree["opt"][1]["w"]) and torch.equal(nu["w"], tree["opt"][2]["w"])
    assert isinstance(got["i64"], np.ndarray) and got["i64"].dtype == np.int64
    assert got["i64"].tolist() == [2 ** 62 + 1, -(2 ** 40) - 3]
    assert isinstance(got["f64"], np.ndarray) and got["f64"].dtype == np.float64
    assert got["f64"].tobytes() == np.float64(tree["f64"]).tobytes()
    assert got["loss_events"].shape == (0, 4) and got["loss_events"].dtype == np.float64
    assert got["round_pull"] == {} and got["hist"] == [] and got["empty_tuple"] == ()
    assert torch.equal(got["nested"]["L0"]["t"], tree["nested"]["L0"]["t"])
    assert t_ckpt.unpack_json(got["nested"]["json"]) == {"x": 1}


def test_writer_stores_aliases_apart_and_leaves_live_tensors_alone(tmp_path):
    """A round-start pull aliases the live adapters: the file stores every
    leaf, and the loaded leaves own separate storage.  A transposed view is
    written in its logical order; the live view keeps its strides."""
    base = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    view = base.t()
    tree = {"live": base, "pull": base, "view": view}
    path = str(tmp_path / "alias.ckpt")
    t_ckpt.save(path, tree)
    assert view.stride() == (1, 4) and view.data_ptr() == base.data_ptr()
    got = t_ckpt.load(path, device="cpu")
    assert got["live"].data_ptr() != got["pull"].data_ptr()
    got["pull"].add_(1.0)
    assert torch.equal(got["live"], base)
    assert torch.equal(got["view"], view) and got["view"].is_contiguous()


def test_writer_needs_the_card_only_for_tensor_leaves(tmp_path, monkeypatch):
    t_ckpt.save(str(tmp_path / "np.ckpt"), {"a": np.ones(3)})
    t_ckpt.save(str(tmp_path / "t.ckpt"), {"a": torch.ones(3)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_ckpt.load(str(tmp_path / "np.ckpt"))["a"].tolist() == [1.0, 1.0, 1.0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ckpt.load(str(tmp_path / "t.ckpt"))
    (tmp_path / "bad.ckpt").write_bytes(b"\x83\xa1x")
    with pytest.raises(ValueError, match="not a checkpoint"):
        t_ckpt.load(str(tmp_path / "bad.ckpt"), device="cpu")


# -- the Simulators ------------------------------------------------------------------

N_CLIENTS = 4
CUTS = (1,) * N_CLIENTS


def _groups(fed, **kw):
    return dict(engine=fed.EngineConfig(mode="event", **kw.get("engine", {})),
                agg=fed.AggConfig(**kw.get("agg", {})),
                net=fed.NetConfig(**kw.get("net", {})),
                control=fed.ControlConfig(**kw.get("control", {})))


FINGERPRINT_CASES = {
    "buffered": dict(agg=dict(policy="buffered", interval=1, buffer_k=2, max_inflight=2)),
    "sync": dict(engine=dict(scheduler="ours")),
    "staleness_plane_reactive": dict(
        agg=dict(policy="staleness", interval=1, max_inflight=2, staleness_alpha=0.5,
                 transport="plane"),
        net=dict(link_model="gilbert", shared=True, capacity_mbps=150.0),
        control=dict(policy="reactive", hysteresis=0.2)),
    "int8_fused_ragged": dict(engine=dict(fused_lora=True, cohort_chunk=2, cohort_impl="ragged"),
                              agg=dict(policy="buffered", interval=1, max_inflight=2),
                              net=dict(quantize=True)),
}


@pytest.mark.parametrize("name", list(FINGERPRINT_CASES))
def test_fingerprint_equals_reference(name):
    """The digest reads the model's name and shape, the initial cuts, the
    fleet size and the run config (less the snapshot, resume, preemption
    and obs knobs); the reference's method runs on the same fields."""
    pytest.importorskip("jax")
    from repro import fed as j_fed
    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced

    case = FINGERPRINT_CASES[name]
    kw = dict(rounds=3, batch_size=4, seq_len=16, lr=LR, seed=3)
    t_run = t_fed.FedRunConfig(**kw, **_groups(t_fed, **case), snapshot_every=0.5,
                               snapshot_dir="snaps", preempt_at=1.0,
                               obs=t_fed.ObsConfig(metrics=True))
    j_run = j_fed.FedRunConfig(**kw, **_groups(j_fed, **case))
    cfg = reduced(REGISTRY["bert-base"], n_layers=2, d_model=64).with_(vocab_size=4096)
    ts = t_fed.Simulator(cfg, t_fed.PAPER_CLIENTS[:N_CLIENTS], CUTS,
                         *_datasets(make_emotion_dataset), t_run, device="cpu")
    jcfg = j_reduced(J_REGISTRY["bert-base"], n_layers=2, d_model=64).with_(vocab_size=4096)
    want = j_fed.Simulator._fingerprint(SimpleNamespace(run=j_run, cfg=jcfg,
                                                        _init_cuts=list(CUTS), u=N_CLIENTS))
    assert ts._fingerprint() == want and len(want) == 64


def _datasets(make):
    return (make(400, seq_len=16, vocab_size=4096, seed=0),
            make(80, seq_len=16, vocab_size=4096, seed=1))


def _close(got: float, want: float) -> bool:
    if math.isnan(want):
        return math.isnan(got)
    return abs(got - want) <= LOSS_RTOL * abs(want)


def _assert_des_equal(got: dict, want: dict):
    """Equal exactly, but for the losses and evaluations in the run log."""
    assert set(got) == set(want)
    for key in want:
        if key == "history":
            assert len(got[key]) == len(want[key]) and want[key]
            for g, w in zip(got[key], want[key]):
                assert g[:2] == w[:2] and _close(g[2], w[2])
                for ga, wa in zip(g[3:], w[3:]):
                    assert (ga is None and wa is None) or abs(ga - wa) <= 1e-4
        elif key == "wave_losses":
            assert len(got[key]) == len(want[key])
            assert all(_close(g, w) for g, w in zip(got[key], want[key]))
        else:
            assert json.dumps(got[key], sort_keys=True) == \
                json.dumps(want[key], sort_keys=True), key


def test_snapshot_matches_reference_at_one_tick(tmp_path):
    """Both Simulators from the reference's initial state, buffered commits
    of two with two rounds in flight, snapshot and preemption at the same
    tick; the two snapshot files, each read by its own package."""
    jax = pytest.importorskip("jax")
    from repro import fed as j_fed
    from repro.checkpointing import load_snapshot as j_load_snapshot
    from repro.checkpointing import unpack_json as j_unpack
    from repro.configs import REGISTRY as J_REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.data import make_emotion_dataset as j_make

    case = dict(agg=dict(policy="buffered", interval=1, max_inflight=2))
    kw = dict(rounds=2, batch_size=4, seq_len=16, lr=LR)
    cfg = reduced(REGISTRY["bert-base"], n_layers=2, d_model=256).with_(vocab_size=4096)

    def port(**extra):
        return t_fed.Simulator(cfg, t_fed.PAPER_CLIENTS[:N_CLIENTS], CUTS,
                               *_datasets(make_emotion_dataset),
                               t_fed.FedRunConfig(**kw, **_groups(t_fed, **case), **extra),
                               device="cpu")

    def ref(**extra):
        jcfg = j_reduced(J_REGISTRY["bert-base"], n_layers=2, d_model=256).with_(
            vocab_size=4096)
        return j_fed.Simulator(jcfg, j_fed.PAPER_CLIENTS[:N_CLIENTS], CUTS, *_datasets(j_make),
                               j_fed.FedRunConfig(**kw, **_groups(j_fed, **case), **extra))

    whole = ref()
    state = {k: jax.tree.map(np.asarray, getattr(whole, k)) for k in bridge.STATE_KEYS}
    whole.run_training()
    span = whole._clock.now
    knobs = dict(snapshot_every=span / 7, preempt_at=span * 0.6)
    js = ref(**knobs, snapshot_dir=str(tmp_path / "ref"))
    js.run_training()
    ts = port(**knobs, snapshot_dir=str(tmp_path / "port"))
    bridge.load_reference_state(ts, state)
    ts.run_training()
    assert ts.clock_result.preempted and js.clock_result.preempted

    want = jax.tree.map(np.asarray, j_load_snapshot(str(tmp_path / "ref")))
    got = t_mgr.load_snapshot(str(tmp_path / "port"), device="cpu")
    assert got["round_pull"]                      # rounds in flight at the tick
    wflat, gflat = t_ckpt._flatten(want), t_ckpt._flatten(got)
    assert sorted(gflat) == sorted(wflat)
    assert t_ckpt.unpack_json(got["fingerprint"]) == j_unpack(want["fingerprint"])
    _assert_des_equal(t_ckpt.unpack_json(got["des"]), j_unpack(want["des"]))
    # optimizer step counters: each AdamW step may move an element by ~lr
    steps = max(int(v.max()) for k, v in gflat.items() if k.split("\x1f")[-1] == "T0")
    adapter_atol = 2 * LR * steps
    for key, w in wflat.items():
        if key in ("fingerprint", "des"):      # compared above
            continue
        g = gflat[key]
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key == "loss_events":
            assert np.array_equal(g[:, :3], w[:, :3])
            assert all(_close(a, b) for a, b in zip(g[:, 3], w[:, 3]))
        elif g.dtype.kind in "iu" or key == "sim_clock":
            assert np.array_equal(g, w), key
        else:
            assert np.abs(g - w).max() <= adapter_atol, key

    # the port's snapshot, resumed with the same frozen weights, finishes
    # the reference's uninterrupted run
    resumed = port(resume_from=str(tmp_path / "port"))
    bridge.load_reference_state(resumed, state)
    resumed.run_training()
    assert [r.sim_time_s for r in resumed.history] == [r.sim_time_s for r in whole.history]
    assert all(_close(r.mean_loss, w.mean_loss) for r, w in zip(resumed.history, whole.history))
    assert [e[:3] for e in resumed.loss_events] == [e[:3] for e in whole.loss_events]
    assert all(_close(r[3], w[3]) for r, w in zip(resumed.loss_events, whole.loss_events))
    assert resumed.discarded_updates == whole.discarded_updates
