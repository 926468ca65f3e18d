"""The port stands alone: it imports without JAX, loads nothing of the JAX
package, never names either in its sources, and its entry points refuse to
fall back from the card to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

# modules of the later slices (decoder-LM serving; the memory model and
# partitioning; the network and observability planes and the event engine;
# the control plane; checkpointing; the schedules and the training
# entry point; the other families' configs and the input shapes; the
# encoder-decoder; population scale; the launch layer), which
# the walk below must reach
_NEW_MODULES = ("repro_torch.configs.gemma_2b", "repro_torch.configs.rwkv6_3b",
                "repro_torch.kernels.flash_attention", "repro_torch.kernels.wkv6",
                "repro_torch.serving", "repro_torch.serving.engine",
                "repro_torch.core.memory_model", "repro_torch.core.partition",
                "repro_torch.net", "repro_torch.net.links", "repro_torch.net.plane",
                "repro_torch.net.topology", "repro_torch.obs", "repro_torch.obs.des",
                "repro_torch.obs.ledger", "repro_torch.obs.metrics",
                "repro_torch.obs.tracer", "repro_torch.fed.engine",
                "repro_torch.control", "repro_torch.control.controller",
                "repro_torch.control.loop", "repro_torch.control.solver",
                "repro_torch.control.telemetry", "repro_torch.checkpointing",
                "repro_torch.checkpointing.checkpoint",
                "repro_torch.checkpointing.manager", "repro_torch.optim.schedules",
                "repro_torch.launch", "repro_torch.launch.train",
                "repro_torch.configs.shapes", "repro_torch.configs.granite_3_2b",
                "repro_torch.configs.granite_20b", "repro_torch.configs.qwen1_5_4b",
                "repro_torch.configs.qwen3_moe_30b_a3b", "repro_torch.configs.grok_1_314b",
                "repro_torch.configs.internvl2_26b", "repro_torch.configs.zamba2_7b",
                "repro_torch.configs.whisper_large_v3", "repro_torch.models.encdec",
                "repro_torch.fed.fleet", "repro_torch.fed.population",
                "repro_torch.fed.population_async", "repro_torch.fed.population_training",
                "repro_torch.launch.mesh", "repro_torch.launch.sharding",
                "repro_torch.launch.cost_analysis", "repro_torch.launch.steps",
                "repro_torch.launch.dryrun", "repro_torch.launch.serve",
                "repro_torch.kernels.work")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
# the card's machine has neither: the checkpoint writer must not need them
sys.modules["msgpack"] = None
sys.modules["zstandard"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules if k == "repro" or k.startswith("repro."))
print(len(names), leaked)
assert not leaked, leaked
for name in NEW:
    assert name in names, name
# nothing is built at import: a kernel builds at its first launch on the card
from repro_torch.kernels import build
assert not build._LIBS and not build.BUILD_LOG, (build._LIBS, build.BUILD_LOG)
"""


def test_imports_without_jax_and_without_reference_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    code = f"NEW = {_NEW_MODULES!r}\n" + _IMPORT_ALL
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules, leaked = proc.stdout.split(" ", 1)
    assert int(n_modules) >= 64 and leaked.strip() == "[]"


# the reference's package names the port has not ported yet: none since
# the launch layer's mesh and sharding tools (ROADMAP A11)
UNPORTED = {}
PACKAGES = sorted(p.name for p in (SRC / "repro_torch").iterdir()
                  if (p / "__init__.py").exists())


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_match_reference(pkg):
    """Each package of the port exports the reference package's names, less
    the unported ones, and each name resolves."""
    import importlib

    pytest.importorskip("jax")
    port = importlib.import_module(f"repro_torch.{pkg}")
    ref = importlib.import_module(f"repro.{pkg}")
    want = set(getattr(ref, "__all__", ())) - UNPORTED.get(pkg, set())
    assert sorted(getattr(port, "__all__", ())) == sorted(want)
    assert all(hasattr(port, name) for name in want)


_FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|"
                        r"from repro import|import repro\s*$)", re.M)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*(SRC / "repro_torch").rglob("*.py"),
                                         *(SRC / "repro_torch").rglob("*.cu"),
                                         *(SRC / "repro_torch").rglob("*.cuh"),
                                         ROOT / "chip_smoke.py",
                                         ROOT / "examples" / "train_emotion_sfl_torch.py"]))
def test_sources_name_neither_jax_nor_reference_package(path):
    hits = _FORBIDDEN.findall((ROOT / path).read_text())
    assert not hits, (path, hits)


_SERIALIZERS = re.compile(r"^\s*(import|from)\s+(pickle|msgpack|zstandard)\b", re.M)


def test_checkpoints_need_no_pickle(tmp_path, monkeypatch):
    """The checkpoint package names no pickle, msgpack or zstandard, and a
    snapshot-shaped tree saves and loads with every pickle entry point (and
    torch.save / torch.load, which pickle) made to raise."""
    import pickle

    from repro_torch import checkpointing

    for path in (SRC / "repro_torch" / "checkpointing").glob("*.py"):
        assert not _SERIALIZERS.findall(path.read_text()), path

    def refuse(*args, **kwargs):
        raise AssertionError("pickle was used")

    for name in ("dump", "dumps", "load", "loads"):
        monkeypatch.setattr(pickle, name, refuse)
    monkeypatch.setattr(torch, "save", refuse)
    monkeypatch.setattr(torch, "load", refuse)
    tree = {"lora": {"a": torch.ones(2, 3), "b": torch.zeros(3, 2, dtype=torch.bfloat16)},
            "opt": (torch.zeros((), dtype=torch.int32), {}, []),
            "des": checkpointing.pack_json({"now": 0.1})}
    checkpointing.save(str(tmp_path / "snap.ckpt"), tree)
    got = checkpointing.load(str(tmp_path / "snap.ckpt"), device="cpu")
    assert torch.equal(got["lora"]["b"], tree["lora"]["b"]) and got["opt"][1:] == ({}, [])
    assert checkpointing.unpack_json(got["des"]) == {"now": 0.1}


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(REGISTRY["bert-base"], n_layers=1, d_model=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu").type == "cpu"


def test_simulator_defaults_to_cuda(monkeypatch):
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.data import make_emotion_dataset
    from repro_torch.fed import PAPER_CLIENTS, PAPER_CUTS, FedRunConfig, Simulator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(REGISTRY["bert-base"], n_layers=4, d_model=64).with_(vocab_size=4096)
    ds = make_emotion_dataset(200, seq_len=16, vocab_size=4096)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(cfg, PAPER_CLIENTS, PAPER_CUTS, ds, ds,
                  FedRunConfig(rounds=1, batch_size=4, seq_len=16))


def test_lm_entry_points_default_to_cuda(monkeypatch):
    """The decoder LMs and the ServingEngine run on the card unless the
    caller asks for the CPU; without a card they raise."""
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("gemma-2b", "rwkv6-3b"):
        cfg = reduced(REGISTRY[arch], n_layers=1, d_model=64)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(cfg, {}, {})
        assert build_model(cfg, device="cpu").device.type == "cpu"
