"""Eq. 5-9 aggregation and the head FedAvg in the port against the JAX
package, on seeded full-shape adapter trees at heterogeneous cuts.

Both sides sum the same f32 products in the same order (first client's
weighted leaf, then the others in client order), so the results are
bit-equal and the tests compare them exactly.
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator (there it would lower the Pallas kernels
# for that device and take fp32 products at reduced precision)
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro_torch.bridge import to_torch
from repro_torch.core import aggregation as t_agg
from repro_torch.tree import tree_map

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as j_agg  # noqa: E402
from repro.core import lora as j_lora  # noqa: E402

CUTS = (1, 1, 2, 2, 3, 3)
SIZES = (855, 134, 310, 1381, 1077, 243)


def _loras(seed):
    rs = np.random.default_rng(seed)
    one = lambda: {"layers": {"attn": {  # noqa: E731
        w: {"a": rs.standard_normal((4, 4, 32)).astype(np.float32),
            "b": rs.standard_normal((4, 32, 4)).astype(np.float32)}
        for w in ("wq", "wk", "wv", "wo")}}}
    return [one() for _ in CUTS]


def _close_trees(got, want):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close_trees(got[k], want[k])
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_aggregation_round_matches_reference():
    fulls = _loras(0)
    splits = [j_lora.split_lora(jax.tree.map(jnp.asarray, f), c) for f, c in zip(fulls, CUTS)]
    jc, js, jfull = j_agg.aggregation_round([s[0] for s in splits], [s[1] for s in splits],
                                            CUTS, SIZES)
    tsplits = [t_agg.lora_lib.split_lora(to_torch(f, "cpu"), c) for f, c in zip(fulls, CUTS)]
    tc, ts, tfull = t_agg.aggregation_round([s[0] for s in tsplits], [s[1] for s in tsplits],
                                            CUTS, SIZES)
    _close_trees(tfull, jfull)
    for u in range(len(CUTS)):
        _close_trees(tc[u], jc[u])
        _close_trees(ts[u], js[u])
        assert tree_map(lambda a: a.shape[0], tc[u])["layers"]["attn"]["wq"]["a"] == CUTS[u]


@pytest.mark.parametrize("weights", [SIZES, (1.0, 0.0, 2.0, 0.5, 3.0, 1.0)])
def test_weighted_aggregate_matches_reference(weights):
    fulls = _loras(1)
    jw = j_agg.aggregate_full_weighted([jax.tree.map(jnp.asarray, f) for f in fulls], weights)
    tw = t_agg.aggregate_full_weighted([to_torch(f, "cpu") for f in fulls], weights)
    _close_trees(tw, jw)
    assert t_agg.normalize_weights(weights) == j_agg.normalize_weights(weights)


def test_head_fedavg_matches_reference():
    """sum(float(w_u) * h_u) from Python 0 in client order, as in the
    reference Simulator's commit and evaluation."""
    rs = np.random.default_rng(2)
    heads = [rs.standard_normal((32, 6)).astype(np.float32) for _ in CUTS]
    w = np.array(SIZES, np.float64)
    w /= w.sum()
    jh = sum(float(wi) * h for wi, h in zip(w, [jnp.asarray(h) for h in heads]))
    th = sum(float(wi) * h for wi, h in zip(w, [torch.from_numpy(h) for h in heads]))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("bad", [(1.0, -1.0), (0.0, 0.0)])
def test_normalize_weights_rejects_like_reference(bad):
    for mod in (j_agg, t_agg):
        with pytest.raises(ValueError):
            mod.normalize_weights(bad)
