"""The port's encoder model against the JAX package's, from bridged weights:
the hidden state on both sides of every cut, logits and loss, with the
reference on its einsum path and on its Pallas path (interpret mode), and
the port on its einsum and fused paths.

Tolerance: rtol 1e-4 / atol 1e-5 — values before any optimizer step, fp32
products summed in another order by XLA and by PyTorch's CPU BLAS.
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator (there it would lower the Pallas kernels
# for that device and take fp32 products at reduced precision)
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402

set_fp32_policy()

RTOL, ATOL = 1e-4, 1e-5
N_LAYERS = 2


def _cfgs(impl):
    jc = j_reduced(J_REGISTRY["bert-base"], n_layers=N_LAYERS, d_model=128)
    tc = reduced(REGISTRY["bert-base"], n_layers=N_LAYERS, d_model=128)
    return (jc.with_(lora=dataclasses.replace(jc.lora, impl=impl)),
            tc.with_(lora=dataclasses.replace(tc.lora, impl=impl)))


@pytest.fixture(scope="module")
def state():
    jc, _ = _cfgs("einsum")
    jm = j_build(jc)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    lora = jax.tree.map(np.asarray, jm.init_lora(jax.random.PRNGKey(1)))
    rs = np.random.default_rng(0)
    # non-zero B so the adapters change the output
    lora = jax.tree.map(lambda x: (rs.standard_normal(x.shape) * 0.05).astype(x.dtype), lora)
    batch = {"tokens": rs.integers(0, jc.vocab_size, (3, 16)).astype(np.int32),
             "label": rs.integers(0, jc.n_classes, (3,)).astype(np.int32)}
    return params, lora, batch


def _pair(impl, state):
    params, lora, batch = state
    jc, tc = _cfgs(impl)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    jargs = (jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, lora),
             {k: jnp.asarray(v) for k, v in batch.items()})
    targs = (to_torch(params, "cpu"), to_torch(lora, "cpu"), to_torch(batch, "cpu"))
    return jm, tm, jargs, targs


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("j_impl,t_impl", [("einsum", "einsum"), ("fused", "fused"),
                                           ("einsum", "fused")])
def test_loss_and_logits_match(state, j_impl, t_impl):
    jm, _, jargs, _ = _pair(j_impl, state)
    _, tm, _, targs = _pair(t_impl, state)
    jl, jlog = jm.loss(*jargs, path="sliced")
    with torch.no_grad():
        tl, tlog = tm.loss(*targs)
    _close(tlog, jlog)
    _close(tl, jl)


@pytest.mark.parametrize("impl", ["einsum", "fused"])
@pytest.mark.parametrize("cut", list(range(N_LAYERS + 1)))
def test_forward_hidden_every_cut(state, impl, cut):
    jm, tm, jargs, targs = _pair(impl, state)
    jh, _ = jm.forward_hidden(*jargs, cut=cut, side="client", path="sliced")
    with torch.no_grad():
        th, _ = tm.forward_hidden(*targs, cut=cut, side="client")
        _close(th, jh)
        js, _ = jm.forward_hidden(*jargs, cut=cut, side="server", path="sliced", x0=jh)
        ts, _ = tm.forward_hidden(*targs, cut=cut, side="server",
                                  x0=torch.from_numpy(np.array(jh)))
    _close(ts, js)


def test_port_init_shapes_follow_reference():
    jc, tc = _cfgs("einsum")
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    gen = torch.Generator()
    for j_tree, t_tree in ((jm.init_params(jax.random.PRNGKey(0)), tm.init_params(gen)),
                           (jm.init_lora(jax.random.PRNGKey(1)), tm.init_lora(gen))):
        j_flat = {jax.tree_util.keystr(p): (v.shape, str(v.dtype))
                  for p, v in jax.tree_util.tree_flatten_with_path(j_tree)[0]}
        t_flat = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                  for p, v in jax.tree_util.tree_flatten_with_path(t_tree)[0]}
        assert j_flat == t_flat
