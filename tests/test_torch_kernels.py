"""The fused base+LoRA kernel's wrapper and autograd op.

On the CPU the wrapper runs the plain version; these tests hold it, forward
and backward, against the JAX package's ``ops.fused_lora_matmul`` (Pallas in
interpret mode) on the same seeded numpy inputs.  The CUDA kernel itself is
held against the plain version on the card (test at the end, and
``chip_smoke.py``); here that test skips.

Tolerance: rtol 1e-4 / atol 1e-5 — fp32 products summed in another order
by XLA and by PyTorch's CPU BLAS differ by a few ulps of the partial sums.
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

from repro_torch.kernels import lora_matmul as lm_mod
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.kernels.ops import fused_lora_matmul
from repro_torch.kernels.ref import lora_matmul_ref
from repro_torch.numerics import set_fp32_policy

set_fp32_policy()

RTOL, ATOL = 1e-4, 1e-5
SHAPES = [(128, 128, 128), (256, 128, 384), (37, 100, 130), (5, 64, 17)]
RANKS = [4, 16]


def _inputs(m, k, n, r, seed=0):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((m, k)).astype(np.float32)
    w = (rs.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    a = (rs.standard_normal((r, k)) / np.sqrt(r)).astype(np.float32)
    b = (rs.standard_normal((n, r)) * 0.1).astype(np.float32)
    g = rs.standard_normal((m, n)).astype(np.float32)
    return x, w, a, b, g


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("r", RANKS)
def test_fused_matches_jax_pallas_forward_and_vjp(shape, r):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    x, w, a, b, g = _inputs(*shape, r, seed=r)
    scale = 2.0

    def jf(x_, a_, b_):
        return jops.fused_lora_matmul(x_, jnp.asarray(w), a_, b_, scale=scale)

    jy, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    jdx, jda, jdb = vjp(jnp.asarray(g))

    tx, ta, tb = (torch.from_numpy(v.copy()).requires_grad_(True) for v in (x, a, b))
    ty = fused_lora_matmul(tx, torch.from_numpy(w), ta, tb, scale=scale)
    tdx, tda, tdb = torch.autograd.grad(ty, (tx, ta, tb), torch.from_numpy(g))

    for got, want in ((ty, jy), (tdx, jdx), (tda, jda), (tdb, jdb)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())))


def test_leading_dims_flatten_and_frozen_weight_gets_no_grad():
    x, w, a, b, g = _inputs(24, 32, 48, 4)
    tx = torch.from_numpy(x).reshape(2, 12, 32).requires_grad_(True)
    tw = torch.from_numpy(w)
    y = fused_lora_matmul(tx, tw, torch.from_numpy(a), torch.from_numpy(b), scale=0.5)
    assert y.shape == (2, 12, 48)
    ref = lora_matmul_ref(torch.from_numpy(x), tw, torch.from_numpy(a),
                          torch.from_numpy(b), 0.5)
    torch.testing.assert_close(y.reshape(24, 48), ref, rtol=0, atol=0)
    (dx,) = torch.autograd.grad(y, (tx,), torch.from_numpy(g).reshape(2, 12, 48))
    assert dx.shape == tx.shape and tw.grad is None


def test_cpu_tensors_take_the_plain_version_without_counting():
    x, w, a, b, _ = _inputs(16, 32, 8, 4)
    before = lora_matmul.launches
    y = lora_matmul(*(torch.from_numpy(v) for v in (x, w, a, b)), scale=2.0)
    assert lora_matmul.launches == before
    assert torch.equal(y, lora_matmul_ref(*(torch.from_numpy(v) for v in (x, w, a, b)), 2.0))


@pytest.mark.parametrize("case", ["rank", "dtype", "layout", "shape", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, w, a, b, _ = (torch.from_numpy(v) for v in _inputs(8, 16, 8, 4))
    if case == "rank":
        r = lm_mod.MAX_RANK + 1
        a, b = torch.zeros(r, 16), torch.zeros(8, r)
        err = ValueError
    elif case == "dtype":
        x, err = x.double(), TypeError
    elif case == "layout":
        w, err = w.t().contiguous().t(), ValueError
    elif case == "shape":
        b, err = torch.zeros(9, 4), ValueError
    else:
        x, w, a, b = (v.to("meta") for v in (x, w, a, b))
        err = ValueError
    with pytest.raises(err):
        lora_matmul(x, w, a, b, scale=1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2048, 768, 768), (37, 100, 130)])
def test_cuda_kernel_matches_plain_version(cuda_device, shape):
    """On the card: the kernel launches (the counter moves) and agrees with
    the plain version forward and for dx."""
    x, w, a, b, g = (torch.from_numpy(v).to(cuda_device) for v in _inputs(*shape, 16))
    before = lora_matmul.launches
    y = lora_matmul(x, w, a, b, scale=2.0)
    assert lora_matmul.launches == before + 1
    torch.testing.assert_close(y, lora_matmul_ref(x, w, a, b, 2.0),
                               rtol=1e-4, atol=1e-4)
    xs = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(fused_lora_matmul(xs, w, a, b, scale=2.0), (xs,), g)
    xr = x.clone().requires_grad_(True)
    (dx_ref,) = torch.autograd.grad(lora_matmul_ref(xr, w, a, b, 2.0), (xr,), g)
    torch.testing.assert_close(dx, dx_ref, rtol=1e-4, atol=1e-4)
