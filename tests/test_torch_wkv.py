"""The WKV6 kernel's wrapper and its place in the RWKV6 block.

On the CPU the wrapper runs the plain version (the step-by-step
recurrence); these tests hold it, output and final state, against the JAX
package's ``ops.wkv6_apply`` (Pallas in interpret mode) and
``ref.wkv6_ref`` on the same seeded numpy inputs, over the reference's own
sweep (ragged T included, fp32 and bf16), and hold the block's
``wkv_apply`` under ``wkv_impl="chunked"`` against the reference's
``wkv_chunked`` and ``wkv_scan``.  The CUDA kernel is held against the
plain version on the card (tests at the end, and ``chip_smoke.py``); here
those tests skip.

Tolerances: fp32 atol 1e-5 (the same f32 recurrence with sums in another
order; the reference's log-space chunked form against it); bf16 outputs
atol 1e-2 (one bf16 rounding of an O(1) value), bf16 final states 1e-5
(the state stays f32 from the same bf16 inputs).
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.kernels.ops import wkv6_apply  # noqa: E402
from repro_torch.kernels.ref import wkv6_ref  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402

set_fp32_policy()

ATOL_F32, ATOL_BF16 = 1e-5, 1e-2


def _inputs(b, s, h, d, seed=0, lo=0.6, hi=0.995):
    rs = np.random.default_rng(seed)
    r, k, v = ((rs.standard_normal((b, s, h, d)) * 0.3).astype(np.float32)
               for _ in range(3))
    w = rs.uniform(lo, hi, size=(b, s, h, d)).astype(np.float32)
    u = (rs.standard_normal((h, d)) * 0.3).astype(np.float32)
    return r, k, v, w, u


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jops, jref


@pytest.mark.parametrize("b,s,h,d", [(1, 16, 1, 16), (2, 37, 3, 16), (2, 64, 2, 32),
                                     (1, 128, 4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_sweep_matches_reference(b, s, h, d, dtype):
    jnp, jops, jref = _jax()
    r, k, v, w, u = _inputs(b, s, h, d)
    jdt = getattr(jnp, dtype)
    jr, jk, jv, jw = (jnp.asarray(x, jdt) for x in (r, k, v, w))
    out_j, sf_j = jops.wkv6_apply(jr, jk, jv, jw, jnp.asarray(u), chunk=16)
    tdt = getattr(torch, dtype)
    tr, tk, tv, tw = (torch.from_numpy(x).to(tdt) for x in (r, k, v, w))
    out, sf = wkv6_apply(tr, tk, tv, tw, torch.from_numpy(u))
    assert out.dtype == tdt and sf.dtype == torch.float32
    assert tuple(sf.shape) == (b, h, d, d)
    atol = ATOL_F32 if dtype == "float32" else ATOL_BF16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(out_j, np.float32), atol=atol)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_j), atol=ATOL_F32)
    # the reference's oracle
    out_r, sf_r = jref.wkv6_ref(jr, jk, jv, jw, jnp.asarray(u), jnp.zeros((b, h, d, d)))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(out_r), atol=atol)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_r), atol=ATOL_F32)


def test_wkv6_state_continuity():
    """The kernel's final state == the plain recurrence run in two halves,
    the second from the first's state (decode continues a prefill so)."""
    b, s, h, d = 1, 64, 2, 16
    r, k, v, w, u = (torch.from_numpy(x) for x in _inputs(b, s, h, d, seed=1,
                                                          lo=0.7, hi=0.99))
    _, sf = wkv6_apply(r, k, v, w, u)
    half = s // 2
    _, s1 = wkv6_ref(r[:, :half], k[:, :half], v[:, :half], w[:, :half], u,
                     torch.zeros(b, h, d, d))
    _, s2 = wkv6_ref(r[:, half:], k[:, half:], v[:, half:], w[:, half:], u, s1)
    np.testing.assert_allclose(sf.numpy(), s2.numpy(), atol=ATOL_F32)


@pytest.mark.parametrize("s", [32, 45])
def test_wkv_apply_chunked_matches_reference_chunked_and_scan(s):
    jnp, _, _ = _jax()
    from repro.models import blocks as JB
    b, h, d = 2, 2, 16
    r, k, v, w, u = _inputs(b, s, h, d, seed=2, lo=0.7, hi=0.99)
    cfg = reduced(REGISTRY["rwkv6-3b"]).with_(wkv_impl="chunked")
    out, sf = B.wkv_apply(cfg, *(torch.from_numpy(x) for x in (r, k, v, w, u)))
    jargs = [jnp.asarray(x) for x in (r, k, v, w, u)] + [jnp.zeros((b, h, d, d))]
    for fn in (lambda *a: JB.wkv_chunked(*a, chunk=16), JB.wkv_scan):
        out_j, sf_j = fn(*jargs)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL_F32)
        np.testing.assert_allclose(sf.numpy(), np.asarray(sf_j), atol=ATOL_F32)
    scan_out, scan_sf = B.wkv_apply(cfg.with_(wkv_impl="scan"),
                                    *(torch.from_numpy(x) for x in (r, k, v, w, u)))
    np.testing.assert_allclose(out.numpy(), scan_out.numpy(), atol=ATOL_F32)
    np.testing.assert_allclose(sf.numpy(), scan_sf.numpy(), atol=ATOL_F32)


def test_wkv6_wrapper_refuses_bad_inputs():
    r, k, v, w, u = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 16))
    with pytest.raises(ValueError):
        wkv6(r, k, v, w[:, :3], u)
    with pytest.raises(ValueError):
        wkv6(r, k, v, w, u[:1])
    with pytest.raises(TypeError):
        wkv6(r, k, v, w.double(), u)
    with pytest.raises(TypeError):
        wkv6(r.bfloat16(), k, v, w, u)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,w_dtype,tol", [
    (torch.float32, torch.float32, 1e-5), (torch.bfloat16, torch.float32, 1e-2),
    (torch.bfloat16, torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(2, 37, 3, 16), (1, 100, 4, 32), (2, 300, 5, 64),
                                   (1, 50, 2, 128)])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, w_dtype, tol, shape):
    """On the card: the kernel launches (the counter moves), reads the
    model's dtypes and a ragged T in place, and agrees with the plain
    version in output and final state."""
    r, k, v, w, u = (torch.from_numpy(x).to(cuda_device) for x in _inputs(*shape))
    r, k, v, w = r.to(dtype), k.to(dtype), v.to(dtype), w.to(w_dtype)
    before = wkv6.launches
    out, sf = wkv6(r, k, v, w, u)
    assert wkv6.launches == before + 1
    out_p, sf_p = wkv6(r.cpu(), k.cpu(), v.cpu(), w.cpu(), u.cpu())

    def err(got, want):   # normalized, as chip_smoke.py states it
        return float((got.float().cpu() - want.float()).abs().max()
                     / max(1.0, want.float().abs().max()))

    assert err(out, out_p) <= tol
    assert err(sf, sf_p) <= 1e-5


def _fast_decay_inputs(b, s, h, d, seed):
    """Decays exp(-exp(z)), z ~ N(0, 1): many near 0 (a state all but
    forgotten each step), beside the slow ones of ``_inputs``."""
    r, k, v, _, u = _inputs(b, s, h, d, seed=seed)
    z = np.random.default_rng(seed + 100).standard_normal((b, s, h, d))
    return r, k, v, np.exp(-np.exp(z)).astype(np.float32), u


def _cuda_err(got, want):   # normalized, as chip_smoke.py states it
    return float((got.float().cpu() - want.float()).abs().max()
                 / max(1.0, want.float().abs().max()))


@pytest.mark.parametrize("dtype,w_dtype,tol", [
    (torch.float32, torch.float32, 1e-5), (torch.bfloat16, torch.float32, 1e-2),
    (torch.bfloat16, torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("t", [1000, 37])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("decay", ["slow", "fast"])
def test_cuda_kernel_ragged_t_each_head_dim(cuda_device, d, t, dtype, w_dtype, tol, decay):
    """On the card, at T off the kernel's 16- and 8-step chunks and at
    every head dimension, with slow decays and with fast ones: the lane
    split keeps out and the final state within the plain version's
    tolerances."""
    make = _inputs if decay == "slow" else _fast_decay_inputs
    r, k, v, w, u = (torch.from_numpy(x).to(cuda_device) for x in make(2, t, 3, d, seed=d))
    r, k, v, w = r.to(dtype), k.to(dtype), v.to(dtype), w.to(w_dtype)
    out, sf = wkv6(r, k, v, w, u)
    out_p, sf_p = wkv6(r.cpu(), k.cpu(), v.cpu(), w.cpu(), u.cpu())
    assert _cuda_err(out, out_p) <= tol
    assert _cuda_err(sf, sf_p) <= 1e-5


def test_cuda_kernel_reads_unaligned_strided_views(cuda_device):
    """r and v as views one element into a wider tensor (bases and strides
    off 16 bytes) take the element-copy staging and still agree."""
    rs = np.random.default_rng(9)
    big = torch.from_numpy((rs.standard_normal((2, 50, 3, 65)) * 0.3)
                           .astype(np.float32)).to(cuda_device)
    r, v = big[..., 1:], big[..., :64] * 0.5
    _, k, _, w, u = (torch.from_numpy(x).to(cuda_device)
                     for x in _fast_decay_inputs(2, 50, 3, 64, seed=4))
    assert r.data_ptr() % 16 != 0 and r.stride(2) == 65
    out, sf = wkv6(r, k, v, w, u)
    out_p, sf_p = wkv6(r.cpu(), k.cpu(), v.cpu(), w.cpu(), u.cpu())
    assert _cuda_err(out, out_p) <= 1e-5
    assert _cuda_err(sf, sf_p) <= 1e-5


def test_cuda_wrapper_is_forward_only(cuda_device):
    r, k, v, w, u = (torch.from_numpy(x).to(cuda_device) for x in _inputs(1, 8, 2, 16))
    with pytest.raises(NotImplementedError, match="no VJP"):
        wkv6_apply(r.requires_grad_(True), k, v, w, u)
