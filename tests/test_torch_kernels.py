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


@pytest.mark.parametrize("case", ["rank", "dtype", "layout", "shape", "device",
                                  "layout_x_transposed", "layout_x_sliced",
                                  "layout_a_sliced", "layout_b_sliced"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, w, a, b, _ = (torch.from_numpy(v) for v in _inputs(8, 16, 8, 4))
    if case == "rank":
        r = lm_mod.MAX_RANK + 1
        a, b = torch.zeros(r, 16), torch.zeros(8, r)
        err = ValueError
    elif case == "dtype":
        x, err = x.double(), TypeError
    elif case == "layout":
        # every other column of a wider W: neither contiguous nor the .t()
        # view of a contiguous tensor (those two are the layouts the kernel reads)
        w, err = torch.zeros(16, 16)[:, ::2], ValueError
    elif case == "shape":
        b, err = torch.zeros(9, 4), ValueError
    elif case.startswith("layout_"):
        # x must be contiguous; a and b may be .t() views, but not strided slices
        x, a, b = {"layout_x_transposed": (x.t().contiguous().t(), a, b),
                   "layout_x_sliced": (torch.zeros(8, 32)[:, ::2], a, b),
                   "layout_a_sliced": (x, torch.zeros(4, 32)[:, ::2], b),
                   "layout_b_sliced": (x, a, torch.zeros(8, 8)[:, ::2])}[case]
        err = ValueError
    else:
        # meta is a device the wrapper takes (the plain version, for a
        # trace); inputs split over two devices are not
        x, err = x.to("meta"), ValueError
    with pytest.raises(err):
        lora_matmul(x, w, a, b, scale=1.0)


def _views(x, w, a, b, which):
    """The same values with the named operands as .t() views of contiguous
    tensors, the layouts the backward passes for dx."""
    def view(t):
        return t.t().contiguous().t()
    return (x, view(w) if "w" in which else w, view(a) if "a" in which else a,
            view(b) if "b" in which else b)


@pytest.mark.parametrize("which", ["w", "a", "b", "wab"])
def test_wrapper_accepts_the_transposed_views_the_backward_passes(which):
    """A layout-acceptance test: ``_check`` lets the backward's .t() views
    through.  On the CPU the wrapper runs the plain version (no launch), so
    the exact comparison holds the plain version on views against itself on
    contiguous copies; the kernel's reading of the strides is held on the
    card (test_cuda_kernel_ragged_tiles_ranks_and_backward_layouts)."""
    x, w, a, b, _ = (torch.from_numpy(v) for v in _inputs(12, 20, 9, 3))
    xv, wv, av, bv = _views(x, w, a, b, which)
    assert not all(t.is_contiguous() for t in (wv, av, bv))
    before = lora_matmul.launches
    torch.testing.assert_close(lora_matmul(xv, wv, av, bv, scale=1.5),
                               lora_matmul_ref(x, w, a, b, 1.5), rtol=0, atol=0)
    assert lora_matmul.launches == before


def test_backward_hands_the_kernel_views_not_copies(monkeypatch):
    """dx = g @ W^T + s*(g @ B) @ A goes through the kernel on (g, W^T, B^T,
    A^T) as views of the saved W, B and A: no transposed copy is made."""
    from repro_torch.kernels import ops
    calls = []

    def recording(*args, **kwargs):
        calls.append(args)
        return lora_matmul(*args, **kwargs)

    monkeypatch.setattr(ops, "lora_matmul", recording)
    x, w, a, b, g = (torch.from_numpy(v) for v in _inputs(10, 24, 16, 4))
    xs = x.clone().requires_grad_(True)
    y = ops.fused_lora_matmul(xs, w, a, b, scale=2.0)
    (dx,) = torch.autograd.grad(y, (xs,), g)
    assert len(calls) == 2
    _, w_t, b_t, a_t = calls[1]
    for view, src in ((w_t, w), (b_t, b), (a_t, a)):
        assert view.data_ptr() == src.data_ptr()
        assert view.untyped_storage().data_ptr() == src.untyped_storage().data_ptr()
        assert view.shape == src.t().shape and view.stride() == src.t().stride()
    xr = x.clone().requires_grad_(True)
    (dx_ref,) = torch.autograd.grad(lora_matmul_ref(xr, w, a, b, 2.0), (xr,), g)
    torch.testing.assert_close(dx, dx_ref, rtol=1e-5, atol=1e-5)


def test_build_stamp_follows_the_shared_header(tmp_path):
    """lora_matmul.cu and grouped_lora.cu share their tensor-core tile
    through csrc/tf32_lora_tile.cuh: each library's stamp hashes the
    header, so a change to it rebuilds both, and no other library."""
    import shutil
    from repro_torch.kernels import build
    for src in build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    names = ("lora_matmul", "grouped_lora", "quant", "wkv6", "flash_attention")
    for name in ("lora_matmul", "grouped_lora"):
        assert "tf32_lora_tile.cuh" in {p.name for p in build._sources(tmp_path / f"{name}.cu")}
    before = {n: build._digest(tmp_path / f"{n}.cu") for n in names}
    header = tmp_path / "tf32_lora_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build._digest(tmp_path / f"{n}.cu") for n in names}
    assert {n for n in names if after[n] != before[n]} == {"lora_matmul", "grouped_lora"}


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


def _norm_err(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("shape", [(37, 100, 130), (2047, 768, 770)])
@pytest.mark.parametrize("r", [5, 16, 64])
def test_cuda_kernel_ragged_tiles_ranks_and_backward_layouts(cuda_device, shape, r):
    """On the card, at M, N and K that are not multiples of the 128 x 96 x 32
    tiles (N 130 and 770 and the dx call's K 770 take the 4-byte copies):
    the kernel on contiguous operands and on the backward's transposed views
    agrees with the plain version (normalized error <= 1e-4, as
    chip_smoke.py's KERNEL_RTOL), and so do dx, dA and dB."""
    x, w, a, b, g = (torch.from_numpy(v).to(cuda_device) for v in _inputs(*shape, r, seed=r))
    want = lora_matmul_ref(x, w, a, b, 2.0)
    for which in ("", "wab"):
        got = lora_matmul(*_views(x, w, a, b, which), scale=2.0)
        assert _norm_err(got, want) <= 1e-4, which
    # the dx call's own layout: (g, W^T, B^T, A^T) as views
    got = lora_matmul(g, w.t(), b.t(), a.t(), scale=2.0)
    assert _norm_err(got, lora_matmul_ref(g, w.t(), b.t(), a.t(), 2.0)) <= 1e-4
    grads = []
    for fn in (fused_lora_matmul, None):
        xs, as_, bs = (v.clone().requires_grad_(True) for v in (x, a, b))
        y = (fn(xs, w, as_, bs, scale=2.0) if fn is not None
             else lora_matmul_ref(xs, w, as_, bs, 2.0))
        grads.append(torch.autograd.grad(y, (xs, as_, bs), g))
    for got, want in zip(*grads):
        assert _norm_err(got, want) <= 1e-4


def test_cuda_kernel_launches_on_every_card():
    """The kernel's shared-memory opt-in acts on one device's context:
    after launches on the first card, each other card launches too (the
    forward's N-contiguous W and the dx call's K-contiguous view) and
    agrees with the plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    x, w, a, b, g = (torch.from_numpy(v) for v in _inputs(300, 256, 200, 16))
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        xd, wd, ad, bd, gd = (v.to(dev) for v in (x, w, a, b, g))
        before = lora_matmul.launches
        y = lora_matmul(xd, wd, ad, bd, scale=2.0)
        dx = lora_matmul(gd, wd.t(), bd.t(), ad.t(), scale=2.0)
        assert lora_matmul.launches == before + 2 and y.device == dev
        assert _norm_err(y, lora_matmul_ref(xd, wd, ad, bd, 2.0)) <= 1e-4, i
        assert _norm_err(dx, lora_matmul_ref(gd, wd.t(), bd.t(), ad.t(), 2.0)) <= 1e-4, i
