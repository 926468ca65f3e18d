"""The grouped ragged-cohort LoRA kernel's wrapper and autograd op.

On the CPU the wrapper runs the plain version; these tests hold it,
forward and backward, against the JAX package's ``ops.grouped_lora_matmul``
(Pallas in interpret mode) on the same seeded numpy inputs, at the ragged
shapes of the reference's own grouped-kernel tests.  The CUDA kernel itself
is held against the plain version on the card (tests at the end, and
``chip_smoke.py``); here those tests skip.

Tolerance: atol 2e-4 of the output's scale, the reference's own grouped
parity tolerance — fp32 products summed in another order.
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

from repro_torch.kernels import grouped_lora as gl_mod
from repro_torch.kernels.grouped_lora import (grouped_lora, grouped_lora_chunk,
                                              grouped_lora_direct, tile_table)
from repro_torch.kernels.ops import fused_lora_matmul, grouped_lora_matmul
from repro_torch.kernels.ref import grouped_lora_matmul_ref, lora_matmul_ref
from repro_torch.numerics import set_fp32_policy

set_fp32_policy()

ATOL = 2e-4
# (group sizes, K, N, r): the ragged cohorts of tests/test_grouped_lora.py
SHAPES = [((40, 100, 17), 200, 150, 6), ((128, 128), 128, 128, 16),
          ((300, 5, 64, 129), 384, 96, 4)]


def _cohort(sizes, k, n, r, seed=7):
    rs = np.random.default_rng(seed)
    g = len(sizes)
    x = (rs.standard_normal((sum(sizes), k)) * 0.5).astype(np.float32)
    w = (rs.standard_normal((k, n)) * 0.1).astype(np.float32)
    a = (rs.standard_normal((g, r, k)) * 0.1).astype(np.float32)
    b = (rs.standard_normal((g, n, r)) * 0.1).astype(np.float32)
    gy = rs.standard_normal((sum(sizes), n)).astype(np.float32)
    scales = tuple(0.5 + 0.5 * i for i in range(g))
    return x, w, a, b, gy, scales


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("mode", ["chunk", "direct", "auto"])
@pytest.mark.parametrize("shape", SHAPES, ids=["40-100-17", "128-128", "300-5-64-129"])
def test_grouped_matches_jax_pallas_forward_and_vjp(shape, mode):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    sizes, k, n, r = shape
    x, w, a, b, gy, scales = _cohort(sizes, k, n, r)

    def jf(x_, a_, b_):
        return jops.grouped_lora_matmul(x_, jnp.asarray(w), a_, b_, group_sizes=sizes,
                                        scales=scales, mode=mode, interpret=True)

    jy, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    jdx, jda, jdb = vjp(jnp.asarray(gy))

    tx, ta, tb = (torch.from_numpy(v.copy()).requires_grad_(True) for v in (x, a, b))
    ty = grouped_lora_matmul(tx, torch.from_numpy(w), ta, tb, group_sizes=sizes,
                             scales=scales, mode=mode)
    tdx, tda, tdb = torch.autograd.grad(ty, (tx, ta, tb), torch.from_numpy(gy))
    for got, want in ((ty, jy), (tdx, jdx), (tda, jda), (tdb, jdb)):
        _close(got, want)


def test_single_group_equals_fused_lora_matmul():
    x, w, a, b, _, _ = _cohort((75,), 200, 130, 8)
    tx, tw, ta, tb = (torch.from_numpy(v) for v in (x, w, a, b))
    y = grouped_lora_matmul(tx, tw, ta, tb, group_sizes=(75,), scale=1.7)
    yf = fused_lora_matmul(tx, tw, ta[0], tb[0], scale=1.7)
    torch.testing.assert_close(y, yf, rtol=0, atol=0)


def test_weight_gradient_only_when_asked():
    x, w, a, b, gy, scales = _cohort((9, 23), 32, 16, 4)
    tx, tw, ta, tb = (torch.from_numpy(v).requires_grad_(True) for v in (x, w, a, b))
    y = grouped_lora_matmul(tx, tw, ta, tb, group_sizes=(9, 23), scales=scales)
    (dw,) = torch.autograd.grad(y, (tw,), torch.from_numpy(gy))
    torch.testing.assert_close(dw, tx.detach().t() @ torch.from_numpy(gy))
    y2 = grouped_lora_matmul(tx, tw.detach(), ta, tb, group_sizes=(9, 23), scales=scales)
    y2.backward(torch.from_numpy(gy))
    assert tw.grad is None and tx.grad is not None


@pytest.mark.parametrize("sizes", [(1,), (64,), (65, 1), (40, 100, 17), (128, 3, 64)])
def test_tile_table_covers_every_row_once_within_its_group(sizes):
    tiles = tile_table(sizes)
    owner = np.full(sum(sizes), -1)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    for g, row0, rows in tiles:
        assert 1 <= rows <= gl_mod.BM
        assert offs[g] <= row0 and row0 + rows <= offs[g + 1]   # no straddling
        assert (owner[row0:row0 + rows] == -1).all()
        owner[row0:row0 + rows] = g
    assert (owner >= 0).all()
    assert len(tiles) == sum(-(-s // gl_mod.BM) for s in sizes)


@pytest.mark.parametrize("mode,bm", [("chunk", 128), ("direct", 64)])
def test_tile_table_at_the_kernel_tile_height_with_a_ragged_last_tile(mode, bm):
    """Chunk mode tiles each group in 128-row tiles (the tensor-core tile),
    direct mode in 64-row tiles (the SIMT tile); each group's last tile
    holds what is left of it."""
    assert gl_mod._tile_rows(mode) == bm
    sizes = (300, 129, 128)
    tiles = tile_table(sizes, gl_mod._tile_rows(mode))
    if mode == "chunk":
        assert gl_mod.BM == 128
        assert tiles == [(0, 0, 128), (0, 128, 128), (0, 256, 44), (1, 300, 128),
                         (1, 428, 1), (2, 429, 128)]
    else:
        assert [t for t in tiles if t[0] == 0] == [(0, 0, 64), (0, 64, 64), (0, 128, 64),
                                                   (0, 192, 64), (0, 256, 44)]
        assert [t[2] for t in tiles if t[0] == 1] == [64, 64, 1]
    assert tile_table(sizes) == tile_table(sizes, gl_mod.BM)


def _grouped_views(w, a, b, which):
    """The same values with the named operands in the layouts the
    backward passes: w as the .t() view of a contiguous (N, K) tensor, a
    and b as .transpose(1, 2) views of contiguous stacks."""
    def view(t):
        return t.transpose(-2, -1).contiguous().transpose(-2, -1)
    return (view(w) if "w" in which else w, view(a) if "a" in which else a,
            view(b) if "b" in which else b)


@pytest.mark.parametrize("mode", gl_mod.MODES)
@pytest.mark.parametrize("which", ["w", "a", "b", "wab"])
def test_wrapper_accepts_the_transposed_views_the_backward_passes(which, mode):
    """A layout-acceptance test: ``_check`` lets the backward's transposed
    views through.  On the CPU the wrapper runs the plain version (no
    launch: both counters stay), so the exact comparison holds the plain
    version on views against itself on contiguous copies; the kernel's
    reading of the strides is held on the card
    (test_cuda_kernel_backward_layouts_ragged_shapes_and_ranks)."""
    x, w, a, b, _, scales = (torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                             for v in _cohort((7, 30), 24, 12, 4))
    wv, av, bv = _grouped_views(w, a, b, which)
    assert not all(t.is_contiguous() for t in (wv, av, bv))
    before = (grouped_lora_chunk.launches, grouped_lora_direct.launches)
    y = grouped_lora(x, wv, av, bv, group_sizes=(7, 30), scales=scales, mode=mode)
    torch.testing.assert_close(y, grouped_lora_matmul_ref(x, w, a, b, (7, 30), scales),
                               rtol=0, atol=0)
    assert (grouped_lora_chunk.launches, grouped_lora_direct.launches) == before


@pytest.mark.parametrize("mode", ["chunk", "direct"])
def test_grouped_backward_hands_the_kernel_views_not_copies(monkeypatch, mode):
    """dx = g @ W^T + s_i*(g @ B_i) @ A_i goes through the kernel on
    (g, W^T, B^T, A^T) as views of the saved W, B and A: no transposed
    copy is made.  The counterpart of
    tests/test_torch_kernels.py::test_backward_hands_the_kernel_views_not_copies."""
    from repro_torch.kernels import ops
    calls = []

    def recording(*args, **kwargs):
        calls.append(args)
        return grouped_lora(*args, **kwargs)

    monkeypatch.setattr(ops, "grouped_lora", recording)
    sizes = (9, 23)
    x, w, a, b, gy, scales = (torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                              for v in _cohort(sizes, 32, 16, 4))
    xs = x.clone().requires_grad_(True)
    y = ops.grouped_lora_matmul(xs, w, a, b, group_sizes=sizes, scales=scales, mode=mode)
    (dx,) = torch.autograd.grad(y, (xs,), gy)
    assert len(calls) == 2
    _, w_t, b_t, a_t = calls[1]
    for view, want in ((w_t, w.t()), (b_t, b.transpose(1, 2)), (a_t, a.transpose(1, 2))):
        assert view.data_ptr() == want.data_ptr()
        assert view.untyped_storage().data_ptr() == want.untyped_storage().data_ptr()
        assert view.shape == want.shape and view.stride() == want.stride()
        assert not view.is_contiguous()
    xr = x.clone().requires_grad_(True)
    (dx_ref,) = torch.autograd.grad(grouped_lora_matmul_ref(xr, w, a, b, sizes, scales),
                                    (xr,), gy)
    torch.testing.assert_close(dx, dx_ref, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_counting():
    x, w, a, b, _, scales = _cohort((7, 30), 24, 12, 4)
    args = [torch.from_numpy(v) for v in (x, w, a, b)]
    before = (grouped_lora_chunk.launches, grouped_lora_direct.launches)
    for mode in gl_mod.MODES:
        y = grouped_lora(*args, group_sizes=(7, 30), scales=scales, mode=mode)
        assert torch.equal(y, grouped_lora_matmul_ref(*args, (7, 30), scales))
    assert (grouped_lora_chunk.launches, grouped_lora_direct.launches) == before


def test_direct_mode_limit_follows_shared_memory():
    assert gl_mod.direct_max_k(16) == 398
    assert gl_mod.direct_max_k(5) == gl_mod.direct_max_k(16)
    assert gl_mod.direct_max_k(64) < gl_mod.direct_max_k(32) < gl_mod.direct_max_k(16)


@pytest.mark.parametrize("case", ["sizes_sum", "empty_sizes", "one_of_scale",
                                  "scales_len", "pairs", "mode", "rank", "dtype",
                                  "layout", "device", "direct_k"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, w, a, b, _, _ = (torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                        for v in _cohort((5, 11), 16, 8, 4))
    kw = dict(group_sizes=(5, 11), scale=1.0)
    err = ValueError
    if case == "sizes_sum":
        kw["group_sizes"] = (5, 10)
    elif case == "empty_sizes":
        kw["group_sizes"] = ()
    elif case == "one_of_scale":
        kw["scales"] = (1.0, 2.0)
    elif case == "scales_len":
        kw = dict(group_sizes=(5, 11), scales=(1.0,))
    elif case == "pairs":
        a = a[:1]
    elif case == "mode":
        kw["mode"], err = "tiled", KeyError
    elif case == "rank":
        r = gl_mod.MAX_RANK + 1
        a, b = torch.zeros(2, r, 16), torch.zeros(2, 8, r)
    elif case == "dtype":
        x, err = x.double(), TypeError
    elif case == "layout":
        # the binding takes the backward's transposed views; a W with
        # neither unit stride (every other column of a wider tensor) is
        # neither of the layouts the kernel reads
        w_strided = torch.zeros(16, 16)[:, ::2]
        assert w_strided.shape == w.shape and 1 not in w_strided.stride()
        with pytest.raises(ValueError):
            grouped_lora(x, w_strided, a, b, group_sizes=(5, 11),
                         scales=(1.0, 1.0), mode="chunk")
        return
    elif case == "device":
        x, w, a, b = (v.to("meta") for v in (x, w, a, b))
    else:
        k = gl_mod.direct_max_k(4) + 1
        x, w, a = torch.zeros(16, k), torch.zeros(k, 8), torch.zeros(2, 4, k)
        kw["mode"] = "direct"
    with pytest.raises(err):
        grouped_lora_matmul(x, w, a, b, **kw)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,mode", [
    (((37, 100, 5), 130, 100, 5), "chunk"), (((37, 100, 5), 130, 100, 5), "direct"),
    (((40, 100, 17), 96, 150, 6), "chunk"), (((40, 100, 17), 96, 150, 6), "direct"),
    (((2048, 2048), 768, 768, 16), "chunk"),
], ids=["37-100-5-chunk", "37-100-5-direct", "40-100-17-chunk", "40-100-17-direct",
        "2048-2048-chunk"])
def test_cuda_kernel_matches_plain_version(cuda_device, shape, mode):
    """On the card: the kernel launches (its counter moves) and agrees with
    the plain version forward and for dx, dA, dB."""
    sizes, k, n, r = shape
    x, w, a, b, gy, scales = (torch.from_numpy(v).to(cuda_device)
                              if isinstance(v, np.ndarray) else v
                              for v in _cohort(sizes, k, n, r))
    counter = grouped_lora_chunk if mode == "chunk" else grouped_lora_direct
    before = counter.launches
    y = grouped_lora(x, w, a, b, group_sizes=sizes, scales=scales, mode=mode)
    assert counter.launches == before + 1
    scale = max(1.0, float(y.abs().max()))
    torch.testing.assert_close(y, grouped_lora_matmul_ref(x, w, a, b, sizes, scales),
                               rtol=0, atol=1e-4 * scale)
    grads = []
    for fn in (grouped_lora_matmul, None):
        xs, as_, bs = (v.clone().requires_grad_(True) for v in (x, a, b))
        if fn is None:
            yy = grouped_lora_matmul_ref(xs, w, as_, bs, sizes, scales)
        else:
            yy = fn(xs, w, as_, bs, group_sizes=sizes, scales=scales, mode=mode)
        grads.append(torch.autograd.grad(yy, (xs, as_, bs), gy))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * max(1.0, float(want.abs().max())))


def test_cuda_single_group_equals_lora_matmul(cuda_device):
    from repro_torch.kernels.lora_matmul import lora_matmul
    x, w, a, b, _, _ = (torch.from_numpy(v).to(cuda_device) if isinstance(v, np.ndarray)
                        else v for v in _cohort((300,), 200, 130, 16))
    y = grouped_lora(x, w, a, b, group_sizes=(300,), scales=(2.0,), mode="chunk")
    want = lora_matmul(x, w, a[0], b[0], scale=2.0)
    torch.testing.assert_close(y, want, rtol=0, atol=1e-4 * max(1.0, float(want.abs().max())))
    torch.testing.assert_close(want, lora_matmul_ref(x, w, a[0], b[0], 2.0), rtol=1e-4,
                               atol=1e-4)


def _norm_err(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("mode", ["chunk", "direct"])
@pytest.mark.parametrize("shape", [((37, 100, 5), 130, 100), ((300, 129, 1), 770, 130),
                                   ((200, 3), 96, 770)],
                         ids=["37-100-5", "300-129-1", "200-3"])
@pytest.mark.parametrize("r", [5, 16, 33])
def test_cuda_kernel_backward_layouts_ragged_shapes_and_ranks(cuda_device, shape, r, mode):
    """On the card, at group sizes, N and K off the 128 x 96 x 32 tiles
    (N and K of 130 and 770 take the 4-byte copies): the kernel on
    contiguous operands, on each of the backward's views, and on the dx
    call's own layout agrees with the plain version (normalized error
    <= 1e-4, chip_smoke.py's KERNEL_RTOL), and so do dx, dA and dB.  Direct
    mode takes K and N up to its shared-memory limit (398 at r <= 16, 299
    at r 33: both ragged)."""
    sizes, k, n = shape
    if mode == "direct":
        # the dx call contracts over N: both K and N within what it holds
        k, n = (min(v, gl_mod.direct_max_k(r)) for v in (k, n))
    x, w, a, b, gy, scales = (torch.from_numpy(v).to(cuda_device)
                              if isinstance(v, np.ndarray) else v
                              for v in _cohort(sizes, k, n, r, seed=r))
    want = grouped_lora_matmul_ref(x, w, a, b, sizes, scales)
    for which in ("", "w", "a", "b", "wab"):
        got = grouped_lora(x, *_grouped_views(w, a, b, which), group_sizes=sizes,
                           scales=scales, mode=mode)
        assert _norm_err(got, want) <= 1e-4, which
    views = (w.t(), b.transpose(1, 2), a.transpose(1, 2))
    got = grouped_lora(gy, *views, group_sizes=sizes, scales=scales, mode=mode)
    assert _norm_err(got, grouped_lora_matmul_ref(gy, *views, sizes, scales)) <= 1e-4
    grads = []
    for fn in (grouped_lora_matmul, None):
        xs, as_, bs = (v.clone().requires_grad_(True) for v in (x, a, b))
        yy = (fn(xs, w, as_, bs, group_sizes=sizes, scales=scales, mode=mode)
              if fn is not None else grouped_lora_matmul_ref(xs, w, as_, bs, sizes, scales))
        grads.append(torch.autograd.grad(yy, (xs, as_, bs), gy))
    for got, want in zip(*grads):
        assert _norm_err(got, want) <= 1e-4
