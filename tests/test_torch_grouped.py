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


@pytest.mark.parametrize("mode,bm", [("chunk", 128), ("direct", 128)])
def test_tile_table_at_the_kernel_tile_height_with_a_ragged_last_tile(mode, bm):
    """Both modes tile each group in 128-row tiles (the tensor-core tiles'
    height, one table for both); each group's last tile holds what is left
    of it."""
    assert mode in gl_mod.MODES and gl_mod.BM == bm
    sizes = (300, 129, 128)
    tiles = tile_table(sizes, gl_mod.BM)
    assert tiles == [(0, 0, 128), (0, 128, 128), (0, 256, 44), (1, 300, 128),
                     (1, 428, 1), (2, 429, 128)]
    assert tile_table(sizes) == tiles


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


@pytest.mark.parametrize("case", ["sizes_sum", "empty_sizes", "one_of_scale",
                                  "scales_len", "pairs", "mode", "rank", "dtype",
                                  "layout", "device"])
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
    else:
        # meta is a device the wrapper takes (the plain version, for a
        # trace); inputs split over two devices are not
        x = x.to("meta")
    with pytest.raises(err):
        grouped_lora_matmul(x, w, a, b, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(512, 96), (96, 770)], ids=["K512", "N770"])
def test_direct_mode_takes_every_k_against_jax_pallas(k, n, dtype):
    """Explicit ``mode="direct"`` at a K of 512 and, through the backward's
    dx call (which contracts over N), at an N of 770: forward and VJP
    against the reference's Pallas direct mode (interpret mode), which
    takes any K.  float32 at this file's tolerance; bfloat16 (the same
    bf16 values on both sides) at the bf16 tests' 3e-2
    (tests/test_torch_bf16_lora.py): both round y to bf16 once."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    sizes = (40, 100, 17)
    x, w, a, b, gy, scales = _cohort(sizes, k, n, 6, seed=k + n)
    if dtype == "bfloat16":
        x, w, a, b, gy = (torch.from_numpy(v).bfloat16().float().numpy()
                          for v in (x, w, a, b, gy))
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)

    def jf(x_, a_, b_):
        return jops.grouped_lora_matmul(x_, jnp.asarray(w, jt), a_, b_, group_sizes=sizes,
                                        scales=scales, mode="direct", interpret=True)

    jy, vjp = jax.vjp(jf, *(jnp.asarray(v, jt) for v in (x, a, b)))
    jdx, jda, jdb = vjp(jnp.asarray(gy, jt))
    tx, ta, tb = (torch.from_numpy(v.copy()).to(tt).requires_grad_(True) for v in (x, a, b))
    ty = grouped_lora_matmul(tx, torch.from_numpy(w).to(tt), ta, tb, group_sizes=sizes,
                             scales=scales, mode="direct")
    tdx, tda, tdb = torch.autograd.grad(ty, (tx, ta, tb), torch.from_numpy(gy).to(tt))
    for got, want in ((ty, jy), (tdx, jdx), (tda, jda), (tdb, jdb)):
        assert got.dtype == tt
        if dtype == "float32":
            _close(got, want)
        else:
            np.testing.assert_allclose(got.detach().float().numpy(),
                                       np.asarray(want, np.float32), rtol=3e-2, atol=3e-2)


def _choice_operands(dtype, k, n, which=""):
    x = torch.zeros(64, k, dtype=dtype)
    w, a, b = (torch.zeros(*s, dtype=dtype) for s in ((k, n), (2, 16, k), (2, n, 16)))
    return (x, *_grouped_views(w, a, b, which))


@pytest.mark.parametrize("dtype,k,n,which,resident", [
    (torch.float32, 128, 768, "", True),          # the fp32 timed shape
    (torch.float32, 96, 150, "wab", True),        # any layout: the 3xTF32 tile reads strides
    (torch.float32, 129, 768, "", False),         # past the resident slab: the K sweep
    (torch.float32, 770, 96, "", False),
    (torch.bfloat16, 128, 2048, "", True),        # the bf16 timed shape: the wgmma tile
    (torch.bfloat16, 64, 256, "wab", True),       # the dx call's views, TMA-describable
    (torch.bfloat16, 136, 2048, "", False),       # past the resident slab
    (torch.bfloat16, 96, 150, "", False),         # W's row stride 150: TMA cannot describe it
    (torch.bfloat16, 130, 64, "", False),
], ids=["f32-K128", "f32-views", "f32-K129", "f32-K770", "bf16-K128", "bf16-views",
        "bf16-K136", "bf16-N150", "bf16-K130"])
def test_direct_mode_chooses_resident_or_swept_body(dtype, k, n, which, resident):
    """The wrapper's choice, before the launch, between a resident tile
    (K <= DIRECT_MAX_K, and in bf16 operands TMA can describe) and the
    chunk tiles' K sweep."""
    assert gl_mod.DIRECT_MAX_K == 128
    assert gl_mod.direct_resident(*_choice_operands(dtype, k, n, which)) is resident


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
    mode takes every K: K 130 and 770, and the dx call's K of 770 (N
    forward), run the K sweep; K 96 the resident tile."""
    sizes, k, n = shape
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


@pytest.mark.parametrize("sizes,k,n,r", [((33, 290), 770, 192, 8), ((33, 290), 128, 770, 16),
                                         ((33, 290), 128, 192, 8), ((33, 290), 64, 256, 16),
                                         ((1000, 1100), 128, 2048, 16)],
                         ids=["K770", "N770", "K128-r8", "K64", "many-row-tiles"])
def test_cuda_bf16_direct_mode_every_view(cuda_device, sizes, k, n, r):
    """On the card, bf16 direct mode on contiguous operands, each of the
    backward's views and the dx call's layout, each output row within
    1e-2 of the plain version (chip_smoke.py's BF16_KERNEL_TOL): K 770 and
    the dx call's K of 770 run the K sweep, K <= 128 the resident wgmma
    tile (its A loaded by TMA or, on the B^T view at r 8 and 16, by hand).
    At 17 row tiles x 16 N tiles a block walks pairs of several row tiles,
    so it reloads the x slab and A_g, by TMA and by hand."""
    x, w, a, b, gy, scales = (torch.from_numpy(v).to(cuda_device).to(torch.bfloat16)
                              if isinstance(v, np.ndarray) else v
                              for v in _cohort(sizes, k, n, r, seed=k))

    def row_err(got, want):
        got, want = got.float(), want.float()
        return float((torch.linalg.vector_norm(got - want, dim=-1)
                      / torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)).max())

    want = grouped_lora_matmul_ref(x, w, a, b, sizes, scales)
    before = (grouped_lora_direct.launches_bf16, grouped_lora_direct.launches_swept)
    for which in ("", "w", "a", "b", "wab"):
        got = grouped_lora(x, *_grouped_views(w, a, b, which), group_sizes=sizes,
                           scales=scales, mode="direct")
        assert got.dtype == torch.bfloat16 and row_err(got, want) <= 1e-2, which
    views = (w.t(), b.transpose(1, 2), a.transpose(1, 2))
    got = grouped_lora(gy, *views, group_sizes=sizes, scales=scales, mode="direct")
    assert row_err(got, grouped_lora_matmul_ref(gy, *views, sizes, scales)) <= 1e-2
    swept = sum(not gl_mod.direct_resident(x, *_grouped_views(w, a, b, which))
                for which in ("", "w", "a", "b", "wab"))
    swept += not gl_mod.direct_resident(gy, *views)
    assert (grouped_lora_direct.launches_bf16 - before[0],
            grouped_lora_direct.launches_swept - before[1]) == (6, swept)
