"""bf16 through the fused and grouped LoRA kernels' wrappers and autograd ops.

On the CPU each wrapper runs its plain version (f32 sums of the bf16
operands, y rounded to bf16); these tests hold it, forward and backward,
against the JAX package's ``ops.fused_lora_matmul`` and
``ops.grouped_lora_matmul`` in bf16 (Pallas in interpret mode) on the
reference's own sweep shapes, and ``lora_apply(impl="fused")`` with bf16
weights for 2-D and 3-D adapters against the reference's.  The CUDA
kernels are held against their plain versions on the card (the tests named
``cuda``, which skip here, and ``chip_smoke.py``).

Tolerance: 3e-2, the reference's own for bf16 (tests/test_kernels.py,
tests/test_grouped_lora.py): both sides sum in f32 and round to bf16 once,
so they differ by an ulp of bf16 (2**-8 relative) where the f32 sums fall
on either side of a rounding boundary.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.kernels.grouped_lora import grouped_lora, grouped_lora_chunk, grouped_lora_direct
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.kernels.ops import fused_lora_matmul, grouped_lora_matmul
from repro_torch.kernels.ref import grouped_lora_matmul_ref, lora_matmul_ref
from repro_torch.models import layers as L
from repro_torch.numerics import set_fp32_policy

set_fp32_policy()

TOL = 3e-2
BF16 = torch.bfloat16
# the reference's sweep (tests/test_kernels.py: test_lora_matmul_sweep)
SWEEP = [(128, 128, 128), (64, 256, 128), (100, 300, 200), (7, 130, 64), (256, 512, 384)]


def _np(shape, rs, scale):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def _bf16_np(t):
    """bf16 values as f32 numpy (exact), for both packages."""
    return np.asarray(torch.from_numpy(t).to(BF16).float().numpy())


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("r", [4, 16])
def test_bf16_fused_matches_jax_pallas_forward_and_vjp(shape, r):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    m, k, n = shape
    rs = np.random.default_rng(r + m)
    x, w, a, b = (_bf16_np(_np(s, rs, f)) for s, f in
                  (((m, k), 0.5), ((k, n), 0.1), ((r, k), 0.1), ((n, r), 0.1)))
    g = _bf16_np(_np((m, n), rs, 1.0))

    def jf(x_, a_, b_):
        return jops.fused_lora_matmul(x_, jnp.asarray(w, jnp.bfloat16), a_, b_, scale=2.0)

    jy, vjp = jax.vjp(jf, *(jnp.asarray(v, jnp.bfloat16) for v in (x, a, b)))
    jdx, jda, jdb = vjp(jnp.asarray(g, jnp.bfloat16))
    assert jy.dtype == jnp.bfloat16

    tx, ta, tb = (torch.from_numpy(v).to(BF16).requires_grad_(True) for v in (x, a, b))
    ty = fused_lora_matmul(tx, torch.from_numpy(w).to(BF16), ta, tb, scale=2.0)
    tdx, tda, tdb = torch.autograd.grad(ty, (tx, ta, tb), torch.from_numpy(g).to(BF16))
    for got in (ty, tdx, tda, tdb):
        assert got.dtype == BF16
    for got, want in ((ty, jy), (tdx, jdx), (tda, jda), (tdb, jdb)):
        _close(got, want)


GROUPED = {
    # sizes, K, N, r, mode: the reference's test_grouped_dtypes cohort
    # (auto takes chunk at K 256) and direct mode's K <= 128
    "chunk": ((33, 90), 256, 192, 8, "auto"),
    "direct": ((40, 100, 17), 96, 150, 6, "auto"),
    "chunk_ragged": ((7, 130), 130, 64, 4, "chunk"),
}


@pytest.mark.parametrize("case", list(GROUPED))
def test_bf16_grouped_matches_jax_pallas_forward_and_vjp(case):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    sizes, k, n, r, mode = GROUPED[case]
    rs = np.random.default_rng(len(sizes) + k)
    m, gn = sum(sizes), len(sizes)
    x, w, a, b = (_bf16_np(_np(s, rs, f)) for s, f in
                  (((m, k), 0.5), ((k, n), 0.1), ((gn, r, k), 0.1), ((gn, n, r), 0.1)))
    g = _bf16_np(_np((m, n), rs, 1.0))
    scales = tuple(0.5 + 0.5 * i for i in range(gn))

    def jf(x_, a_, b_):
        return jops.grouped_lora_matmul(x_, jnp.asarray(w, jnp.bfloat16), a_, b_,
                                        group_sizes=sizes, scales=scales, mode=mode)

    jy, vjp = jax.vjp(jf, *(jnp.asarray(v, jnp.bfloat16) for v in (x, a, b)))
    jdx, jda, jdb = vjp(jnp.asarray(g, jnp.bfloat16))

    tx, ta, tb = (torch.from_numpy(v).to(BF16).requires_grad_(True) for v in (x, a, b))
    ty = grouped_lora_matmul(tx, torch.from_numpy(w).to(BF16), ta, tb, group_sizes=sizes,
                             scales=scales, mode=mode)
    tdx, tda, tdb = torch.autograd.grad(ty, (tx, ta, tb), torch.from_numpy(g).to(BF16))
    for got in (ty, tdx, tda, tdb):
        assert got.dtype == BF16
    for got, want in ((ty, jy), (tdx, jdx), (tda, jda), (tdb, jdb)):
        _close(got, want)


@pytest.mark.parametrize("grouped", [False, True], ids=["2d", "3d"])
def test_lora_apply_fused_bf16_matches_reference(grouped):
    """A bf16 base weight with f32 adapters, as the decoder LMs hold them:
    lora_apply(impl="fused") casts x, A and B to W's type and runs the
    kernel in bf16 (the reference's layers.lora_apply), forward and the
    adapters' gradients."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import layers as JL

    rs = np.random.default_rng(11 + grouped)
    gn, rows, k, n, r = 2, 12, 160, 96, 8
    x = _bf16_np(_np((gn * rows, k) if grouped else (3, rows, k), rs, 0.5))
    w = _bf16_np(_np((k, n), rs, 0.1))
    a_shape, b_shape = ((gn, r, k), (gn, n, r)) if grouped else ((r, k), (n, r))
    a, b = _np(a_shape, rs, 0.1), _np(b_shape, rs, 0.1)
    g = _np(x.shape[:-1] + (n,), rs, 1.0)

    def jf(a_, b_):
        y = JL.lora_apply(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                          {"a": a_, "b": b_}, 2.0, impl="fused")
        return y

    jy, vjp = jax.vjp(jf, jnp.asarray(a), jnp.asarray(b))
    jda, jdb = vjp(jnp.asarray(g, jnp.bfloat16))
    ta, tb = (torch.from_numpy(v).requires_grad_(True) for v in (a, b))
    ty = L.lora_apply(torch.from_numpy(x).to(BF16), torch.from_numpy(w).to(BF16),
                      {"a": ta, "b": tb}, 2.0, impl="fused")
    tda, tdb = torch.autograd.grad(ty, (ta, tb), torch.from_numpy(g).to(BF16))
    assert ty.dtype == BF16 and tda.dtype == torch.float32
    for got, want in ((ty, jy), (tda, jda), (tdb, jdb)):
        _close(got, want)


@pytest.mark.parametrize("op", ["lora_matmul", "grouped_lora"])
@pytest.mark.parametrize("case", ["mixed", "float16", "float64"])
def test_bf16_inputs_that_cannot_run_raise(op, case):
    """All four operands share one type, float32 or bfloat16: a mixed set,
    or another type, raises TypeError (on the CPU too, before the plain
    version runs)."""
    x, w = torch.zeros(8, 16, dtype=BF16), torch.zeros(16, 8, dtype=BF16)
    a, b = torch.zeros(4, 16, dtype=BF16), torch.zeros(8, 4, dtype=BF16)
    if case == "mixed":
        w = w.float()
    else:
        dt = torch.float16 if case == "float16" else torch.float64
        x, w, a, b = (t.to(dt) for t in (x, w, a, b))
    with pytest.raises(TypeError):
        if op == "lora_matmul":
            lora_matmul(x, w, a, b, scale=1.0)
        else:
            grouped_lora(x, w, a[None].expand(2, -1, -1).contiguous(),
                         b[None].expand(2, -1, -1).contiguous(), group_sizes=(3, 5),
                         scales=(1.0, 1.0), mode="chunk")


def test_bf16_cpu_takes_the_plain_version_in_bf16_without_counting():
    rs = np.random.default_rng(3)
    x, w, a, b = (torch.from_numpy(_np(s, rs, 0.3)).to(BF16)
                  for s in ((16, 32), (32, 8), (4, 32), (8, 4)))
    counts = (lora_matmul.launches, lora_matmul.launches_bf16,
              grouped_lora_chunk.launches_bf16, grouped_lora_direct.launches_bf16)
    y = lora_matmul(x, w, a, b, scale=2.0)
    assert y.dtype == BF16 and torch.equal(y, lora_matmul_ref(x, w, a, b, 2.0))
    yg = grouped_lora(x, w, torch.stack([a, a]), torch.stack([b, b]), group_sizes=(6, 10),
                      scales=(1.0, 2.0), mode="direct")
    assert yg.dtype == BF16
    assert torch.equal(yg, grouped_lora_matmul_ref(x, w, torch.stack([a, a]),
                                                   torch.stack([b, b]), (6, 10), (1.0, 2.0)))
    assert counts == (lora_matmul.launches, lora_matmul.launches_bf16,
                      grouped_lora_chunk.launches_bf16, grouped_lora_direct.launches_bf16)


def test_build_stamp_follows_the_bf16_header(tmp_path):
    """lora_matmul.cu and grouped_lora.cu share their bf16 tile through
    csrc/bf16_lora_tile.cuh: an edit to it rebuilds both, and no other
    library."""
    import shutil
    from repro_torch.kernels import build
    for src in build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    names = ("lora_matmul", "grouped_lora", "quant", "wkv6", "flash_attention")
    before = {n: build._digest(tmp_path / f"{n}.cu") for n in names}
    header = tmp_path / "bf16_lora_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build._digest(tmp_path / f"{n}.cu") for n in names}
    assert {n for n in names if after[n] != before[n]} == {"lora_matmul", "grouped_lora"}


# ----------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _row_err(got, want):
    """Worst row's relative error in the 2-norm, each row over its own scale."""
    got, want = got.float(), want.float()
    diff = torch.linalg.vector_norm(got - want, dim=-1)
    return float((diff / torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)).max())


def _cuda_inputs(m, k, n, r, dev, seed=0, groups=None):
    rs = np.random.default_rng(seed)
    lead = () if groups is None else (groups,)
    shapes = (((m, k), 1.0), ((k, n), k ** -0.5), (lead + (r, k), r ** -0.5),
              (lead + (n, r), 0.1), ((m, n), 1.0))
    return [torch.from_numpy(_np(s, rs, f)).to(BF16).to(dev) for s, f in shapes]


@pytest.mark.parametrize("shape", [(2048, 2048, 256), (100, 300, 200), (7, 130, 64),
                                   (2047, 768, 770)])
@pytest.mark.parametrize("r", [4, 16, 64])
def test_cuda_bf16_kernel_matches_plain_version(cuda_device, shape, r):
    """On the card, bf16: the kernel launches (both counters move), agrees
    with the plain version per row (<= 1e-2) on contiguous operands, on the
    backward's transposed views and in the dx call's layout, and its
    autograd op's dx, dA and dB agree with the plain version's."""
    x, w, a, b, g = _cuda_inputs(*shape, r, cuda_device, seed=r)
    want = lora_matmul_ref(x, w, a, b, 2.0)
    before = (lora_matmul.launches, lora_matmul.launches_bf16)
    y = lora_matmul(x, w, a, b, scale=2.0)
    assert (lora_matmul.launches, lora_matmul.launches_bf16) == (before[0] + 1,
                                                                  before[1] + 1)
    assert y.dtype == BF16 and _row_err(y, want) <= 1e-2
    views = [v.t().contiguous().t() for v in (w, a, b)]
    assert _row_err(lora_matmul(x, *views, scale=2.0), want) <= 1e-2
    got = lora_matmul(g, w.t(), b.t(), a.t(), scale=2.0)
    assert _row_err(got, lora_matmul_ref(g, w.t(), b.t(), a.t(), 2.0)) <= 1e-2
    grads = []
    for fn in (fused_lora_matmul, None):
        xs, as_, bs = (v.clone().requires_grad_(True) for v in (x, a, b))
        yy = (fn(xs, w, as_, bs, scale=2.0) if fn is not None
              else lora_matmul_ref(xs, w, as_, bs, 2.0))
        grads.append(torch.autograd.grad(yy, (xs, as_, bs), g))
    for got, want in zip(*grads):
        assert got.dtype == BF16 and _row_err(got, want) <= 1e-2


@pytest.mark.parametrize("mode,sizes,k,n,r", [
    ("chunk", (2048, 2048), 2048, 256, 16),
    ("chunk", (37, 100, 5), 130, 100, 5),
    ("direct", (40, 100, 17), 96, 150, 6),
    ("direct", (33, 90), 128, 192, 8),
])
def test_cuda_bf16_grouped_kernel_matches_plain_version(cuda_device, mode, sizes, k, n, r):
    x, w, a, b, g = _cuda_inputs(sum(sizes), k, n, r, cuda_device, seed=r,
                                 groups=len(sizes))
    scales = tuple(0.5 + 0.5 * i for i in range(len(sizes)))
    counter = grouped_lora_chunk if mode == "chunk" else grouped_lora_direct
    before = counter.launches_bf16
    y = grouped_lora(x, w, a, b, group_sizes=sizes, scales=scales, mode=mode)
    assert counter.launches_bf16 == before + 1 and y.dtype == BF16
    assert _row_err(y, grouped_lora_matmul_ref(x, w, a, b, sizes, scales)) <= 1e-2
    views = (w.t(), b.transpose(1, 2), a.transpose(1, 2))
    got = grouped_lora(g, *views, group_sizes=sizes, scales=scales, mode=mode)
    assert _row_err(got, grouped_lora_matmul_ref(g, *views, sizes, scales)) <= 1e-2
