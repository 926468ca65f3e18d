"""The flash-attention kernel's wrapper and its place in the model.

On the CPU the wrapper runs the plain version; these tests hold it against
the JAX package's ``ops.flash_attention_apply`` (Pallas in interpret mode)
and ``ref.flash_attention_ref`` on the same seeded numpy inputs, over the
reference's own sweep (causal, window, non-causal; GQA and MQA; ragged S;
fp32 and bf16) and at S != T, and hold ``attention_full(impl="chunked")``
against the reference's chunked and naive attention.  The kernel pair's
plain versions (the forward with its lse, and the backward from lse) are
held against autograd through the port's naive and chunked attention.
The CUDA kernels are held against the plain versions on the card (tests
at the end, and ``chip_smoke.py``); here those tests skip.

Tolerances: fp32 atol 2e-5 (the reference's kernel-vs-naive tolerance:
online softmax against one softmax, sums in another order); bf16 atol 3e-2
(p and the output round to bf16 at different points: the Pallas kernel
per key tile, the plain version once).
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

from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain)
from repro_torch.kernels.ops import flash_attention_apply  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402

set_fp32_policy()

ATOL_F32, ATOL_BF16 = 2e-5, 3e-2


def _qkv(b, s, t, h, kh, d, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((b, s, h, d)).astype(np.float32),
            rs.standard_normal((b, t, kh, d)).astype(np.float32),
            rs.standard_normal((b, t, kh, d)).astype(np.float32))


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    return jax, jnp, jops


def _torch(*arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("b,s,h,kh,d", [(2, 128, 4, 4, 32), (1, 100, 8, 2, 64),
                                        (2, 64, 4, 1, 32), (1, 70, 2, 2, 112)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 64)])
def test_flash_sweep_matches_reference(b, s, h, kh, d, causal, window):
    _, jnp, jops = _jax()
    q, k, v = _qkv(b, s, s, h, kh, d)
    want = jops.flash_attention_apply(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, window=window, bq=32, bk=32)
    got = flash_attention_apply(*_torch(q, k, v), causal=causal, window=window)
    assert tuple(got.shape) == (b, s, h * d)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL_F32)
    # the reference's oracle and the port's plain version, on the heads laid
    # out as (B*H, S, D), kv heads repeated
    from repro.kernels.ref import flash_attention_ref as j_ref

    def heads(x):
        x = np.repeat(x, h // x.shape[2], axis=2)
        return np.moveaxis(x, 2, 1).reshape(b * h, s, d)

    oracle = np.asarray(j_ref(*(jnp.asarray(heads(x)) for x in (q, k, v)),
                              causal=causal, window=window))
    plain = flash_attention_ref(*_torch(*(heads(x) for x in (q, k, v))),
                                causal=causal, window=window)
    np.testing.assert_allclose(_f32(plain), oracle, atol=ATOL_F32)
    oracle = np.moveaxis(oracle.reshape(b, h, s, d), 1, 2).reshape(b, s, h * d)
    np.testing.assert_allclose(_f32(got), oracle, atol=ATOL_F32)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 16)])
def test_flash_bf16_matches_reference(causal, window):
    _, jnp, jops = _jax()
    q, k, v = _qkv(1, 128, 128, 2, 2, 32, seed=1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jops.flash_attention_apply(jq, jk, jv, causal=causal, window=window,
                                      bq=64, bk=64)
    tq, tk, tv = _torch(q, k, v, dtype=torch.bfloat16)
    got = flash_attention_apply(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL_BF16)


@pytest.mark.parametrize("s,t,causal", [(48, 80, True), (48, 80, False), (70, 33, False)])
def test_flash_ragged_s_and_t(s, t, causal):
    """S != T, neither a multiple of a tile: the reference pads both and
    masks the padded keys; the port masks without padding."""
    _, jnp, jops = _jax()
    q, k, v = _qkv(2, s, t, 4, 2, 32, seed=2)
    want = jops.flash_attention_apply(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, bq=32, bk=32)
    got = flash_attention_apply(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL_F32)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7), (False, None)])
def test_attention_full_chunked_matches_reference(causal, window):
    jax, jnp, _ = _jax()
    from repro.models import layers as JL
    q, k, v = _qkv(2, 50, 50, 4, 2, 16, seed=3)
    pos_j, pos_t = jnp.arange(50), torch.arange(50)
    got = L.attention_full(*_torch(q, k, v), causal=causal, window=window,
                           q_pos=pos_t, k_pos=pos_t, impl="chunked")
    for impl in ("chunked", "naive"):
        want = JL.attention_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, window=window, q_pos=pos_j, k_pos=pos_j,
                                 impl=impl, chunk=16)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL_F32)
    naive = L.attention_full(*_torch(q, k, v), causal=causal, window=window,
                             q_pos=pos_t, k_pos=pos_t, impl="naive")
    np.testing.assert_allclose(_f32(got), _f32(naive), atol=ATOL_F32)


# the pair against autograd through the port's own forms and against
# jax.vjp of the JAX package's: fp32 sums the same f32 products in another
# order (2e-5 on the output as above; 1e-5 on a gradient's norm: softmax's
# backward sum(dP * P) against the pair's rowsum(dO * O), equal in exact
# arithmetic); bf16 against naive 1e-2 on the output (p rounds to bf16
# before P V on both sides, but the scores are summed in another order, so
# a p near a rounding edge may land an ulp away), against chunked ATOL_BF16
# (the chunked form rounds p relative to its running max, per chunk, and
# divides after); 2e-2 on a bf16 gradient's norm (the naive backward rounds
# dP = dO V^T to bf16, the pair keeps it in f32; dq, dk, dv round to bf16:
# the pair reads 2.6e-3 to 4.4e-3 from either side's dq and dk)
PAIR_SHAPES = [(2, 65, 65, 8, 2, 64),     # GQA 4:1, ragged S = T
               (2, 48, 80, 8, 2, 64),     # S -> T, neither a tile multiple
               (2, 65, 65, 8, 1, 64)]     # MQA
PAIR_TOL = {("naive", torch.float32): (2e-5, 1e-5), ("chunked", torch.float32): (2e-5, 1e-5),
            ("naive", torch.bfloat16): (1e-2, 2e-2), ("chunked", torch.bfloat16): (ATOL_BF16, 2e-2)}
PAIR_CASES = pytest.mark.parametrize(
    "impl,dtype,causal,window,shape",
    [(impl, dtype, causal, window, shape) for shape in PAIR_SHAPES
     for causal, window in ((True, None), (False, None), (True, 16))
     for dtype in (torch.float32, torch.bfloat16) for impl in ("naive", "chunked")])


def _rel(got, want):
    return float(torch.linalg.vector_norm((got - want).float())
                 / torch.linalg.vector_norm(want.float()))


def _pair_run(impl, dtype, causal, window, shape):
    """Seeded numpy inputs and cotangent, and the pair's output and
    (dq, dk, dv) from them through ``flash_attention_apply`` on the CPU
    (its plain versions), ``normalize_first`` for naive."""
    b, s, t, h, kh, d = shape
    arrs = _qkv(b, s, t, h, kh, d, seed=s + t + kh)
    dout = np.random.default_rng(7).standard_normal((b, s, h * d)).astype(np.float32)
    pair = [x.requires_grad_(True) for x in _torch(*arrs, dtype=dtype)]
    got = flash_attention_apply(*pair, causal=causal, window=window,
                                normalize_first=impl == "naive")
    got_g = torch.autograd.grad(got, pair, torch.from_numpy(dout).to(dtype))
    assert got.dtype == dtype and all(g.dtype == dtype for g in got_g)
    return arrs, dout, got.detach(), got_g


@PAIR_CASES
def test_pair_plain_versions_match_autograd(impl, dtype, causal, window, shape):
    """The pair's plain versions (what a CPU tensor runs): the forward
    (``normalize_first`` for naive), its lse against the log-sum-exp of
    naive's own masked scores, and the backward from lse (P recomputed, the
    GQA heads summed into each kv head) against autograd through
    ``_gqa_scores_softmax_out`` (naive) or ``_attention_chunked``."""
    b, s, t, h, kh, d = shape
    arrs, dout, got, got_g = _pair_run(impl, dtype, causal, window, shape)
    q, k, v = _torch(*arrs, dtype=dtype)
    pos_q, pos_k = torch.arange(s), torch.arange(t)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    if impl == "naive":
        want = L.attention_full(*leaves, causal=causal, window=window, q_pos=pos_q,
                                k_pos=pos_k, impl="naive")
    else:
        want = L._attention_chunked(*leaves, causal=causal, window=window, q_pos=pos_q,
                                    k_pos=pos_k, chunk=16)
    want_g = torch.autograd.grad(want, leaves, torch.from_numpy(dout).to(dtype))
    out_tol, grad_tol = PAIR_TOL[impl, dtype]
    np.testing.assert_allclose(_f32(got), _f32(want.detach()), atol=out_tol)
    for name, g, w in zip("qkv", got_g, want_g):
        assert _rel(g, w) <= grad_tol, (name, _rel(g, w))
    # lse: naive's scores, masked as it masks them, under one log-sum-exp
    rel = pos_q[:, None] - pos_k[None, :]
    mask = (rel >= 0) if causal else torch.ones((s, t), dtype=torch.bool)
    if window is not None:
        mask = mask & (rel < window)
    sc = torch.einsum("bshd,bthd->bhst", q.float(),
                      k.float().repeat_interleave(h // kh, dim=2)) / np.sqrt(d)
    lse_want = torch.logsumexp(torch.where(mask, sc, torch.full_like(sc, -1e30)), dim=-1)
    _, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), lse_want.numpy(), atol=1e-5)


@PAIR_CASES
def test_pair_matches_jax_vjp(impl, dtype, causal, window, shape):
    """The pair's output and (dq, dk, dv) against the JAX package: its
    ``attention_full(impl=...)`` (chunked over 16-key chunks) and
    ``jax.vjp`` of it, on the same numpy inputs and cotangent, in the same
    type, at the tolerances above."""
    jax, jnp, _ = _jax()
    from repro.models import layers as JL
    b, s, t, h, kh, d = shape
    arrs, dout, got, got_g = _pair_run(impl, dtype, causal, window, shape)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def attend(q, k, v):
        return JL.attention_full(q, k, v, causal=causal, window=window, q_pos=jnp.arange(s),
                                 k_pos=jnp.arange(t), impl=impl, chunk=16)

    want, vjp = jax.vjp(attend, *(jnp.asarray(x, jdt) for x in arrs))
    want_g = vjp(jnp.asarray(dout, jdt))
    out_tol, grad_tol = PAIR_TOL[impl, dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=out_tol)
    for name, g, w in zip("qkv", got_g, want_g):
        w = torch.from_numpy(np.array(w, np.float32))
        assert _rel(g, w) <= grad_tol, (name, _rel(g, w))


def test_flash_bwd_refuses_bad_inputs():
    q, k, v = _torch(*_qkv(1, 8, 8, 4, 2, 16))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, out[:, :4], lse, causal=True)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, out, lse[:, :1], causal=True)


def test_flash_wrapper_refuses_bad_inputs():
    q, k, v = _torch(*_qkv(1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1].expand(1, 8, 3, 16), v, causal=True)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, causal=True, window=0)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double(), causal=True)
    with pytest.raises(ValueError):
        flash_attention(q[0], k[0], v[0], causal=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _row_err(got, want):
    """Each query row's relative error |got - want| / |want| (2-norms over
    the row), the largest over rows, as chip_smoke.py's row_err: late
    causal rows average many values and are small, so one scale for the
    whole output would not see a fault confined to them.  bf16 rounds p and
    the output relative to their own size (an ulp is 2**-8 of the value),
    so 1e-2 holds per row."""
    diff = torch.linalg.vector_norm(got - want, dim=-1)
    return float((diff / torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,causal,window", [((2, 100, 100, 8, 2, 64), True, None),
                                                 ((1, 70, 90, 4, 1, 32), False, None),
                                                 ((1, 200, 200, 2, 1, 256), True, 64),
                                                 ((2, 150, 150, 4, 4, 112), True, None)])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, tol, shape, causal, window):
    """On the card: the kernel launches (the counter moves), reads GQA heads
    and strides in place, and agrees with the plain version."""
    b, s, t, h, kh, d = shape
    q, k, v = (x.to(cuda_device) for x in _torch(*_qkv(b, s, t, h, kh, d), dtype=dtype))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    want = flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal, window=window)
    err = _row_err(got.float().cpu(), want.float())
    assert err <= tol, err


@pytest.mark.parametrize("d", [32, 64, 112, 128, 256])
@pytest.mark.parametrize("shape,causal,window", [((1, 70, 150, 4, 2, None), False, None),
                                                 ((1, 150, 70, 4, 2, None), True, None),
                                                 ((1, 300, 300, 4, 1, None), True, 100),
                                                 ((1, 200, 200, 32, 8, None), True, None)])
def test_cuda_bf16_tensor_core_path(cuda_device, d, shape, causal, window):
    """On the card, the bf16 path (wgmma products, TMA-fed K/V ring) at every
    head dimension (112 as the 128-wide tile, zero-filled past D): ragged S != T (no tile multiple; S > T causal, where
    the last rows see every key), a causal window, and
    GQA with 32 query heads on 8 kv heads; per-row error <= 1e-2 against
    the plain version, as chip_smoke.py's bf16 tolerance (p and the output
    round to bf16 at other points), for the online and the normalise-first
    instance."""
    b, s, t, h, kh, _ = shape
    q, k, v = (x.to(cuda_device) for x in _torch(*_qkv(b, s, t, h, kh, d, seed=d),
                                                  dtype=torch.bfloat16))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    nf = flash_attention(q, k, v, causal=causal, window=window, normalize_first=True)
    assert flash_attention.launches == before + 2
    want = flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal, window=window).float()
    assert _row_err(got.float().cpu(), want) <= 1e-2
    assert _row_err(nf.float().cpu(), want) <= 1e-2


def test_cuda_kernel_launches_on_every_card():
    """The bf16 kernel's shared-memory opt-in acts on one device's context:
    after launches on the first card, each other card launches too and
    agrees with the plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    q, k, v = _torch(*_qkv(1, 150, 150, 4, 2, 64, seed=3), dtype=torch.bfloat16)
    want = flash_attention(q, k, v, causal=True).float()
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        before = flash_attention.launches
        got = flash_attention(q.to(dev), k.to(dev), v.to(dev), causal=True)
        assert flash_attention.launches == before + 1 and got.device == dev
        assert _row_err(got.float().cpu(), want) <= 1e-2, i


def test_cuda_wrapper_is_forward_only(cuda_device):
    """Under a gradient the wrapper takes only what the backward kernel
    has (bf16 at ``BWD_HEAD_DIMS``) and raises before any launch on the
    rest; without one every type and head dim runs forward."""
    q, k, v = (x.to(cuda_device) for x in _torch(*_qkv(1, 8, 8, 2, 1, 32)))
    before = flash_attention.launches
    with pytest.raises(NotImplementedError, match="backward kernel"):
        flash_attention_apply(q.clone().requires_grad_(True), k, v, causal=True)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    with pytest.raises(NotImplementedError, match="backward kernel"):
        flash_attention_apply(qb.clone().requires_grad_(True), kb, vb, causal=True)
    assert flash_attention.launches == before
    with torch.no_grad():
        assert flash_attention_apply(q, k, v, causal=True).shape == (1, 8, 64)
        assert flash_attention_apply(qb, kb, vb, causal=True,
                                     normalize_first=True).shape == (1, 8, 64)
    assert flash_attention.launches == before + 2


def _grad_err(got, want):
    """Each row's error (the last axis: one query's or one key's gradient
    of one head) over its own norm, the largest over rows; but a row whose
    exact gradient vanishes (the first query under a causal mask: its P is
    one at one key, so dS = 0; a key no query sees) holds round-off alone,
    under a thousandth of the median row's norm, and is taken over the
    median row's.  bf16 outputs round at 2**-9 of their size; 1e-2 as the
    forward's per-row hold."""
    diff = torch.linalg.vector_norm((got - want).float(), dim=-1)
    norm = torch.linalg.vector_norm(want.float(), dim=-1)
    med = norm.median()
    norm = torch.where(norm < 1e-3 * med, med, norm)
    return float((diff / norm.clamp_min(1e-30)).max())


# dq, dk, dv against the plain backward over the whole tensor (``_rel``):
# both keep dS in f32 precision and round each gradient to bf16 once, so
# they differ only where an f32 value straddles a rounding edge; the plain
# backward with dS rounded to bf16 alone (the control) reads above it on
# dq and dk (chip_smoke.py's FLASH_GRAD_REL_TOL: on an H100 the kernel read
# at most 1.7e-4, the control at least 2.46e-3)
GRAD_REL_TOL = 5e-4


PAIR_CUDA_CASES = [((16, 512, 512, 32, 8, 64), True, None),    # granite-3-2b's server step
                   ((2, 65, 65, 8, 2, 64), True, None),
                   ((2, 48, 80, 8, 2, 64), True, None),
                   ((2, 48, 80, 8, 1, 64), False, None),
                   ((1, 300, 300, 4, 1, 64), True, 100),
                   ((2, 200, 150, 8, 2, 64), False, 64),
                   ((1, 150, 70, 4, 2, 64), True, None)]


def _pair_inputs(shape, seed):
    b, s, t, h, kh, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shp, generator=g, device="cuda").bfloat16()
            for shp in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d), (b, s, h, d))]


@pytest.mark.parametrize("shape,causal,window", PAIR_CUDA_CASES)
def test_cuda_pair_matches_plain_versions(cuda_device, shape, causal, window):
    """On the card: the forward's lse (f32, within 1e-5: exp and log in
    another order) and both instances' output (per row within 1e-2), then
    dq, dk and dv of both instances' lse against the plain backward (per
    row within 1e-2, ``_grad_err``; over the tensor within GRAD_REL_TOL,
    which the plain backward with dS rounded to bf16 alone exceeds on dq
    and dk); the backward's counter grows by two (its two kernels) a call
    and the forward's by one."""
    q, k, v, do = _pair_inputs(shape, seed=sum(shape))
    want, lse_want = flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal, window=window,
                                     return_lse=True)
    for nf in (False, True):
        before = flash_attention.launches
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   normalize_first=nf, return_lse=True)
        assert flash_attention.launches == before + 1
        assert float((lse.cpu() - lse_want).abs().max()) <= 1e-5
        assert _row_err(out.float().cpu(), want.float()) <= 1e-2, nf
        before = flash_attention_bwd.launches
        got = flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
        assert flash_attention_bwd.launches == before + 2
        args = [x.cpu() for x in (q, k, v, out, do, lse)]
        plain = flash_attention_bwd(*args, causal=causal, window=window)
        for name, g, w in zip("qkv", got, plain):
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            assert _grad_err(g.cpu(), w) <= 1e-2, (nf, name, _grad_err(g.cpu(), w))
            assert _rel(g.cpu(), w) <= GRAD_REL_TOL, (nf, name, _rel(g.cpu(), w))
        coarse = flash_attention_bwd_plain(*args, causal, window, ds_dtype=torch.bfloat16)
        for name, c, w in zip("qk", coarse, plain):
            assert _rel(c, w) > GRAD_REL_TOL, (nf, name, _rel(c, w))


def test_cuda_backward_is_bit_equal_run_to_run(cuda_device):
    """No float atomics: two backward calls at granite-3-2b's shape give
    the same bits, as kill-and-resume and tracing on against off need."""
    q, k, v, do = _pair_inputs((16, 512, 512, 32, 8, 64), seed=5)
    out, lse = flash_attention(q, k, v, causal=True, normalize_first=True, return_lse=True)
    first = flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    second = flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_cuda_attention_full_routes_by_input(cuda_device):
    """attention_full on the card: bf16 at head_dim 64 with arange
    positions runs the pair under a gradient, for both impls (the forward
    once, the backward's two kernels once); fp32, head_dim 128 under a
    gradient, positions not flagged as an arange, and CPU tensors take the
    plain paths and launch nothing."""
    def run(dtype, d, device, impl, arange=True, grad=True):
        q, k, v = (x.to(device) for x in _torch(*_qkv(1, 64, 64, 4, 2, d, seed=d),
                                                  dtype=dtype))
        leaves = [x.requires_grad_(grad) for x in (q, k, v)]
        pos = torch.arange(64, device=device)
        f0, b0 = flash_attention.launches, flash_attention_bwd.launches
        out = L.attention_full(*leaves, causal=True, window=None, q_pos=pos, k_pos=pos,
                               impl=impl, arange=arange)
        if grad:
            out.float().sum().backward()
        return flash_attention.launches - f0, flash_attention_bwd.launches - b0

    for impl in ("naive", "chunked"):
        assert run(torch.bfloat16, 64, cuda_device, impl) == (1, 2)
        assert run(torch.bfloat16, 128, cuda_device, impl, grad=False) == (1, 0)
        assert run(torch.float32, 64, cuda_device, impl) == (0, 0)
        assert run(torch.bfloat16, 128, cuda_device, impl) == (0, 0)
        assert run(torch.bfloat16, 64, cuda_device, impl, arange=False) == (0, 0)
        assert run(torch.bfloat16, 64, torch.device("cpu"), impl) == (0, 0)
    # fp32 without a gradient: naive stays plain, chunked takes the forward kernel
    assert run(torch.float32, 64, cuda_device, "naive", grad=False) == (0, 0)
    assert run(torch.float32, 64, cuda_device, "chunked", grad=False) == (1, 0)
