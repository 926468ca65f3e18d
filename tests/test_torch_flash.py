"""The flash-attention kernel's wrapper and its place in the model.

On the CPU the wrapper runs the plain version; these tests hold it against
the JAX package's ``ops.flash_attention_apply`` (Pallas in interpret mode)
and ``ref.flash_attention_ref`` on the same seeded numpy inputs, over the
reference's own sweep (causal, window, non-causal; GQA and MQA; ragged S;
fp32 and bf16) and at S != T, and hold ``attention_full(impl="chunked")``
against the reference's chunked and naive attention.  The CUDA kernel is
held against the plain version on the card (tests at the end, and
``chip_smoke.py``); here those tests skip.

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

from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
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
    round to bf16 at other points)."""
    b, s, t, h, kh, _ = shape
    q, k, v = (x.to(cuda_device) for x in _torch(*_qkv(b, s, t, h, kh, d, seed=d),
                                                  dtype=torch.bfloat16))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    want = flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal, window=window).float()
    assert _row_err(got.float().cpu(), want) <= 1e-2


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
    q, k, v = (x.to(cuda_device) for x in _torch(*_qkv(1, 8, 8, 2, 1, 32)))
    with pytest.raises(NotImplementedError, match="no VJP"):
        flash_attention_apply(q.requires_grad_(True), k, v, causal=True)
    with torch.no_grad():
        assert flash_attention_apply(q, k, v, causal=True).shape == (1, 8, 64)
