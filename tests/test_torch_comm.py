"""The port's int8 transport compression against the JAX package's.

``quantize`` (through the quantize kernel's plain version on the CPU) and
``quantize_rows_ref`` are bit-equal to the reference's ``comm.quantize``
and to its Pallas ``quantize_rows`` in interpret mode, exact .5 ties and a
zero row included, in float32 and in bfloat16 (read in its stored type, as
the reference's kernel reads it); ``quantize_with_feedback`` carries the
same residuals.
The CUDA kernel is held against its plain version on the card (tests at
the end, and ``chip_smoke.py``); here those tests skip.
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

from repro_torch.comm import (Quantized, dequantize, quantize,
                              quantize_with_feedback, transport_bytes)
from repro_torch.kernels.quant import MAX_LOADS, quantize_rows, resident_loads
from repro_torch.kernels.ref import quantize_rows_ref

# x / scale of this row is [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]:
# round half to even gives [127, 0, 2, 2, 0, -2, -2, 4]; half away from
# zero would give [127, 1, 2, 3, -1, -2, -3, 4]
TIE_ROW = np.array([254, 1, 3, 5, -1, -3, -5, 7], np.float32)
TIE_Q = np.array([127, 0, 2, 2, 0, -2, -2, 4], np.int8)


def _rows(n=512, d=64, seed=0):
    """Seeded rows with a tie row and a zero row among them."""
    rs = np.random.default_rng(seed)
    x = (rs.standard_normal((n, d)) * 2.0).astype(np.float32)
    x[3, :] = 0.0
    if d >= TIE_ROW.size:
        x[5, :] = 0.0
        x[5, :TIE_ROW.size] = TIE_ROW
    return x


def test_tie_row_rounds_half_to_even_and_zero_row_floors_the_scale():
    q, s = quantize_rows_ref(torch.from_numpy(_rows()))
    np.testing.assert_array_equal(q[5, :TIE_ROW.size].numpy(), TIE_Q)
    assert float(s[5]) == 2.0
    assert float(s[3]) == np.float32(1e-12) and not q[3].any()


def test_quantize_rows_bit_equal_to_jax_comm_and_kernel():
    """Bit-equal to ``comm.quantize``, which the reference Simulator runs
    eagerly.  The Pallas kernel in interpret mode runs under ``jit``, where
    XLA's CPU compiler turns ``absmax / 127`` into ``absmax * (1/127)``, so
    its scales differ from ``comm.quantize``'s by an ulp on some rows: its
    payload is compared bit for bit and its scales at the reference's own
    tolerance for that comparison (``tests/test_comm.py``, rtol 1e-6)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.comm import quantize as j_quantize
    from repro.kernels.quant import quantize_rows as j_quantize_rows

    x = _rows()
    jc = j_quantize(jnp.asarray(x))
    jq, js = j_quantize_rows(jnp.asarray(x), block_rows=256, interpret=True)
    q, s = quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jc.q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jc.scale))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("axis", [-1, 1])
def test_quantize_and_dequantize_bit_equal_to_jax(axis):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.comm import dequantize as j_dequantize
    from repro.comm import quantize as j_quantize

    x = _rows(96, 40).reshape(4, 24, 40)
    jq = j_quantize(jnp.asarray(x), axis=axis)
    tq = quantize(torch.from_numpy(x), axis=axis)
    assert isinstance(tq, Quantized) and tq.q.dtype == torch.int8
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.nbytes == jq.nbytes
    np.testing.assert_array_equal(dequantize(tq, axis=axis).numpy(),
                                  np.asarray(j_dequantize(jq, axis=axis)))


def test_quantize_with_feedback_residuals_equal_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.comm import quantize_with_feedback as j_qwf

    rs = np.random.default_rng(3)
    j_res = t_res = None
    for _ in range(4):
        x = rs.standard_normal((2, 16, 32)).astype(np.float32)
        jqx, j_res = j_qwf(jnp.asarray(x), j_res)
        tqx, t_res = quantize_with_feedback(torch.from_numpy(x), t_res)
        np.testing.assert_array_equal(tqx.q.numpy(), np.asarray(jqx.q))
        np.testing.assert_array_equal(tqx.scale.numpy(), np.asarray(jqx.scale))
        np.testing.assert_array_equal(t_res.numpy(), np.asarray(j_res))


def test_bf16_quantize_rows_bit_equal_to_jax_comm_and_kernel():
    """bf16 rows, quantized as stored: codes and scales bit-equal to the
    reference's ``comm.quantize`` on the same bf16 input.  Against its
    Pallas kernel (interpret mode): the scales within the reference's rtol
    1e-6 (the kernel's ``absmax / 127`` is a product with 1/127 under XLA,
    see above), and the codes bit-equal on every row whose scale the kernel
    formed as ``comm.quantize`` does.  On the rows where its scale is an
    ulp off (27 of 512 here) the reference's own two functions disagree on
    4 codes, by one, where x / scale falls on a rounding boundary, so no
    port can equal both there: those rows are held to one code."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.comm import quantize as j_quantize
    from repro.kernels.quant import quantize_rows as j_quantize_rows

    x = torch.from_numpy(_rows()).to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jc = j_quantize(xj)
    jq, js = j_quantize_rows(xj, block_rows=256, interpret=True)
    q, s = quantize_rows(x)
    np.testing.assert_array_equal(q[5, :TIE_ROW.size].numpy(), TIE_Q)
    assert float(s[3]) == np.float32(1e-12) and not q[3].any()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jc.q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jc.scale))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    same = np.asarray(js) == s.numpy()
    assert same.sum() >= 0.9 * same.size
    np.testing.assert_array_equal(q.numpy()[same], np.asarray(jq)[same])
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1


@pytest.mark.parametrize("axis", [-1, 1])
def test_bf16_quantize_bit_equal_to_jax(axis):
    """``comm.quantize`` hands bf16 to the kernel as it is (no f32 copy
    first) and matches the reference's ``comm.quantize`` bit for bit."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.comm import quantize as j_quantize

    x = torch.from_numpy(_rows(96, 40).reshape(4, 24, 40)).to(torch.bfloat16)
    jq = j_quantize(jnp.asarray(x.float().numpy(), jnp.bfloat16), axis=axis)
    tq = quantize(x, axis=axis)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))


def test_quantize_hands_bf16_to_the_kernel_in_its_stored_type(monkeypatch):
    from repro_torch.comm import quantization
    seen = []

    def recording(x):
        seen.append(x.dtype)
        return quantize_rows(x)

    monkeypatch.setattr(quantization, "quantize_rows", recording)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        quantization.quantize(torch.ones(3, 8, dtype=dtype))
    assert seen == [torch.float32, torch.bfloat16, torch.float32]


def _offset(x, elements):
    """The same values in storage that starts ``elements`` past a 16-byte
    boundary."""
    out = torch.empty(x.numel() + elements, dtype=x.dtype)[elements:]
    return out.view(x.shape).copy_(x)


@pytest.mark.parametrize("dtype,d,offset,loads", [
    (torch.float32, 768, 0, 6),       # the cohort path: 192 chunks, 6 a lane
    (torch.bfloat16, 768, 0, 3),
    (torch.float32, 1000, 0, 8),
    (torch.float32, 2048, 0, MAX_LOADS),
    (torch.bfloat16, 4096, 0, MAX_LOADS),
    (torch.float32, 2052, 0, 0),      # past 32 * MAX_LOADS chunks: strided
    (torch.float32, 12289, 0, 0),     # rows not whole 16-byte chunks
    (torch.bfloat16, 12289, 0, 0),
    (torch.float32, 7, 0, 0),
    (torch.float32, 768, 1, 0),       # a base off a 16-byte boundary
], ids=["f32-768", "bf16-768", "f32-1000", "f32-2048", "bf16-4096", "f32-2052",
        "f32-12289", "bf16-12289", "f32-7", "f32-768-unaligned"])
def test_resident_or_strided_body_chosen_by_width_type_and_alignment(dtype, d, offset,
                                                                     loads):
    x = torch.zeros(2, d, dtype=dtype)
    if offset:
        x = _offset(x, offset)
        assert x.data_ptr() % 16 != 0
    assert resident_loads(x) == loads


def test_transport_bytes_ratio():
    shape = (16, 128, 768)
    ratio = transport_bytes(shape, True) / transport_bytes(shape, False)
    assert 0.25 <= ratio < 0.26            # int8 + per-row scales


def test_cpu_tensors_take_the_plain_version_without_counting():
    x = torch.from_numpy(_rows(16, 8))
    before = quantize_rows.launches
    q, s = quantize_rows(x)
    assert quantize_rows.launches == before
    rq, rs_ = quantize_rows_ref(x)
    assert torch.equal(q, rq) and torch.equal(s, rs_)


@pytest.mark.parametrize("case", ["dims", "dtype", "layout", "device", "no_columns"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, err = torch.from_numpy(_rows(8, 6)), ValueError
    if case == "dims":
        x = x.reshape(2, 4, 6)
    elif case == "dtype":
        x, err = x.double(), TypeError      # float64, as float16, is not a kernel type
    elif case == "layout":
        x = x.t()
    elif case == "device":
        # a meta tensor is taken, not rejected: the plain version gives the
        # outputs' shapes for a trace, and no launch is counted
        before = quantize_rows.launches
        q, s = quantize_rows(x.to("meta"))
        assert q.is_meta and q.dtype == torch.int8 and q.shape == x.shape
        assert s.is_meta and s.shape == (8,) and quantize_rows.launches == before
        return
    else:
        x = torch.zeros(4, 0)
    with pytest.raises(err):
        quantize_rows(x)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2048, 768), (6, 1000), (300, 7)])
def test_cuda_kernel_bit_equal_to_plain_version(cuda_device, shape):
    """Ties and a zero row included; any N and d (no padding of N)."""
    x = torch.from_numpy(_rows(*shape)).to(cuda_device)
    before = quantize_rows.launches
    q, s = quantize_rows(x)
    assert quantize_rows.launches == before + 1
    rq, rs_ = quantize_rows_ref(x)
    assert torch.equal(q, rq) and torch.equal(s, rs_)
    assert not q[3].any() and float(s[3]) == np.float32(1e-12)
    if shape[1] >= TIE_ROW.size:
        np.testing.assert_array_equal(q[5, :TIE_ROW.size].cpu().numpy(), TIE_Q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2048, 768), (6, 12289), (6, 4096), (300, 7)],
                         ids=["2048-768", "6-12289", "6-4096", "300-7"])
def test_cuda_both_bodies_bit_equal_in_either_type(cuda_device, dtype, shape):
    """The resident body (d 768; bf16 4096) and the strided one (d 12289,
    unaligned rows; f32 4096, too wide; d 7), ties and a zero row included:
    bit-equal to the plain version, x read in its stored type."""
    x = torch.from_numpy(_rows(*shape)).to(dtype).to(cuda_device)
    before = quantize_rows.launches
    q, s = quantize_rows(x)
    assert quantize_rows.launches == before + 1
    rq, rs_ = quantize_rows_ref(x)
    assert torch.equal(q, rq) and torch.equal(s, rs_)
    assert not q[3].any() and float(s[3]) == np.float32(1e-12)
    if shape[1] >= TIE_ROW.size:
        np.testing.assert_array_equal(q[5, :TIE_ROW.size].cpu().numpy(), TIE_Q)
