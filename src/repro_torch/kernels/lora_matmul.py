"""ctypes binding of the fused base+LoRA CUDA kernel
(``csrc/lora_matmul.cu``), with its launch counters.

    y = x @ w + scale * (x @ a.T) @ b.T     x (M,K) w (K,N) a (r,K) b (N,r)

x, w, a and b are all float32 (3xTF32 tensor-core tiles,
``lora_matmul_f32``) or all bfloat16 (bf16 tensor-core tiles,
``lora_matmul_bf16``); y comes back in x's type, summed in f32 either way.
x is contiguous; w, a and b are each contiguous or the transposed view of
a contiguous tensor (``t.t()``), the layouts the backward passes for
``dx = g @ W^T + s * (g @ B) @ A``; the kernel reads them where they are.
A CUDA tensor launches the kernel of its type on the current stream or
raises; a CPU or ``meta`` tensor takes the plain version
(``ref.lora_matmul_ref``), which a trace on ``meta`` counts as the
kernel's work (``work.py``).

bf16 has two tiles, chosen before the launch by :func:`tma_ok`, a function
of the operands' shapes, strides and pointers alone: where TMA can
describe x and W (16-byte aligned bases, K and W's stride multiples of 8
elements) and A is K-contiguous or its ranks are contiguous in 16-byte
runs, the ``wgmma`` tile fed by TMA (``csrc/bf16_wgmma_tile.cuh``,
entry ``lora_matmul_bf16_tma``); otherwise (K 130, N 770, an unaligned
slice, the B^T view at r 5) the ``mma.sync`` tile
(``csrc/bf16_lora_tile.cuh``, entry ``lora_matmul_bf16``).

The counter ``lora_matmul.launches`` grows by one per kernel launch of
either type and by nothing else, ``lora_matmul.launches_bf16`` by one per
bf16 launch and ``lora_matmul.launches_wgmma`` by one per launch of the
wgmma tile, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.ref import lora_matmul_ref

MAX_RANK = 64   # the kernel's shared tiles hold r <= 64
# the C entry point of each operand type, and of bf16 on the wgmma tile
ENTRY = {torch.float32: "lora_matmul_f32", torch.bfloat16: "lora_matmul_bf16"}
ENTRY_WGMMA = "lora_matmul_bf16_tma"

_launch = {}


def a_mode(a: torch.Tensor) -> int:
    """How the wgmma tile loads A (r, K), or each A_g of a (G, r, K) stack:
    0 by TMA (K-contiguous, 16-byte aligned rows), 1 by its producer's
    16-byte loads along r (the ranks contiguous, r a multiple of 8: the
    backward's B^T view), -1 neither.  ``bf16_wgmma_tile.cuh: a_mode`` is
    the same test."""
    r = a.shape[-2]
    saj, sak = a.stride(-2), a.stride(-1)
    sag = a.stride(0) if a.dim() == 3 else 0
    if r < 1 or a.data_ptr() % 16 or sag % 8:
        return -1
    if sak == 1 and saj % 8 == 0:
        return 0
    if saj == 1 and sak % 8 == 0 and r % 8 == 0:
        return 1
    return -1


def tma_ok(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a bf16 call takes the wgmma tile: TMA describes x (K a
    positive multiple of 8, 16-byte aligned) and W (16-byte aligned, its
    row or column stride a multiple of 8) and :func:`a_mode` loads A.  B
    is read by ordinary loads at any strides.  Takes the 2-D operands of
    :func:`lora_matmul` or the 3-D adapters of ``grouped_lora``; a pure
    function of shapes, strides and pointers (``bf16_wgmma_tile.cuh:
    wgmma_ok`` is the same test, and the entry point refuses the rest)."""
    k = x.shape[1]
    sw = w.stride(0) if w.is_contiguous() else w.stride(1)
    return (x.dtype == torch.bfloat16 and k > 0 and k % 8 == 0 and x.stride(0) % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 and sw % 8 == 0
            and a_mode(a) >= 0)


def _kernel(dtype: torch.dtype, wgmma: bool = False):
    key = (dtype, wgmma)
    if key not in _launch:
        lib = build.load("lora_matmul")
        fn = getattr(lib, ENTRY_WGMMA if wgmma else ENTRY[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_int] + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.lora_matmul_max_rank.argtypes = []
        lib.lora_matmul_max_rank.restype = ctypes.c_int
        if lib.lora_matmul_max_rank() != MAX_RANK:
            raise RuntimeError("lora_matmul library and binding disagree on "
                               "the largest rank")
        _launch[key] = fn
    return _launch[key]


def _transposed_ok(t: torch.Tensor) -> bool:
    return t.is_contiguous() or t.t().is_contiguous()


def _check(x, w, a, b) -> None:
    ts = (x, w, a, b)
    if any(t.dim() != 2 for t in ts):
        raise ValueError("lora_matmul takes 2-D x, w, a, b")
    (m, k), (k2, n), (r, k3), (n2, r2) = (t.shape for t in ts)
    if not (k == k2 == k3 and n == n2 and r == r2):
        raise ValueError(f"lora_matmul shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if r > MAX_RANK:
        raise ValueError(f"lora_matmul supports rank <= {MAX_RANK}, got {r}")
    if x.dtype not in ENTRY or any(t.dtype != x.dtype for t in ts):
        raise TypeError("lora_matmul takes x, w, a, b all float32 or all bfloat16, got "
                        + ", ".join(str(t.dtype) for t in ts))
    if not x.is_contiguous() or not all(_transposed_ok(t) for t in (w, a, b)):
        raise ValueError("lora_matmul takes a contiguous x, and w, a, b each "
                         "contiguous or the .t() view of a contiguous tensor")
    if any(t.device != x.device for t in ts):
        raise ValueError("lora_matmul inputs must share one device")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"lora_matmul runs on cuda, cpu or meta, not {x.device}")


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, *, scale: float) -> torch.Tensor:
    _check(x, w, a, b)
    if x.device.type in ("cpu", "meta"):          # the plain version: no launch
        with work.counted(*work.lora_matmul(x, w, a, b)):
            return lora_matmul_ref(x, w, a, b, scale)
    m, k = x.shape
    n, r = b.shape
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    wgmma = tma_ok(x, w, a, b)
    fn = _kernel(x.dtype, wgmma)
    # w N-contiguous (row stride) or K-contiguous (column stride)
    w_kmajor = not w.is_contiguous()
    sw = w.stride(1) if w_kmajor else w.stride(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                y.data_ptr(), m, n, k, r, float(scale), x.stride(0), sw,
                int(w_kmajor), *a.stride(), *b.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"lora_matmul kernel launch failed: CUDA error {rc}")
    lora_matmul.launches += 1
    if x.dtype == torch.bfloat16:
        lora_matmul.launches_bf16 += 1
    if wgmma:
        lora_matmul.launches_wgmma += 1
    return y


lora_matmul.launches = 0
lora_matmul.launches_bf16 = 0
lora_matmul.launches_wgmma = 0
