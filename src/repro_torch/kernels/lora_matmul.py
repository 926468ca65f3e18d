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
raises; a CPU tensor takes the plain version (``ref.lora_matmul_ref``).
The counter ``lora_matmul.launches`` grows by one per kernel launch of
either type and by nothing else, ``lora_matmul.launches_bf16`` by one per
bf16 launch, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lora_matmul_ref

MAX_RANK = 64   # the kernel's shared tiles hold r <= 64
# the C entry point of each operand type
ENTRY = {torch.float32: "lora_matmul_f32", torch.bfloat16: "lora_matmul_bf16"}

_launch = {}


def _kernel(dtype: torch.dtype):
    if dtype not in _launch:
        lib = build.load("lora_matmul")
        fn = getattr(lib, ENTRY[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_int] + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.lora_matmul_max_rank.argtypes = []
        lib.lora_matmul_max_rank.restype = ctypes.c_int
        if lib.lora_matmul_max_rank() != MAX_RANK:
            raise RuntimeError("lora_matmul library and binding disagree on "
                               "the largest rank")
        _launch[dtype] = fn
    return _launch[dtype]


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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lora_matmul runs on cuda or cpu, not {x.device}")


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, *, scale: float) -> torch.Tensor:
    _check(x, w, a, b)
    if x.device.type == "cpu":
        return lora_matmul_ref(x, w, a, b, scale)
    m, k = x.shape
    n, r = b.shape
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    fn = _kernel(x.dtype)
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
    return y


lora_matmul.launches = 0
lora_matmul.launches_bf16 = 0
