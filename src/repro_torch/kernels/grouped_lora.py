"""ctypes binding of the grouped ragged-cohort base+LoRA CUDA kernel
(``csrc/grouped_lora.cu``), with launch counters per mode.

    y_i = x_i @ w + s_i * (x_i @ a_i.T) @ b_i.T
    x (M,K) = the groups' rows concatenated, w (K,N), a (G,r,K), b (G,N,r)

x, w, a and b are all float32 or all bfloat16; y comes back in x's type,
summed in f32 either way.  Two modes, the two formulations of the
reference's Pallas kernel: ``chunk`` sweeps K through a ring of 32-deep
stages on the tensor cores (lora_matmul's bodies: 3xTF32 in fp32, bf16
mma in bf16); ``direct`` stages the whole K slab in shared memory in one
step (a SIMT body of FMA micro-tiles, in f32 for both types) and raises
above the K that shared memory holds (:func:`direct_max_k`).

x is contiguous; w is contiguous or the ``.t()`` view of a contiguous
tensor, and a and b are each contiguous or the ``.transpose(1, 2)`` view of
a contiguous tensor: the layouts the backward passes for
``dx = g @ W^T + s_i * (g @ B_i) @ A_i``.  The kernel reads them where
they are; rows whose length or stride is not a multiple of 16 bytes take
narrower copies, so no copy reads past a row.

Each block of the kernel reads its group from a tile table, one
``(group, first row, rows)`` entry per tile of :data:`BM` rows (chunk) or
:data:`DIRECT_BM` rows (direct), each group tiled on its own
(:func:`tile_table`).  The table and the scales live on the device, cached
by (group sizes, scales, tile height, device), so a launch copies nothing
from the host once the key has been seen.

A CUDA tensor launches the kernel of its type on the current stream or
raises; a CPU tensor takes the plain version
(``ref.grouped_lora_matmul_ref``).  bf16 chunk mode runs the ``wgmma``
tile fed by TMA (``csrc/bf16_wgmma_tile.cuh``) where
``lora_matmul.tma_ok`` holds for x, w and the stacked a, b, and the
``mma.sync`` tile otherwise, chosen before the launch.  The counters
``grouped_lora_chunk.launches`` and ``grouped_lora_direct.launches`` grow by
one per kernel launch of their mode, of either type, and by nothing else;
``.launches_bf16`` of each by one per bf16 launch, and
``grouped_lora_chunk.launches_wgmma`` by one per launch of the wgmma tile.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lora_matmul import tma_ok
from repro_torch.kernels.ref import grouped_lora_matmul_ref

MAX_RANK = 64          # the kernel's shared tiles hold r <= 64
BM = 128               # rows per tile in chunk mode (the tensor-core tile)
DIRECT_BM = 64         # rows per tile in direct mode (the SIMT tile)
DIRECT_BN = 64         # columns of y per direct-mode block
MAX_TILES = 65535      # tiles per launch (the grid's y extent)
MAX_SMEM = 232448      # bytes of shared memory a block may use (sm_90)
MODES = ("chunk", "direct")
# the C entry point of each operand type, and of bf16 chunk mode on the
# wgmma tile
ENTRY = {torch.float32: "grouped_lora_f32", torch.bfloat16: "grouped_lora_bf16"}
ENTRY_WGMMA = "grouped_lora_bf16_tma"

_launch = {}


def _rank_tile(r: int) -> int:
    return 16 if r <= 16 else 32 if r <= 32 else 64


def direct_max_k(r: int) -> int:
    """The largest K the direct mode takes at rank ``r``: its stage holds
    the x^T, A_g^T and W slabs, (DIRECT_BM+1 + RP+1 + DIRECT_BN) floats per
    column of K, RP the rank rounded up to 16, 32 or 64; bf16 is staged
    as f32 too, so both types take the same K."""
    return (MAX_SMEM // 4) // ((DIRECT_BM + 1) + (_rank_tile(r) + 1) + DIRECT_BN)


def _kernel(dtype: torch.dtype):
    if dtype not in _launch:
        lib = build.load("grouped_lora")
        fn = getattr(lib, ENTRY[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.grouped_lora_max_rank.argtypes = []
        lib.grouped_lora_max_rank.restype = ctypes.c_int
        lib.grouped_lora_direct_max_k.argtypes = [ctypes.c_int]
        lib.grouped_lora_direct_max_k.restype = ctypes.c_int
        if lib.grouped_lora_max_rank() != MAX_RANK or any(
                lib.grouped_lora_direct_max_k(r) != direct_max_k(r) for r in (16, 32, 64)):
            raise RuntimeError("grouped_lora library and binding disagree on "
                               "the largest rank or the direct mode's K")
        _launch[dtype] = fn
    return _launch[dtype]


def _kernel_wgmma():
    if ENTRY_WGMMA not in _launch:
        fn = getattr(build.load("grouped_lora"), ENTRY_WGMMA)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel(torch.bfloat16)         # checks the library against the binding
        _launch[ENTRY_WGMMA] = fn
    return _launch[ENTRY_WGMMA]


def tile_table(group_sizes: Sequence[int], bm: int = BM) -> List[Tuple[int, int, int]]:
    """(group, first row, rows) for every ``bm``-row tile, each group tiled
    on its own, in row order: every row lies in exactly one tile and no
    tile straddles two groups (a group's last tile may be short)."""
    out, row0 = [], 0
    for g, size in enumerate(group_sizes):
        for lo in range(0, size, bm):
            out.append((g, row0 + lo, min(bm, size - lo)))
        row0 += size
    return out


def _tile_rows(mode: str) -> int:
    return DIRECT_BM if mode == "direct" else BM


@functools.lru_cache(maxsize=64)
def _device_tables(group_sizes: Tuple[int, ...], scales: Tuple[float, ...], bm: int,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    tiles = torch.tensor(tile_table(group_sizes, bm), dtype=torch.int32).to(device)
    return tiles, torch.tensor(scales, dtype=torch.float32).to(device)


def _transposed_ok(t: torch.Tensor) -> bool:
    """Contiguous, or the transposed view of a contiguous tensor: ``.t()``
    of a matrix, ``.transpose(1, 2)`` of a stack of matrices."""
    return t.is_contiguous() or t.transpose(-2, -1).is_contiguous()


def _check(x, w, a, b, group_sizes, scales, mode) -> None:
    if mode not in MODES:
        raise KeyError(f"unknown grouped-lora mode {mode!r}; choose from {MODES}")
    if x.dim() != 2 or w.dim() != 2 or a.dim() != 3 or b.dim() != 3:
        raise ValueError("grouped_lora takes 2-D x, w and 3-D a, b")
    (m, k), (k2, n), (ga, r, k3), (gb, n2, r2) = x.shape, w.shape, a.shape, b.shape
    if not (k == k2 == k3 and n == n2 and r == r2 and ga == gb):
        raise ValueError(f"grouped_lora shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if len(group_sizes) != ga or len(scales) != ga:
        raise ValueError(f"grouped_lora needs one group size and one scale "
                         f"per adapter pair ({ga})")
    if not group_sizes or any(s < 1 for s in group_sizes) or sum(group_sizes) != m:
        raise ValueError(f"group sizes {group_sizes} must be positive and "
                         f"sum to x's {m} rows")
    if r > MAX_RANK:
        raise ValueError(f"grouped_lora supports rank <= {MAX_RANK}, got {r}")
    if mode == "direct" and k > direct_max_k(r):
        raise ValueError(f"grouped_lora direct mode holds K <= {direct_max_k(r)} "
                         f"in shared memory at rank {r}, got {k}; use mode='chunk'")
    if len(tile_table(group_sizes, _tile_rows(mode))) > MAX_TILES:
        raise ValueError(f"grouped_lora takes at most {MAX_TILES} tiles of "
                         f"{_tile_rows(mode)} rows")
    if x.dtype not in ENTRY or any(t.dtype != x.dtype for t in (w, a, b)):
        raise TypeError("grouped_lora takes x, w, a, b all float32 or all bfloat16, got "
                        + ", ".join(str(t.dtype) for t in (x, w, a, b)))
    if not x.is_contiguous() or not all(_transposed_ok(t) for t in (w, a, b)):
        raise ValueError("grouped_lora takes a contiguous x, and w, a, b each "
                         "contiguous or the transposed view of a contiguous "
                         "tensor (w.t(), a.transpose(1, 2), b.transpose(1, 2))")
    if any(t.device != x.device for t in (w, a, b)):
        raise ValueError("grouped_lora inputs must share one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_lora runs on cuda or cpu, not {x.device}")


def _run(x, w, a, b, group_sizes, scales, mode, counted) -> torch.Tensor:
    group_sizes = tuple(int(s) for s in group_sizes)
    scales = tuple(float(s) for s in scales)
    _check(x, w, a, b, group_sizes, scales, mode)
    if x.device.type == "cpu":
        return grouped_lora_matmul_ref(x, w, a, b, group_sizes, scales)
    m, k = x.shape
    n, r = b.shape[1], b.shape[2]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    tiles, scales_dev = _device_tables(group_sizes, scales, _tile_rows(mode), x.device)
    wgmma = mode == "chunk" and tma_ok(x, w, a, b)
    # w N-contiguous (row stride) or K-contiguous (column stride)
    w_kmajor = not w.is_contiguous()
    sw = w.stride(1) if w_kmajor else w.stride(0)
    ptrs = (x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), scales_dev.data_ptr(),
            tiles.data_ptr(), y.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if wgmma:
            rc = _kernel_wgmma()(*ptrs, tiles.shape[0], m, n, k, r, a.shape[0], sw,
                                 int(w_kmajor), *a.stride(), *b.stride(), stream)
        else:
            rc = _kernel(x.dtype)(*ptrs, tiles.shape[0], n, k, r, int(mode == "direct"), sw,
                                  int(w_kmajor), *a.stride(), *b.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"grouped_lora ({mode}) kernel launch failed: "
                           f"CUDA error {rc}")
    counted.launches += 1
    if x.dtype == torch.bfloat16:
        counted.launches_bf16 += 1
    if wgmma:
        counted.launches_wgmma += 1
    return y


def grouped_lora_chunk(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, *, group_sizes: Sequence[int],
                       scales: Sequence[float]) -> torch.Tensor:
    """The K-sweep mode (Pallas body ``_kernel_chunk``), 128-row tiles."""
    return _run(x, w, a, b, group_sizes, scales, "chunk", grouped_lora_chunk)


def grouped_lora_direct(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, *, group_sizes: Sequence[int],
                        scales: Sequence[float]) -> torch.Tensor:
    """The single-stage full-K mode (Pallas body ``_kernel_direct``),
    64-row tiles."""
    return _run(x, w, a, b, group_sizes, scales, "direct", grouped_lora_direct)


grouped_lora_chunk.launches = grouped_lora_chunk.launches_bf16 = 0
grouped_lora_chunk.launches_wgmma = 0
grouped_lora_direct.launches = grouped_lora_direct.launches_bf16 = 0


def grouped_lora(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, *, group_sizes: Sequence[int],
                 scales: Sequence[float], mode: str) -> torch.Tensor:
    """Either mode by name."""
    if mode not in MODES:
        raise KeyError(f"unknown grouped-lora mode {mode!r}; choose from {MODES}")
    run = grouped_lora_chunk if mode == "chunk" else grouped_lora_direct
    return run(x, w, a, b, group_sizes=group_sizes, scales=scales)
