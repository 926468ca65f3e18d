"""ctypes binding of the grouped ragged-cohort base+LoRA CUDA kernel
(``csrc/grouped_lora.cu``), with launch counters per mode.

    y_i = x_i @ w + s_i * (x_i @ a_i.T) @ b_i.T
    x (M,K) = the groups' rows concatenated, w (K,N), a (G,r,K), b (G,N,r)

x, w, a and b are all float32 or all bfloat16; y comes back in x's type,
summed in f32 either way.  Two modes, the two formulations of the
reference's Pallas kernel, both on the tensor cores: ``chunk`` sweeps K
through a ring of stages (lora_matmul's tiles: 3xTF32 mma.sync in fp32;
in bf16 the wgmma tile fed by TMA, or the mma.sync tile for operands TMA
cannot describe); ``direct`` runs a resident tile that holds the whole K
slab (:func:`direct_resident`: K <= :data:`DIRECT_MAX_K`, and in bf16
operands TMA can describe) and otherwise the chunk tiles' K sweep, so it
takes every K, as the reference's direct mode does.  The resident tiles:
fp32, the 3xTF32 tile with the slab staged in one step; bf16, a wgmma tile
that keeps a row tile's x slab and its x @ A_g^T split in place while it
streams W tiles and writes y by TMA stores.

x is contiguous; w is contiguous or the ``.t()`` view of a contiguous
tensor, and a and b are each contiguous or the ``.transpose(1, 2)`` view of
a contiguous tensor: the layouts the backward passes for
``dx = g @ W^T + s_i * (g @ B_i) @ A_i``.  The kernel reads them where
they are; rows whose length or stride is not a multiple of 16 bytes take
narrower copies, so no copy reads past a row.

Each block of the kernel reads its group from a tile table, one
``(group, first row, rows)`` entry per tile of :data:`BM` rows, in either
mode, each group tiled on its own (:func:`tile_table`).  The table and the
scales live on the device, cached by (group sizes, scales, device), so a
launch copies nothing from the host once the key has been seen.

A CUDA tensor launches the kernel of its type on the current stream or
raises; a CPU or ``meta`` tensor takes the plain version
(``ref.grouped_lora_matmul_ref``), which a trace on ``meta`` counts as the
kernel's work (``work.py``).  The body is chosen before the launch.
The counters ``grouped_lora_chunk.launches`` and
``grouped_lora_direct.launches`` grow by one per kernel launch of their
mode, of either type and body, and by nothing else; ``.launches_bf16`` of
each by one per bf16 launch, ``grouped_lora_chunk.launches_wgmma`` by one
per launch of the wgmma tile (``lora_matmul.tma_ok``), and
``grouped_lora_direct.launches_swept`` by one per direct-mode launch that
ran the K sweep instead of a resident tile.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.lora_matmul import tma_ok
from repro_torch.kernels.ref import grouped_lora_matmul_ref

MAX_RANK = 64          # the kernel's shared tiles hold r <= 64
BM = 128               # rows per tile of the tile table (the tensor-core tile height)
DIRECT_MAX_K = 128     # the K slab a resident direct-mode tile holds
MAX_TILES = 65535      # tiles per launch (the grid's y extent)
MODES = ("chunk", "direct")
# the C entry point of each operand type, and of bf16 on the wgmma tiles
ENTRY = {torch.float32: "grouped_lora_f32", torch.bfloat16: "grouped_lora_bf16"}
ENTRY_WGMMA = "grouped_lora_bf16_tma"

_launch = {}


def _kernel(dtype: torch.dtype):
    if dtype not in _launch:
        lib = build.load("grouped_lora")
        fn = getattr(lib, ENTRY[dtype])
        # the f32 entry takes ``direct`` after r; the bf16 (mma.sync) one sweeps K only
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_int] * (dtype == torch.float32)
                       + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for name in ("grouped_lora_max_rank", "grouped_lora_resident_max_k"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        if (lib.grouped_lora_max_rank() != MAX_RANK
                or lib.grouped_lora_resident_max_k() != DIRECT_MAX_K):
            raise RuntimeError("grouped_lora library and binding disagree on "
                               "the largest rank or the resident direct tile's K")
        _launch[dtype] = fn
    return _launch[dtype]


def _kernel_wgmma():
    if ENTRY_WGMMA not in _launch:
        fn = getattr(build.load("grouped_lora"), ENTRY_WGMMA)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel(torch.bfloat16)         # checks the library against the binding
        _launch[ENTRY_WGMMA] = fn
    return _launch[ENTRY_WGMMA]


def direct_resident(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> bool:
    """Whether a direct-mode call runs a resident tile: K within
    :data:`DIRECT_MAX_K`, and in bf16 operands TMA can describe
    (``lora_matmul.tma_ok``).  Otherwise it runs the chunk tiles' K sweep
    (counted on ``grouped_lora_direct.launches_swept``).  A pure function of
    shapes, types, strides and pointers."""
    return x.shape[1] <= DIRECT_MAX_K and (x.dtype == torch.float32 or tma_ok(x, w, a, b))


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


@functools.lru_cache(maxsize=64)
def _device_tables(group_sizes: Tuple[int, ...], scales: Tuple[float, ...],
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    tiles = torch.tensor(tile_table(group_sizes), dtype=torch.int32).to(device)
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
    if len(tile_table(group_sizes)) > MAX_TILES:
        raise ValueError(f"grouped_lora takes at most {MAX_TILES} tiles of {BM} rows")
    if x.dtype not in ENTRY or any(t.dtype != x.dtype for t in (w, a, b)):
        raise TypeError("grouped_lora takes x, w, a, b all float32 or all bfloat16, got "
                        + ", ".join(str(t.dtype) for t in (x, w, a, b)))
    if not x.is_contiguous() or not all(_transposed_ok(t) for t in (w, a, b)):
        raise ValueError("grouped_lora takes a contiguous x, and w, a, b each "
                         "contiguous or the transposed view of a contiguous "
                         "tensor (w.t(), a.transpose(1, 2), b.transpose(1, 2))")
    if any(t.device != x.device for t in (w, a, b)):
        raise ValueError("grouped_lora inputs must share one device")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"grouped_lora runs on cuda, cpu or meta, not {x.device}")


def _run(x, w, a, b, group_sizes, scales, mode, counted) -> torch.Tensor:
    group_sizes = tuple(int(s) for s in group_sizes)
    scales = tuple(float(s) for s in scales)
    _check(x, w, a, b, group_sizes, scales, mode)
    if x.device.type in ("cpu", "meta"):          # the plain version: no launch
        with work.counted(*work.lora_matmul(x, w, a, b)):
            return grouped_lora_matmul_ref(x, w, a, b, group_sizes, scales)
    m, k = x.shape
    n, r = b.shape[1], b.shape[2]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    tiles, scales_dev = _device_tables(group_sizes, scales, x.device)
    wgmma = tma_ok(x, w, a, b)
    resident = mode == "direct" and direct_resident(x, w, a, b)
    # w N-contiguous (row stride) or K-contiguous (column stride)
    w_kmajor = not w.is_contiguous()
    sw = w.stride(1) if w_kmajor else w.stride(0)
    ptrs = (x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), scales_dev.data_ptr(),
            tiles.data_ptr(), y.data_ptr())
    strides = (*a.stride(), *b.stride())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if wgmma:
            rc = _kernel_wgmma()(*ptrs, tiles.shape[0], m, n, k, r, a.shape[0], int(resident),
                                 sw, int(w_kmajor), *strides, stream)
        elif x.dtype == torch.bfloat16:
            rc = _kernel(x.dtype)(*ptrs, tiles.shape[0], n, k, r, sw, int(w_kmajor), *strides,
                                  stream)
        else:
            rc = _kernel(x.dtype)(*ptrs, tiles.shape[0], n, k, r, int(resident), sw,
                                  int(w_kmajor), *strides, stream)
    if rc != 0:
        raise RuntimeError(f"grouped_lora ({mode}) kernel launch failed: "
                           f"CUDA error {rc}")
    counted.launches += 1
    if x.dtype == torch.bfloat16:
        counted.launches_bf16 += 1
    if mode == "chunk" and wgmma:
        counted.launches_wgmma += 1
    if mode == "direct" and not resident:
        counted.launches_swept += 1
    return y


def grouped_lora_chunk(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, *, group_sizes: Sequence[int],
                       scales: Sequence[float]) -> torch.Tensor:
    """The K-sweep mode (Pallas body ``_kernel_chunk``)."""
    return _run(x, w, a, b, group_sizes, scales, "chunk", grouped_lora_chunk)


def grouped_lora_direct(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, *, group_sizes: Sequence[int],
                        scales: Sequence[float]) -> torch.Tensor:
    """The single full-K pass (Pallas body ``_kernel_direct``): a resident
    tile where :func:`direct_resident` holds, else the K sweep; any K."""
    return _run(x, w, a, b, group_sizes, scales, "direct", grouped_lora_direct)


grouped_lora_chunk.launches = grouped_lora_chunk.launches_bf16 = 0
grouped_lora_chunk.launches_wgmma = 0
grouped_lora_direct.launches = grouped_lora_direct.launches_bf16 = 0
grouped_lora_direct.launches_swept = 0


def grouped_lora(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, *, group_sizes: Sequence[int],
                 scales: Sequence[float], mode: str) -> torch.Tensor:
    """Either mode by name."""
    if mode not in MODES:
        raise KeyError(f"unknown grouped-lora mode {mode!r}; choose from {MODES}")
    run = grouped_lora_chunk if mode == "chunk" else grouped_lora_direct
    return run(x, w, a, b, group_sizes=group_sizes, scales=scales)
