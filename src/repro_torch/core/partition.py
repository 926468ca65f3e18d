"""Capacity-based model splitting (§III setup phase).  Copied from the JAX
package's ``core/partition.py``, rewired onto the port's cost and memory
models.

Before training, every client reports (memory, compute); the server
replicates a client-side submodel per client — the largest prefix of blocks
that fits the device's memory budget and keeps the client's per-step compute
below a latency envelope — and records the cut points.

The same feasibility arithmetic serves the reference's online control plane
(its ``control`` package, ROADMAP Queue A, item 8): when link fades or
memory pressure make the setup-phase assignment stale, the re-solver probes
candidate cuts through :func:`feasible_cut` with a precomputed
``ModelBytes`` so each probe is cheap.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import DeviceProfile, layer_fwd_flops_per_token
from repro_torch.core.memory_model import ModelBytes, client_memory


def max_cut_for_memory(cfg: ModelConfig, device: DeviceProfile, batch: int,
                       seq_len: int, mem_fraction: float = 0.5,
                       dtype_bytes: int = 4,
                       mb: Optional[ModelBytes] = None) -> int:
    """Largest N_c^u whose client-side footprint fits mem_fraction of RAM.

    Returns 0 when not even one block fits (zero-budget edge); returns
    ``cfg.n_layers`` when every block fits.  ``mb`` takes a precomputed
    :func:`repro_torch.core.memory_model.model_bytes` so repeated probes (the
    online re-solver) skip the shape tracing."""
    budget = device.mem_gb * (1024 ** 3) * mem_fraction
    best = 0
    for cut in range(1, cfg.n_layers + 1):
        if client_memory(cfg, cut, batch, seq_len, dtype_bytes, mb=mb) <= budget:
            best = cut
        else:
            break
    return best


def max_cut_for_compute(cfg: ModelConfig, device: DeviceProfile, batch: int,
                        seq_len: int, latency_budget_s: float = 30.0) -> int:
    """Largest N_c^u whose fwd+bwd stays within the latency envelope."""
    tokens = float(batch) * seq_len
    per_layer = 3.0 * tokens * layer_fwd_flops_per_token(cfg, seq_len) \
        / (device.tflops * 1e12 * device.utilization)
    if per_layer <= 0:
        return cfg.n_layers
    return max(0, min(cfg.n_layers, int(latency_budget_s / per_layer)))


def feasible_cut(cfg: ModelConfig, device: DeviceProfile, batch: int,
                 seq_len: int, *, mem_fraction: float = 0.5,
                 latency_budget_s: float = 30.0, dtype_bytes: int = 4,
                 mb: Optional[ModelBytes] = None) -> int:
    """Largest cut that is BOTH memory- and compute-feasible (unclamped;
    0 means nothing fits).  The setup-phase assignment and the online
    control-plane solver share this as their feasibility oracle."""
    return min(max_cut_for_memory(cfg, device, batch, seq_len, mem_fraction,
                                  dtype_bytes, mb=mb),
               max_cut_for_compute(cfg, device, batch, seq_len,
                                   latency_budget_s))


def cut_bounds(cfg: ModelConfig, device: DeviceProfile, batch: int,
               seq_len: int, *, min_cut: int = 1,
               max_cut: Optional[int] = None, mem_fraction: float = 0.5,
               latency_budget_s: float = 30.0, dtype_bytes: int = 4,
               mb: Optional[ModelBytes] = None) -> Tuple[int, int]:
    """Clamped ``(lo, hi)`` candidate-cut range for one device: the
    feasibility ceiling intersected with the caller's [min_cut, max_cut]
    window.  ``hi`` can equal ``lo`` (no freedom) but never undercut it —
    a device that fits nothing still trains ``min_cut`` layers, as the
    setup phase has always guaranteed."""
    max_cut = max_cut if max_cut is not None else cfg.n_layers - 1
    hi = feasible_cut(cfg, device, batch, seq_len, mem_fraction=mem_fraction,
                      latency_budget_s=latency_budget_s,
                      dtype_bytes=dtype_bytes, mb=mb)
    hi = min(max(hi, min_cut), max_cut)
    return min_cut, hi


def assign_cuts(cfg: ModelConfig, devices: Sequence[DeviceProfile], batch: int,
                seq_len: int, *, min_cut: int = 1, max_cut: int | None = None,
                mem_fraction: float = 0.5,
                latency_budget_s: float = 30.0) -> List[int]:
    """Per-device cut points: min(memory-feasible, compute-feasible), clamped."""
    cuts = []
    for dev in devices:
        _, hi = cut_bounds(cfg, dev, batch, seq_len, min_cut=min_cut,
                           max_cut=max_cut, mem_fraction=mem_fraction,
                           latency_budget_s=latency_budget_s)
        cuts.append(int(hi))
    return cuts
