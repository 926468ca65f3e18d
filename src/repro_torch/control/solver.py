"""Online cut / LoRA-rank / micro-batch re-solver.

The setup phase solves the assignment ONCE against nominal capability
reports (``core.partition.assign_cuts``).  This module re-solves it against
the LIVE telemetry estimates: given per-client link-rate estimates, device
profiles and memory budgets, find the per-client ``(cut, rank, batch)``
assignment minimizing the predicted round span of the Eq. 10-12 pipeline.

The objective is the closed-form cohort makespan (single sequential server,
the paper's planning model) NORMALIZED by data throughput: a candidate that
halves every batch halves the round span but also halves the samples
trained per round, so spans are scaled by ``sum(base batches) /
sum(candidate batches)`` — seconds per unit of training data, a
time-to-target proxy.  Cut moves leave throughput unchanged; batch moves
only win where they relieve a genuine wireless bottleneck.

The search is deterministic coordinate descent over the ADJUSTABLE clients
(the control plane only migrates clients standing at a commit boundary):
cut +/-1 plus any caller-allowed rank/batch candidates, sweeping until no
single-client move improves the normalized span.  Memory infeasibility is
repaired first (a client under memory pressure sheds layers even when that
worsens the span — headroom is a hard constraint, speed is not).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import (DeviceProfile, LinkProfile, StepTimes,
                                         client_step_times, makespan)
from repro_torch.core.memory_model import ModelBytes, client_memory
from repro_torch.core.scheduling import resolve_order

__all__ = ["Assignment", "predicted_span", "predicted_times",
           "solve_assignment"]


@dataclasses.dataclass(frozen=True)
class Assignment:
    """Per-client control-plane decision variables."""
    cuts: Tuple[int, ...]
    ranks: Tuple[int, ...]
    batches: Tuple[int, ...]

    def __post_init__(self):
        if not (len(self.cuts) == len(self.ranks) == len(self.batches)):
            raise ValueError("cuts, ranks and batches must align per client")
        if any(c < 0 for c in self.cuts) or any(r < 1 for r in self.ranks) \
                or any(b < 1 for b in self.batches):
            raise ValueError("cuts must be >= 0; ranks and batches >= 1")

    @classmethod
    def uniform(cls, cuts: Sequence[int], rank: int, batch: int) -> "Assignment":
        n = len(cuts)
        return cls(tuple(int(c) for c in cuts), (int(rank),) * n,
                   (int(batch),) * n)

    def replace_client(self, u: int, *, cut: Optional[int] = None,
                       rank: Optional[int] = None,
                       batch: Optional[int] = None) -> "Assignment":
        cuts, ranks, batches = list(self.cuts), list(self.ranks), list(self.batches)
        if cut is not None:
            cuts[u] = int(cut)
        if rank is not None:
            ranks[u] = int(rank)
        if batch is not None:
            batches[u] = int(batch)
        return Assignment(tuple(cuts), tuple(ranks), tuple(batches))


def predicted_times(cfg: ModelConfig, devices: Sequence[DeviceProfile],
                    server: DeviceProfile, rates_mbps: Sequence[float],
                    asg: Assignment, seq_len: int,
                    dtype_bytes: Optional[int] = None) -> List[StepTimes]:
    """Eq. 10 terms for every client under ``asg`` at the LIVE rate
    estimates (the planning view the re-solver optimizes against)."""
    return [client_step_times(cfg, asg.cuts[u], devices[u], server,
                              LinkProfile(rates_mbps[u]), asg.batches[u],
                              seq_len, dtype_bytes=dtype_bytes,
                              lora_rank=asg.ranks[u])
            for u in range(len(devices))]


def predicted_span(cfg: ModelConfig, devices: Sequence[DeviceProfile],
                   server: DeviceProfile, rates_mbps: Sequence[float],
                   asg: Assignment, seq_len: int, *,
                   scheduler: str = "ours",
                   ref_samples: Optional[float] = None,
                   dtype_bytes: Optional[int] = None) -> float:
    """Throughput-normalized predicted round span of ``asg``.

    ``ref_samples`` anchors the normalization (defaults to the candidate's
    own batch total, i.e. no normalization) — the solver passes the BASE
    assignment's total so shrunken batches pay their throughput loss."""
    times = predicted_times(cfg, devices, server, rates_mbps, asg, seq_len,
                            dtype_bytes)
    order = resolve_order(scheduler, times, asg.cuts,
                          [d.tflops for d in devices])
    span, _, _ = makespan(times, order)
    samples = float(sum(asg.batches))
    ref = samples if ref_samples is None else float(ref_samples)
    return span * (ref / samples)


def solve_assignment(cfg: ModelConfig, devices: Sequence[DeviceProfile],
                     server: DeviceProfile, rates_mbps: Sequence[float],
                     base: Assignment, seq_len: int, *,
                     adjustable: Optional[Sequence[int]] = None,
                     min_cut: int = 1, max_cut: Optional[int] = None,
                     mem_budget_bytes: Optional[Sequence[float]] = None,
                     mb: Optional[ModelBytes] = None, dtype_bytes: int = 4,
                     scheduler: str = "ours",
                     rank_candidates: Optional[Sequence[int]] = None,
                     batch_candidates: Optional[Sequence[int]] = None,
                     max_sweeps: int = 4) -> Tuple[Assignment, float]:
    """Coordinate-descent re-solve; returns ``(assignment, predicted_span)``.

    Only clients in ``adjustable`` move (default: all).  ``rank_candidates``
    / ``batch_candidates`` open those knobs (closed by default — rank moves
    trade adapter capacity and batch moves trade per-round data, neither of
    which the span model fully captures, so the caller opts in)."""
    n = len(devices)
    if len(rates_mbps) != n or len(base.cuts) != n:
        raise ValueError("devices, rates and assignment must align")
    max_cut = cfg.n_layers - 1 if max_cut is None else int(max_cut)
    if not 1 <= min_cut <= max_cut:
        raise ValueError("need 1 <= min_cut <= max_cut")
    adjustable = list(range(n)) if adjustable is None else sorted(set(adjustable))
    ref_samples = float(sum(base.batches))

    def feasible(u: int, cut: int, batch: int) -> bool:
        if not min_cut <= cut <= max_cut:
            return False
        if mem_budget_bytes is None:
            return True
        need = client_memory(cfg, cut, batch, seq_len, dtype_bytes, mb=mb)
        return need <= mem_budget_bytes[u]

    # coordinate descent moves ONE client per candidate — memoize the
    # per-client Eq. 10 terms so the other n-1 entries are never rebuilt
    tfl = [d.tflops for d in devices]
    cache: Dict[Tuple[int, int, int, int], StepTimes] = {}

    def span_of(asg: Assignment) -> float:
        times = []
        for u in range(n):
            key = (u, asg.cuts[u], asg.ranks[u], asg.batches[u])
            st = cache.get(key)
            if st is None:
                st = client_step_times(cfg, asg.cuts[u], devices[u], server,
                                       LinkProfile(rates_mbps[u]),
                                       asg.batches[u], seq_len,
                                       lora_rank=asg.ranks[u])
                cache[key] = st
            times.append(st)
        order = resolve_order(scheduler, times, asg.cuts, tfl)
        span, _, _ = makespan(times, order)
        return span * (ref_samples / float(sum(asg.batches)))

    # 1. repair memory infeasibility (hard constraint, span notwithstanding):
    # shed layers down to min_cut; a client infeasible even at min_cut keeps
    # min_cut — the setup-phase floor guarantee.
    cur = base
    for u in adjustable:
        while cur.cuts[u] > min_cut and not feasible(u, cur.cuts[u],
                                                    cur.batches[u]):
            cur = cur.replace_client(u, cut=cur.cuts[u] - 1)

    # 2. deterministic coordinate descent on the normalized span
    cur_span = span_of(cur)
    for _ in range(max_sweeps):
        improved = False
        for u in adjustable:
            candidates: List[Assignment] = []
            for dc in (-1, +1):
                c = cur.cuts[u] + dc
                if feasible(u, c, cur.batches[u]):
                    candidates.append(cur.replace_client(u, cut=c))
            for r in rank_candidates or ():
                if int(r) >= 1 and int(r) != cur.ranks[u]:
                    candidates.append(cur.replace_client(u, rank=int(r)))
            for b in batch_candidates or ():
                if int(b) >= 1 and int(b) != cur.batches[u] \
                        and feasible(u, cur.cuts[u], int(b)):
                    candidates.append(cur.replace_client(u, batch=int(b)))
            best, best_span = None, cur_span
            for cand in candidates:
                s = span_of(cand)
                if s < best_span - 1e-12:
                    best, best_span = cand, s
            if best is not None:
                cur, cur_span, improved = best, best_span, True
        if not improved:
            break
    return cur, cur_span
