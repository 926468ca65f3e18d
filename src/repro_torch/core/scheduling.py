"""§IV training-order scheduling.

Alg. 2 (ours): serve clients in descending N_c^u / C_u — the clients whose
*client-side backward* will take longest get their activation gradients
first, hiding client compute + downlink under the server's sequential work.

Baselines (paper §V): FIFO (by activation arrival) and Workload-First
(largest server-side workload first), plus a brute-force optimal for tests.
"""
from __future__ import annotations

import itertools
from typing import List, Sequence

from repro_torch.core.cost_model import StepTimes, makespan


def schedule_ours(n_client_layers: Sequence[int], compute: Sequence[float]) -> List[int]:
    """Alg. 2: sort u by N_c^u / C_u descending."""
    ratio = [n / c for n, c in zip(n_client_layers, compute)]
    return sorted(range(len(ratio)), key=lambda u: (-ratio[u], u))


def schedule_fifo(times: Sequence[StepTimes]) -> List[int]:
    """First-in-first-out on activation arrival time T^f + T^fc."""
    return sorted(range(len(times)), key=lambda u: (times[u].ready, u))


def schedule_workload_first(times: Sequence[StepTimes]) -> List[int]:
    """Largest server-side workload (T^s) first."""
    return sorted(range(len(times)), key=lambda u: (-times[u].t_s, u))


def schedule_bandwidth_aware(times: Sequence[StepTimes]) -> List[int]:
    """Bandwidth-aware: largest gradient-download + client-backward tail
    (T^bc + T^b) first.  Alg. 2 hides client BACKWARD under the server's
    sequential work using compute ratios only; once per-client links vary,
    the downlink is part of that same hideable tail — so order by the whole
    tail.  Offline form uses the NOMINAL t_bc; the event engines re-predict
    t_bc from the live network state at every dispatch (see
    ``fed.engine``'s net-aware "bw" discipline)."""
    return sorted(range(len(times)),
                  key=lambda u: (-(times[u].t_bc + times[u].t_b), u))


def schedule_optimal(times: Sequence[StepTimes], limit: int = 8) -> List[int]:
    """Exhaustive min-makespan (tests / small U only)."""
    n = len(times)
    if n > limit:
        raise ValueError(f"brute force capped at U={limit}")
    best, best_order = float("inf"), list(range(n))
    for perm in itertools.permutations(range(n)):
        span, _, _ = makespan(times, perm)
        if span < best - 1e-12:
            best, best_order = span, list(perm)
    return best_order


def alg2_priorities(n_client_layers: Sequence[int],
                    compute: Sequence[float]) -> List[float]:
    """Alg. 2's N_c^u / C_u as a per-client priority value — the online
    (event-engine) form of ``schedule_ours``: when the server frees, serve
    the arrived client with the largest ratio."""
    return [n / c for n, c in zip(n_client_layers, compute)]


def refresh_priorities(out: List[float], n_client_layers: Sequence[int],
                       compute: Sequence[float]) -> List[float]:
    """Recompute Alg. 2 priorities IN PLACE into ``out`` (the list object
    the FederationClock holds a reference to).  The control plane calls
    this after a cut re-assignment so the online ``priority`` discipline
    keeps ordering by the LIVE N_c^u / C_u ratios — a precomputed priority
    list would silently keep scheduling by the stale cuts."""
    out[:] = alg2_priorities(n_client_layers, compute)
    return out


SCHEDULERS = {
    "ours": None,        # needs (n_layers, compute); see resolve_order
    "fifo": schedule_fifo,
    "wf": schedule_workload_first,
    "bw": schedule_bandwidth_aware,
    "optimal": schedule_optimal,
}

# offline policy name -> (engine queue discipline, needs_priorities).
# "optimal" has no online form: its brute-force order is handed to the
# engine as a fixed ``order`` instead.
ONLINE_DISCIPLINES = {
    "ours": ("priority", True),
    "fifo": ("fifo", False),
    "wf": ("wf", False),
    "bw": ("bw", False),
}


def resolve_online(policy: str):
    """Map an offline scheduler name to its (queue discipline, needs_pri)
    pair for the event engine.  The continuous-time async engine admits ONLY
    these — a fixed precomputed order is meaningless when uploads from
    different local rounds interleave in the server queue."""
    if policy not in ONLINE_DISCIPLINES:
        raise KeyError(f"scheduler {policy!r} has no online queue-discipline "
                       f"form (choose from {sorted(ONLINE_DISCIPLINES)})")
    return ONLINE_DISCIPLINES[policy]


def resolve_order(policy: str, times: Sequence[StepTimes],
                  n_client_layers: Sequence[int],
                  compute: Sequence[float]) -> List[int]:
    if policy == "ours":
        return schedule_ours(n_client_layers, compute)
    if policy not in SCHEDULERS:
        raise KeyError(f"unknown scheduling policy {policy!r}")
    return SCHEDULERS[policy](times)
