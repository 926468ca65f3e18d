"""Population-scale fleets: struct-of-arrays state + a vectorized round
kernel that advances whole cohorts per iteration.

The per-object DES (``fed.engine.simulate_round``) re-sorts a live Python
queue at every dispatch — O(n^2 log n) for an n-client barrier wave — and
walks one heap event at a time over per-client ``DeviceProfile`` /
``LinkModel`` objects.  Fine for the paper's six phones; hopeless for the
ROADMAP's 10^5-client fleets.  This module is the scale path:

``PopulationFleet``    struct-of-arrays fleet state: numpy arrays for
                       compute (tflops/utilization), memory budgets,
                       cuts, capability ranks, and nominal link rates —
                       no per-client objects.
``step_time_arrays``   vectorized Eq. 10 phase model: elementwise
                       float64 arithmetic in the SAME expression shapes
                       as ``cost_model.client_step_times``, so every
                       produced float is bit-identical to the scalar
                       path (pinned by tests).
``vectorized_round``   the hot path: computes every uplink-ready instant
                       in one array pass (one lexsort replaces the
                       per-dispatch queue sorts), then replays the DES
                       dispatch recurrence — which MUST stay a scalar
                       loop, because bit-exactness is the regression
                       anchor and ``max``/``+`` chains are order-
                       sensitive — and resolves all downlinks/completions
                       in one more array pass.  Serves any FIXED order
                       and every online discipline: "fifo"/"wf"/
                       "priority" (and "bw" off-plane) have STATIC
                       per-job keys and ride a lazily-fed key heap;
                       "bw" under a live plane re-keys the still-queued
                       set as arrays at each dispatch boundary (one
                       batched rate query + masked lexsort per fill).
``sample_cohort``      per-round cohort sampling: "full" enumeration,
                       legacy "uniform", or Pareto-biased selection over
                       capability ranks (Jung et al. 2024) so a
                       population fleet serves bounded cohorts.
``PopulationClock``    multi-round sync federation loop over a
                       PopulationFleet: vectorized rounds at/above
                       ``fleet.population_threshold``, the EXACT
                       per-object DES below it (bit-equal timelines —
                       the parity grid in tests/test_population.py), and
                       closed-form flat or two-tier hierarchical commit
                       charges shared by both modes.

Async aggregation policies (buffered / staleness) pace every client
individually, so their event loop lives in continuous time rather than
per-round waves: below ``population_threshold`` the per-object
``FederationClock`` runs it; at/above, the struct-of-arrays async kernel
in ``fed.population_async`` replays the identical event sequence over
``JobArrays`` (the per-object clock stays on as the parity oracle).

Copied from the JAX package's ``fed/population.py`` with its imports pointed into
the port; ``tests/test_torch_copies.py`` pins it bit for bit.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import (BWD_FACTOR, DeviceProfile, StepTimes,
                                   activation_bytes, chunked_service_time,
                                   head_fwd_flops_per_token,
                                   layer_fwd_flops_per_token,
                                   lora_flops_per_token_per_layer,
                                   lora_upload_bytes)
from repro_torch.core.scheduling import alg2_priorities, resolve_online
from repro_torch.fed.config import FedRunConfig
from repro_torch.fed.engine import (DISCIPLINES, ClockConfig, EngineResult,
                              FederationClock, Job, ServiceRecord,
                              simulate_round)
from repro_torch.net import ConstantLink, NetworkPlane, shared_finish_times
from repro_torch.net.topology import EdgeTopology, edge_commit_legs
from repro_torch.obs import Observability, record_round_arrays, record_sync_wave

__all__ = ["JobArrays", "PopulationClock", "PopulationFleet",
           "PopulationResult", "pareto_weights", "sample_cohort",
           "step_time_arrays", "vectorized_round"]


# ===========================================================================
# Struct-of-arrays fleet state
# ===========================================================================

@dataclasses.dataclass
class PopulationFleet:
    """One fleet as parallel numpy arrays (index = uid).  Built by
    ``FleetSpec.population()``; holds the same fleet ``FleetSpec.devices()``
    would materialize as objects."""
    tflops: np.ndarray          # per-client compute (TFLOPS)
    utilization: np.ndarray     # achieved fraction of peak
    mem_gb: np.ndarray          # memory budgets (GB)
    cuts: np.ndarray            # client-side layer counts (int)
    rate_mbps: np.ndarray       # nominal link rates
    coords: Optional[np.ndarray] = None   # (n, d) positions (cell k-means)

    def __post_init__(self):
        self.tflops = np.asarray(self.tflops, dtype=np.float64)
        self.utilization = np.asarray(self.utilization, dtype=np.float64)
        self.mem_gb = np.asarray(self.mem_gb, dtype=np.float64)
        self.cuts = np.asarray(self.cuts, dtype=np.int64)
        self.rate_mbps = np.asarray(self.rate_mbps, dtype=np.float64)
        n = self.tflops.shape[0]
        for a in (self.utilization, self.mem_gb, self.cuts, self.rate_mbps):
            if a.shape != (n,):
                raise ValueError("all fleet arrays must share one length")
        if n < 1:
            raise ValueError("fleet size must be >= 1")
        if self.coords is not None:
            self.coords = np.asarray(self.coords, dtype=np.float64)
            if self.coords.ndim != 2 or self.coords.shape[0] != n:
                raise ValueError("coords must be an (n, d) array")
        self._ranks: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return int(self.tflops.shape[0])

    def capability_ranks(self) -> np.ndarray:
        """Rank 0 = most capable (highest TFLOPS, uid tiebreak) — the
        Pareto sampler's rank variable."""
        if self._ranks is None:
            order = np.lexsort((np.arange(self.n), -self.tflops))
            ranks = np.empty(self.n, dtype=np.int64)
            ranks[order] = np.arange(self.n)
            self._ranks = ranks
        return self._ranks

    def links(self, uids: Optional[Sequence[int]] = None
              ) -> List[ConstantLink]:
        """Materialize per-object constant links — the whole fleet, or
        lazily just the ``uids`` cohort (O(cohort), not O(n))."""
        sel = range(self.n) if uids is None else uids
        return [ConstantLink(float(self.rate_mbps[int(u)])) for u in sel]

    def devices(self, uids: Optional[Sequence[int]] = None
                ) -> List[DeviceProfile]:
        """Materialize per-object device profiles — the whole fleet, or
        lazily just the ``uids`` cohort (O(cohort), not O(n))."""
        sel = range(self.n) if uids is None else uids
        return [DeviceProfile(f"pop#{int(u)}",
                              tflops=float(self.tflops[int(u)]),
                              mem_gb=float(self.mem_gb[int(u)]),
                              utilization=float(self.utilization[int(u)]))
                for u in sel]


def step_time_arrays(cfg: ModelConfig, fleet: PopulationFleet,
                     server: DeviceProfile, batch: int, seq_len: int,
                     dtype_bytes: Optional[int] = None,
                     lora_rank: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
    """Vectorized ``cost_model.client_step_times`` over the whole fleet.

    Every expression keeps the scalar path's operand grouping, so each
    array element is bit-identical to the ``StepTimes`` the per-object
    path would compute for that client (IEEE-754 elementwise ops) —
    which is what lets the vectorized round reproduce the DES timeline
    exactly.  ``t_fc``/``t_bc`` price the activation payload at each
    client's own nominal rate (``fleet.rate_mbps``)."""
    tokens = float(batch) * seq_len
    lf = layer_fwd_flops_per_token(cfg, seq_len) \
        + lora_flops_per_token_per_layer(cfg, rank=lora_rank)
    n_total = cfg.n_layers + cfg.n_encoder_layers \
        if cfg.family == "encdec" else cfg.n_layers
    n_server = n_total - fleet.cuts
    c_flops = tokens * (lf * fleet.cuts)
    s_flops = tokens * (lf * n_server + head_fwd_flops_per_token(cfg))
    act = activation_bytes(cfg, batch, seq_len, dtype_bytes)
    t_f = c_flops / (fleet.tflops * 1e12 * fleet.utilization)
    t_s = (1.0 + BWD_FACTOR) * s_flops \
        / (server.tflops * 1e12 * server.utilization)
    t_x = act * 8.0 / (fleet.rate_mbps * 1e6)   # LinkProfile.transfer_s
    n = fleet.n
    return {"t_f": t_f, "t_fc": t_x.copy(), "t_s": t_s, "t_bc": t_x.copy(),
            "t_b": BWD_FACTOR * t_f,
            "fc_bytes": np.full(n, act), "bc_bytes": np.full(n, act)}


# ===========================================================================
# Cohort sampling (participation as a POLICY)
# ===========================================================================

def pareto_weights(ranks: np.ndarray, alpha: float) -> np.ndarray:
    """Rank-Pareto selection weights ``(rank + 1)^-alpha`` (Jung et al.
    2024): capability rank 0 is the most likely pick, the tail stays
    reachable."""
    if alpha <= 0:
        raise ValueError("pareto_alpha must be > 0")
    return (np.asarray(ranks, dtype=np.float64) + 1.0) ** (-float(alpha))


def sample_cohort(rng: np.random.Generator, n: int, sampling: str,
                  rate: float, *, ranks: Optional[np.ndarray] = None,
                  pareto_alpha: float = 1.16) -> List[int]:
    """Sample one round's cohort of uids (sorted).

    "full" enumerates every client and consumes NO rng draws; "uniform"
    reproduces the legacy participation fraction draw-for-draw (same
    ``rng.choice`` call, same cohort for a given rng state); "pareto"
    draws the same cohort size with rank-Pareto weights."""
    if sampling == "full":
        return list(range(n))
    k = max(1, int(round(rate * n)))
    if sampling == "uniform":
        return sorted(rng.choice(n, size=k, replace=False).tolist())
    if sampling == "pareto":
        if ranks is None:
            raise ValueError("pareto sampling needs capability ranks")
        w = pareto_weights(ranks, pareto_alpha)
        return sorted(rng.choice(n, size=k, replace=False,
                                 p=w / w.sum()).tolist())
    raise KeyError(f"unknown sampling policy {sampling!r}")


# ===========================================================================
# Vectorized round kernel
# ===========================================================================

@dataclasses.dataclass
class JobArrays:
    """One round's jobs as parallel arrays — the SoA form of a
    ``List[Job]`` (same fields, same semantics)."""
    uids: np.ndarray
    t_f: np.ndarray
    t_fc: np.ndarray
    t_s: np.ndarray
    t_bc: np.ndarray
    t_b: np.ndarray
    arrival: np.ndarray
    fc_bytes: np.ndarray
    bc_bytes: np.ndarray
    priority: Optional[np.ndarray] = None   # Job.priority (zeros when unset)

    def __post_init__(self):
        self.uids = np.asarray(self.uids, dtype=np.int64)
        n = self.uids.shape[0]
        if self.priority is None:
            self.priority = np.zeros(n)
        for f in ("t_f", "t_fc", "t_s", "t_bc", "t_b", "arrival",
                  "fc_bytes", "bc_bytes", "priority"):
            a = np.asarray(getattr(self, f), dtype=np.float64)
            if a.shape != (n,):
                raise ValueError("all job arrays must share one length")
            setattr(self, f, a)

    @property
    def n(self) -> int:
        return int(self.uids.shape[0])

    @classmethod
    def from_jobs(cls, jobs: Sequence[Job]) -> "JobArrays":
        return cls(uids=[j.uid for j in jobs], t_f=[j.t_f for j in jobs],
                   t_fc=[j.t_fc for j in jobs], t_s=[j.t_s for j in jobs],
                   t_bc=[j.t_bc for j in jobs], t_b=[j.t_b for j in jobs],
                   arrival=[j.arrival for j in jobs],
                   fc_bytes=[j.fc_bytes for j in jobs],
                   bc_bytes=[j.bc_bytes for j in jobs],
                   priority=[j.priority for j in jobs])

    def to_jobs(self, indices: Optional[Sequence[int]] = None) -> List[Job]:
        """Materialize per-object jobs (the DES fallback's input) — all of
        them, or lazily just the ``indices`` rows (per-cohort
        materialization: callers dispatching a cohort slice build only
        that slice's objects)."""
        rows = range(self.n) if indices is None \
            else [int(i) for i in indices]
        return [Job(uid=int(self.uids[i]), t_f=float(self.t_f[i]),
                    t_fc=float(self.t_fc[i]), t_s=float(self.t_s[i]),
                    t_bc=float(self.t_bc[i]), t_b=float(self.t_b[i]),
                    arrival=float(self.arrival[i]),
                    priority=float(self.priority[i]),
                    fc_bytes=float(self.fc_bytes[i]),
                    bc_bytes=float(self.bc_bytes[i]))
                for i in rows]

    def take(self, indices: Sequence[int]) -> "JobArrays":
        """Row subset (cohort slice as arrays, no objects)."""
        sel = np.asarray(indices, dtype=np.int64)
        return JobArrays(uids=self.uids[sel], t_f=self.t_f[sel],
                         t_fc=self.t_fc[sel], t_s=self.t_s[sel],
                         t_bc=self.t_bc[sel], t_b=self.t_b[sel],
                         arrival=self.arrival[sel],
                         fc_bytes=self.fc_bytes[sel],
                         bc_bytes=self.bc_bytes[sel],
                         priority=self.priority[sel])


def _vec_uplink_ready(arrays: JobArrays, network: Optional[NetworkPlane],
                      t_origin: float) -> np.ndarray:
    """Array form of ``engine._uplink_ready`` — branch-for-branch, so
    every element matches the per-object instant bit-for-bit."""
    fwd = arrays.arrival + arrays.t_f
    if network is None:
        return fwd + arrays.t_fc
    ready = np.empty(arrays.n)
    nominal = arrays.fc_bytes <= 0
    ready[nominal] = (fwd + arrays.t_fc)[nominal]
    rest = np.flatnonzero(~nominal)
    if rest.size == 0:
        return ready
    if network.shared:
        fins = shared_finish_times(
            network.capacity_mbps, network.uplinks,
            [(int(arrays.uids[i]), t_origin + float(fwd[i]),
              float(arrays.fc_bytes[i])) for i in rest])
        for i, f in zip(rest, fins):
            ready[i] = f - t_origin
    elif network.constant_rate:
        rates = np.array([network.uplinks[int(u)].rate_mbps
                          for u in arrays.uids[rest]])
        ready[rest] = fwd[rest] \
            + arrays.fc_bytes[rest] * 8.0 / (rates * 1e6)
    else:
        for i in rest:
            ready[i] = network.uplink_finish(
                int(arrays.uids[i]), t_origin + float(fwd[i]),
                float(arrays.fc_bytes[i])) - t_origin
    return ready


def _vec_downlink_done(served: List[Tuple[int, float]], arrays: JobArrays,
                       idx: Dict[int, int],
                       network: Optional[NetworkPlane],
                       t_origin: float) -> Dict[int, float]:
    """Array form of ``engine._downlink_done`` over the dispatch-ordered
    ``(uid, server_end)`` pairs."""
    out: Dict[int, float] = {}
    shared: List[Tuple[int, float]] = []
    for u, end in served:
        i = idx[u]
        b = float(arrays.bc_bytes[i])
        if network is None or b <= 0:
            out[u] = end + float(arrays.t_bc[i])
        elif network.shared:
            shared.append((u, end))
        elif network.constant_rate:
            out[u] = end + b * 8.0 \
                / (network.downlinks[u].rate_mbps * 1e6)
        else:
            out[u] = network.downlink_finish(u, t_origin + end, b) - t_origin
    if shared:
        fins = shared_finish_times(
            network.capacity_mbps, network.downlinks,
            [(u, t_origin + end, float(arrays.bc_bytes[idx[u]]))
             for u, end in shared])
        for (u, _end), f in zip(shared, fins):
            out[u] = f - t_origin
    return out


def _chunk_smallest(keys: np.ndarray, uids: np.ndarray, k: int) -> np.ndarray:
    """Positions of the ``k`` smallest ``(key, uid)`` pairs, in that order
    — exactly ``np.lexsort((uids, keys))[:k]`` without sorting the whole
    queue.  An O(q) partition bounds the candidate set by the k-th
    smallest key (keeping every tie at the boundary, so the uid tiebreak
    still sees all contenders) and only the candidates are lexsorted:
    a cohort-chunk dispatch from a 10^4-deep queue sorts ~k rows instead
    of 10^4."""
    if keys.size <= k:
        return np.lexsort((uids, keys))
    kth = np.partition(keys, k - 1)[k - 1]
    cand = np.flatnonzero(keys <= kth)
    return cand[np.lexsort((uids[cand], keys[cand]))[:k]]


def _bw_keys(arrays: JobArrays, q: np.ndarray, network: NetworkPlane,
             t: float) -> np.ndarray:
    """Batched ``engine._net_bw_key`` primary keys for the still-queued
    rows ``q`` at global dispatch instant ``t``: one vectorized rate query
    replaces a Python key callback per job per sort.  Elementwise-identical
    to the scalar predictor — ``(t + bits/rate) - t`` keeps the operand
    grouping, the shared-cell capacity share uses the same ``concurrent=0``
    price, and zero-rate links fall back to the scalar recursion."""
    b = arrays.bc_bytes[q]
    uids = arrays.uids[q]
    r = network.rates_bps_at(t, uids, "down")
    if network.shared:
        r = np.minimum(r, network.capacity_mbps * 1e6 / (0 + 1))
    with np.errstate(divide="ignore", invalid="ignore"):
        dl = (t + b * 8.0 / r) - t
    stalled = r <= 0.0
    if stalled.any():
        for j in np.flatnonzero(stalled):
            dl[j] = network.predict_downlink(int(uids[j]), t,
                                             float(b[j])) - t
    nominal = b <= 0.0
    if nominal.any():
        dl = np.where(nominal, arrays.t_bc[q], dl)
    return -(dl + arrays.t_b[q])


def vectorized_round(arrays: JobArrays, *, policy: str = "fifo",
                     order: Optional[Sequence[int]] = None, slots: int = 1,
                     cohort_chunk: int = 1, chunk_efficiency: float = 1.0,
                     deadline: Optional[float] = None,
                     network: Optional[NetworkPlane] = None,
                     t_origin: float = 0.0,
                     collect_events: bool = True,
                     obs: Optional[Observability] = None,
                     rnd: int = 0) -> EngineResult:
    """Vectorized counterpart of ``engine.simulate_round`` — identical
    semantics, identical floats, returned in the same ``EngineResult``.

    Uplink-ready instants, downlink finishes and completions are computed
    in array passes; the dispatch recurrence (slot clocks, idle advance,
    deadline cuts) is replayed as a scalar loop — it MUST stay scalar,
    because bit-exactness is the regression anchor and ``max``/``+``
    chains are order-sensitive.  What gets eliminated is the per-object
    DES's per-dispatch queue re-sort (O(n^2 log n) per wave):

    * A fixed ``order`` is given outright.
    * "fifo"/"wf"/"priority" — and "bw" without a plane — have STATIC
      per-job keys (the repeated DES sort never changes their relative
      order: nominal ``Job.ready``, ``-t_s``, ``-priority``,
      ``-(t_bc + t_b)``), so one arrival lexsort plus a lazily-fed key
      heap — each job pushed exactly once — replays the identical serve
      order in O(n log n).
    * "bw" WITH a plane re-predicts every queued client's downlink from
      live link state at each dispatch boundary: the re-keying is
      BATCHED — one vectorized rate query + masked lexsort over the
      still-queued rows per fill (``_bw_keys``) instead of a Python key
      callback per job per sort.

    ``collect_events=False`` skips building the O(6n) event-tuple trace
    (the bench path); everything else is unaffected.
    """
    if slots < 1 or cohort_chunk < 1:
        raise ValueError("slots and cohort_chunk must be >= 1")
    if order is not None \
            and sorted(order) != sorted(int(u) for u in arrays.uids):
        raise ValueError("order must be a permutation of the job uids")
    if order is None and policy not in DISCIPLINES:
        raise KeyError(f"unknown queue discipline {policy!r}")

    n = arrays.n
    idx = {int(u): i for i, u in enumerate(arrays.uids)}
    ready_arr = _vec_uplink_ready(arrays, network, t_origin)
    events: List[Tuple[float, str, int]] = []
    service: List[ServiceRecord] = []
    served: List[Tuple[int, float]] = []
    completion: Dict[int, float] = {}
    waits: Dict[int, float] = {}
    dropped: List[int] = []
    if collect_events:
        fwd = arrays.arrival + arrays.t_f
        for i in range(n):
            u = int(arrays.uids[i])
            events.append((float(fwd[i]), "fwd_done", u))
            events.append((float(ready_arr[i]), "uplink_done", u))

    slot_free = [0.0] * slots
    n_left = n

    def dispatch(take_pos: Sequence[int], slot: int, start: float):
        uids = tuple(int(arrays.uids[p]) for p in take_pos)
        span = chunked_service_time([float(arrays.t_s[p])
                                     for p in take_pos], chunk_efficiency)
        end = start + span
        service.append(ServiceRecord(slot, uids, start, end))
        if collect_events:
            events.append((start, "server_start", uids[0]))
            events.append((end, "server_done", uids[0]))
        for p, u in zip(take_pos, uids):
            waits[u] = float(start - ready_arr[p])
            served.append((u, end))
        slot_free[slot] = end

    if order is not None:
        # fixed-order mode: chunks of the given sequence, each waiting for
        # its own activations (cost_model.makespan semantics)
        pending = [idx[int(u)] for u in order]
        while n_left > 0:
            slot = min(range(slots), key=lambda s: slot_free[s])
            now = slot_free[slot]
            take = pending[:cohort_chunk]
            pending[:cohort_chunk] = []
            start = max(now, max(float(ready_arr[p]) for p in take))
            if deadline is not None and start > deadline:
                dropped.extend(int(arrays.uids[p]) for p in take)
                n_left -= len(take)
                continue
            dispatch(take, slot, start)
            n_left -= len(take)
    else:
        # Online disciplines: jobs ARRIVE at their (network-resolved)
        # uplink finish; arrivals drain through a pointer over one
        # (arrival, seq) lexsort.  Static-key policies serve from a key
        # heap fed lazily (each job pushed once) — popping the chunk-
        # smallest from it replays the DES's sort/take loop order-for-
        # order because at most one job per client is in the queue and
        # (key, uid) is a total order.  "bw" under a plane re-keys the
        # queued set as arrays at every dispatch boundary instead.
        arr_order = np.lexsort((np.arange(n), ready_arr))   # (ready, seq)
        dynamic_bw = policy == "bw" and network is not None
        if dynamic_bw:
            queued = np.zeros(n, dtype=bool)
            n_queued = 0
        else:
            if policy == "fifo":
                static_key = arrays.arrival + arrays.t_f \
                    + arrays.t_fc                           # Job.ready
            elif policy == "wf":
                static_key = -arrays.t_s
            elif policy == "priority":
                static_key = -arrays.priority
            else:                                # bw, no plane: nominal
                static_key = -(arrays.t_bc + arrays.t_b)
            key_heap: List[Tuple[float, int, int]] = []     # (key, uid, pos)
        i = 0
        while n_left > 0:
            slot = min(range(slots), key=lambda s: slot_free[s])
            now = slot_free[slot]
            while i < n and float(ready_arr[arr_order[i]]) <= now:
                p = int(arr_order[i])
                if dynamic_bw:
                    queued[p] = True
                    n_queued += 1
                else:
                    heapq.heappush(key_heap, (float(static_key[p]),
                                              int(arrays.uids[p]), p))
                i += 1
            if not (n_queued if dynamic_bw else key_heap):
                # queue empty: idle-advance ALL slots to the next arrival
                nxt = float(ready_arr[arr_order[i]])
                if deadline is not None and nxt > deadline:
                    # remaining jobs drop in the arrival heap's
                    # (ready, seq) pop order
                    dropped.extend(int(arrays.uids[arr_order[j]])
                                   for j in range(i, n))
                    n_left = 0
                    continue
                for s in range(slots):
                    slot_free[s] = max(slot_free[s], nxt)
                continue
            if dynamic_bw:
                q = np.flatnonzero(queued)
                keys = _bw_keys(arrays, q, network, t_origin + now)
                sel = q[_chunk_smallest(keys, arrays.uids[q], cohort_chunk)]
                take = [int(p) for p in sel]
                queued[sel] = False
                n_queued -= len(take)
            else:
                take = [heapq.heappop(key_heap)[2]
                        for _ in range(min(cohort_chunk, len(key_heap)))]
            start = now
            if deadline is not None and start > deadline:
                dropped.extend(int(arrays.uids[p]) for p in take)
                n_left -= len(take)
                continue
            dispatch(take, slot, start)
            n_left -= len(take)

    dl = _vec_downlink_done(served, arrays, idx, network, t_origin)
    for u, _end in served:
        completion[u] = dl[u] + float(arrays.t_b[idx[u]])
        if collect_events:
            events.append((dl[u], "downlink_done", u))
            events.append((completion[u], "client_done", u))

    events.sort(key=lambda e: (e[0], e[1], e[2]))
    if obs is not None and obs.enabled:
        # post-hoc bulk emission from the kernel's own columns — a pure
        # read of finished results, so the timeline floats are untouched
        record_round_arrays(obs, arrays=arrays, ready_arr=ready_arr,
                            service=service, served=served, dl=dl,
                            completion=completion, waits=waits, idx=idx,
                            dropped=dropped, t_origin=t_origin, rnd=rnd)
    round_time = max(completion.values()) if completion else 0.0
    if deadline is not None and dropped:
        round_time = max(round_time, deadline)
    return EngineResult(round_time=round_time, service=service,
                        completion=completion, waits=waits, dropped=dropped,
                        events=events)


# ===========================================================================
# Multi-round population clock
# ===========================================================================

@dataclasses.dataclass
class PopulationResult:
    """Timing summary of a population federation run."""
    makespan: float
    round_makespans: List[float]
    commit_times: List[float]
    cohort_sizes: List[int]
    events_processed: int
    modes: List[str]                 # per-round "vectorized" | "objects"
    round_results: List[EngineResult]


class PopulationClock:
    """Multi-round federation clock over a ``PopulationFleet``.

    Sync aggregation runs barrier waves: the vectorized kernel at/above
    ``run.fleet.population_threshold`` cohort members, the EXACT per-object
    DES below it (``force="vectorized"``/``"objects"`` pins a mode for the
    parity tests).  Commits are closed-form timing charges shared by both
    modes: flat (every contributor syncs the cloud) or two-tier
    hierarchical when ``run.fleet.edge_cells > 1`` (members sync their edge
    cell, summaries ride the backhaul) — under ``agg.transport="plane"``
    the adapter payloads travel each client's own link (and contend in
    shared cells); under ``"nominal"`` the charge is the slowest
    contributor's round trip at its nominal rate.

    The async policies (buffered / staleness) pace clients individually:
    below the threshold they run the per-object ``FederationClock``; at
    or above it the struct-of-arrays kernel in ``fed.population_async``
    replays the identical event sequence over arrays (dedicated
    constant-rate transport — shared cells and time-varying links stay
    per-object).

    Schedulers map exactly as in ``Simulator``: "ours"/"fifo"/"wf"/"bw"
    serve ONLINE (keys re-evaluate as jobs arrive; "ours" is the Alg. 2
    priority discipline), while "optimal" — which has no online form —
    is served as a fixed Alg. 2 sequence.
    """

    def __init__(self, cfg: ModelConfig, fleet: PopulationFleet,
                 run: FedRunConfig, *, server: Optional[DeviceProfile] = None,
                 links: Optional[Sequence] = None,
                 force: Optional[str] = None, collect_events: bool = False,
                 obs: Optional[Observability] = None, trainer=None):
        if server is None:
            from repro_torch.fed.devices import SERVER
            server = SERVER
        if force not in (None, "vectorized", "objects"):
            raise KeyError(f"unknown force mode {force!r}")
        if run.fleet.size is not None and run.fleet.size != fleet.n:
            raise ValueError(f"run.fleet.size={run.fleet.size} does not "
                             f"match the {fleet.n}-client fleet")
        if run.engine.scheduler == "optimal":
            # brute-force has no online form; at population scale Alg. 2
            # IS the tractable order, served as a fixed sequence
            self._policy, self._fixed, needs_pri = "fifo", True, False
        else:
            # ours/fifo/wf/bw serve ONLINE (same mapping as
            # Simulator._plan_wave): keys re-evaluate as jobs arrive
            self._policy, needs_pri = resolve_online(run.engine.scheduler)
            self._fixed = False
        # Alg. 2 priorities (N_c / C): same int/float division as
        # scheduling.alg2_priorities, elementwise
        self._pri = (fleet.cuts / fleet.tflops) if needs_pri else None
        self.cfg, self.fleet, self.run_cfg, self.server = cfg, fleet, run, server
        self.now = 0.0
        self._arrays = step_time_arrays(cfg, fleet, server,
                                        run.batch_size, run.seq_len)
        # adapter sync payload per client (Eq. 5 upload at its cut) and the
        # full-depth summary an edge ships to the cloud
        per_layer = lora_upload_bytes(cfg, 1)
        self._agg_bytes = per_layer * fleet.cuts
        n_total = cfg.n_layers + cfg.n_encoder_layers \
            if cfg.family == "encdec" else cfg.n_layers
        self._summary_bytes = lora_upload_bytes(cfg, n_total)
        self._collect_events = collect_events
        self._force = force
        # network plane only when per-object link state is genuinely needed
        # (shared medium or caller-supplied time-varying links); the pure
        # constant-dedicated case stays array-only
        self._plane: Optional[NetworkPlane] = None
        if links is not None:
            if len(links) != fleet.n:
                raise ValueError("need one link per client")
            self._plane = NetworkPlane(list(links), shared=run.net.shared,
                                       capacity_mbps=run.net.capacity_mbps)
        elif run.net.shared:
            self._plane = NetworkPlane(fleet.links(), shared=True,
                                       capacity_mbps=run.net.capacity_mbps)
        self._edges: Optional[EdgeTopology] = None
        if run.fleet.edge_cells > 1:
            if run.fleet.cell_assignment == "kmeans":
                if fleet.coords is None:
                    raise ValueError(
                        "cell_assignment='kmeans' clusters per-client "
                        "coordinates; this fleet carries none — build it "
                        "via FleetSpec.population() or set coords")
                self._edges = EdgeTopology.kmeans(
                    fleet.coords, run.fleet.edge_cells, seed=run.seed,
                    backhaul_mbps=run.fleet.backhaul_mbps,
                    cell_capacity_mbps=run.fleet.edge_capacity_mbps)
            else:
                self._edges = EdgeTopology.grouped(
                    fleet.n, run.fleet.edge_cells,
                    backhaul_mbps=run.fleet.backhaul_mbps,
                    cell_capacity_mbps=run.fleet.edge_capacity_mbps)
        self._round_rng = np.random.default_rng(run.seed + 7777)
        self._straggler_rng = np.random.default_rng(run.seed + 4242)
        # observability bundle: None unless a sink is enabled (the
        # zero-overhead-when-disabled contract)
        self.obs = obs if obs is not None and obs.enabled else None
        # optional real-math trainer (fed/population_training.py): when
        # attached, the serve records the timing kernels produce drive the
        # actual jitted training math through its callbacks, and commits
        # fold real adapter deltas with the Simulator's nominal charges
        self._trainer = trainer
        if trainer is not None:
            trainer._bind(self)

    # ------------------------------------------------------------------ run
    def run(self, verbose: bool = False) -> PopulationResult:
        if self.run_cfg.agg.policy != "sync":
            return self._run_async(verbose)
        return self._run_sync(verbose)

    def _run_sync(self, verbose: bool = False) -> PopulationResult:
        run, fleet = self.run_cfg, self.fleet
        makespans: List[float] = []
        commit_times: List[float] = []
        cohort_sizes: List[int] = []
        modes: List[str] = []
        round_results: List[EngineResult] = []
        n_events = 0
        ranks = fleet.capability_ranks()
        for rnd in range(run.rounds):
            cohort = sample_cohort(self._round_rng, fleet.n,
                                   run.fleet.sampling, run.fleet.rate,
                                   ranks=ranks,
                                   pareto_alpha=run.fleet.pareto_alpha)
            arrays = self._round_arrays(cohort)
            order = self._resolve_order(cohort) if self._fixed else None
            vector = (len(cohort) >= run.fleet.population_threshold
                      if self._force is None
                      else self._force == "vectorized")
            base = self.now
            kw = dict(policy=self._policy, order=order,
                      slots=run.engine.slots,
                      cohort_chunk=run.engine.cohort_chunk,
                      chunk_efficiency=run.engine.chunk_efficiency,
                      deadline=run.engine.deadline, network=self._plane,
                      t_origin=base)
            if vector:
                res = vectorized_round(arrays,
                                       collect_events=self._collect_events,
                                       obs=self.obs, rnd=rnd, **kw)
            else:
                res = simulate_round(arrays.to_jobs(), **kw)
                if self.obs is not None:
                    record_sync_wave(self.obs, res, arrays.to_jobs(),
                                     base, rnd)
            tr = self._trainer
            if tr is not None:
                # real math rides the kernel's service records in event
                # order — exactly where the per-object clock fires
                # _on_serve (ServeEvent.end = base + record-relative end)
                for rec in res.service:
                    tr.on_sync_serve(rec.uids, rnd, base + rec.end)
            self.now = base + res.round_time
            makespans.append(res.round_time)
            cohort_sizes.append(len(cohort))
            modes.append("vectorized" if vector else "objects")
            round_results.append(res)
            n_events += 6 * len(res.completion) + 2 * len(res.dropped)
            if tr is not None:
                # cohort-resident adapter/optimizer bytes live server-side
                # from the wave start until the commit redistributes them
                resident = tr.resident_nbytes()
                if (rnd + 1) % run.agg.interval == 0:
                    # the per-object engine commits at every interval
                    # boundary, empty served set included; the charge is
                    # the trainer's Simulator-mirrored nominal round trip
                    t0c = self.now
                    charge = tr.commit_sync()
                    self.now = max(self.now, self.now + charge)
                    commit_times.append(self.now)
                    if self.obs is not None:
                        if self.obs.tracer is not None:
                            self.obs.tracer.span(
                                "commit", "agg", t0c, self.now, "fleet", 0,
                                attrs={"contributors": len(res.completion)})
                        if self.obs.metrics is not None:
                            self.obs.metrics.inc("commits")
                            self.obs.metrics.observe("commit_overhead_s",
                                                     self.now - t0c)
                if self.obs is not None and self.obs.ledger is not None:
                    self.obs.ledger.cohort_span(base, self.now, resident)
                if tr.on_sync_round_end(rnd, self.now, verbose):
                    break
            elif (rnd + 1) % run.agg.interval == 0 and res.completion:
                self.now = self._commit(sorted(res.completion), self.now)
                commit_times.append(self.now)
        return PopulationResult(makespan=self.now,
                                round_makespans=makespans,
                                commit_times=commit_times,
                                cohort_sizes=cohort_sizes,
                                events_processed=n_events, modes=modes,
                                round_results=round_results)

    # --------------------------------------------------------------- rounds
    def _round_arrays(self, cohort: Sequence[int]) -> JobArrays:
        """This round's jobs for the cohort, with per-round straggler
        re-rolls applied to the compute terms (one vectorized draw; both
        modes consume the same values, so mode choice never perturbs the
        rng stream)."""
        run = self.run_cfg
        sel = np.asarray(cohort, dtype=np.int64)
        a = self._arrays
        t_f, t_b = a["t_f"][sel], a["t_b"][sel]
        if run.fleet.straggler_prob > 0.0:
            slow = (self._straggler_rng.random(sel.size)
                    < run.fleet.straggler_prob)
            scale = np.where(slow, run.fleet.straggler_slowdown, 1.0)
            t_f, t_b = t_f * scale, t_b * scale
        return JobArrays(uids=sel, t_f=t_f, t_fc=a["t_fc"][sel],
                         t_s=a["t_s"][sel], t_bc=a["t_bc"][sel], t_b=t_b,
                         arrival=np.zeros(sel.size),
                         fc_bytes=a["fc_bytes"][sel],
                         bc_bytes=a["bc_bytes"][sel],
                         priority=(self._pri[sel] if self._pri is not None
                                   else np.zeros(sel.size)))

    def _resolve_order(self, cohort: Sequence[int]) -> List[int]:
        """Fixed serve order for the cohort under the run's scheduler,
        computed with array sorts (same keys as scheduling.resolve_order)."""
        run, a = self.run_cfg, self._arrays
        sel = np.asarray(cohort, dtype=np.int64)
        sched = run.engine.scheduler
        if sched in ("ours", "optimal"):
            # Alg. 2: N_c/C descending ("optimal" would brute-force; at
            # population scale Alg. 2 IS the tractable order)
            key = -(self.fleet.cuts[sel] / self.fleet.tflops[sel])
        elif sched == "wf":
            key = -a["t_s"][sel]
        elif sched == "bw":
            key = -(a["t_bc"][sel] + a["t_b"][sel])
        else:
            raise KeyError(f"unknown scheduler {sched!r}")
        return [int(u) for u in sel[np.lexsort((sel, key))]]

    # -------------------------------------------------------------- commits
    def _commit(self, contributors: Sequence[int], t: float) -> float:
        """Closed-form commit charge plus (when enabled) one commit span
        and counters — the emission reads the already-computed instants,
        so obs-on timing is bit-identical to obs-off."""
        t_end = self._commit_time(contributors, t)
        if self.obs is not None:
            if self.obs.tracer is not None:
                self.obs.tracer.span("commit", "agg", t, t_end, "fleet", 0,
                                     attrs={"contributors":
                                            len(contributors)})
            if self.obs.metrics is not None:
                self.obs.metrics.inc("commits")
                self.obs.metrics.observe("commit_overhead_s", t_end - t)
        return t_end

    def _commit_time(self, contributors: Sequence[int], t: float) -> float:
        """Closed-form commit charge: advance the clock past every
        contributor's adapter sync (flat or two-tier).  Shared verbatim by
        both round modes — commit timing never depends on which kernel ran
        the wave."""
        run = self.run_cfg
        if run.agg.transport == "nominal":
            up = np.max(self._agg_bytes[list(contributors)] * 8.0
                        / (self.fleet.rate_mbps[list(contributors)] * 1e6))
            total = 2.0 * float(up)
            if self._edges is not None:
                total += 2.0 * self._edges.backhaul_s(self._summary_bytes)
            return t + total
        # plane transport: adapters travel each contributor's own link
        bytes_fn = lambda u: float(self._agg_bytes[u])
        if self._plane is not None:
            if self._edges is not None:
                _, t_merge = edge_commit_legs(
                    self._edges, self._plane, contributors, t, bytes_fn,
                    self._summary_bytes, "up")
                down, _ = edge_commit_legs(
                    self._edges, self._plane, contributors, t_merge,
                    bytes_fn, self._summary_bytes, "down")
                return max(t, max(down.values()))
            fins = [self._plane.uplink_finish(u, t, bytes_fn(u))
                    for u in contributors] if not self._plane.shared else \
                shared_finish_times(self._plane.capacity_mbps,
                                    self._plane.uplinks,
                                    [(u, t, bytes_fn(u))
                                     for u in contributors])
            t_merge = max(fins)
            downs = [self._plane.downlink_finish(u, t_merge, bytes_fn(u))
                     for u in contributors] if not self._plane.shared else \
                shared_finish_times(self._plane.capacity_mbps,
                                    self._plane.downlinks,
                                    [(u, t_merge, bytes_fn(u))
                                     for u in contributors])
            return max(t, max(downs))
        # array-only constant dedicated links
        sel = np.asarray(list(contributors), dtype=np.int64)
        dur = self._agg_bytes[sel] * 8.0 / (self.fleet.rate_mbps[sel] * 1e6)
        if self._edges is None:
            t_merge = float(np.max(t + dur))
            return max(t, float(np.max(t_merge + dur)))
        cell_of = self._edges.cell_of()
        cid = np.asarray([cell_of[int(u)] for u in sel])
        bh = self._edges.backhaul_s(self._summary_bytes)
        up_fin = t + dur
        t_merge = t
        for c in np.unique(cid):
            cell_fin = float(np.max(up_fin[cid == c])) + bh
            if self.obs is not None and self.obs.tracer is not None:
                self.obs.tracer.span("edge_sync", "agg", t, cell_fin,
                                     "edge", int(c))
            t_merge = max(t_merge, cell_fin)
        down0 = t_merge + bh
        return max(t, float(np.max(down0 + dur)))

    # ---------------------------------------------------------------- async
    def _async_clock_config(self) -> ClockConfig:
        """The one async clock configuration BOTH kernels run — parity by
        construction."""
        run = self.run_cfg
        if run.agg.buffer_k is not None:
            buffer_k = run.agg.buffer_k
        elif self._trainer is not None:
            # real-math runs resolve the Simulator's default (semi-sync
            # half-cohort for buffered, fully async under staleness) so
            # the parity oracle and the trainer commit at the same events
            buffer_k = (1 if run.agg.policy == "staleness"
                        else max(1, self.fleet.n // 2))
        else:
            buffer_k = self.fleet.n
        return ClockConfig(policy=self._policy, slots=run.engine.slots,
                           cohort_chunk=run.engine.cohort_chunk,
                           chunk_efficiency=run.engine.chunk_efficiency,
                           deadline=None, agg_policy=run.agg.policy,
                           agg_interval=1, buffer_k=buffer_k,
                           max_inflight_rounds=run.agg.max_inflight)

    def _run_async(self, verbose: bool = False) -> PopulationResult:
        """Buffered / staleness policies: the struct-of-arrays event kernel
        at/above ``population_threshold``, the per-object FederationClock
        (the parity oracle) below it."""
        run, fleet = self.run_cfg, self.fleet
        use_vec = (fleet.n >= run.fleet.population_threshold
                   if self._force is None else self._force == "vectorized")
        if use_vec:
            res = self._run_async_vectorized()
        else:
            res = self._run_async_objects()
        if self._trainer is not None:
            self._trainer.finalize_async()
        return res

    def _run_async_objects(self) -> PopulationResult:
        run, fleet = self.run_cfg, self.fleet
        a = self._arrays
        times = [StepTimes(t_f=float(a["t_f"][u]), t_fc=float(a["t_fc"][u]),
                           t_s=float(a["t_s"][u]), t_bc=float(a["t_bc"][u]),
                           t_b=float(a["t_b"][u]),
                           fc_bytes=float(a["fc_bytes"][u]),
                           bc_bytes=float(a["bc_bytes"][u]))
                 for u in range(fleet.n)]
        pri = alg2_priorities([int(c) for c in fleet.cuts],
                              [float(x) for x in fleet.tflops]) \
            if self._pri is not None else None
        plane = self._plane if self._plane is not None \
            else NetworkPlane(fleet.links())
        clock = FederationClock(fleet.n, run.rounds,
                                self._async_clock_config(),
                                times_fn=lambda u, r: times[u],
                                priorities=pri, network=plane,
                                obs=self.obs)
        tr = self._trainer
        if tr is not None:
            res = clock.run(on_serve=tr.on_serve, on_commit=tr.commit_async,
                            on_round_start=tr.on_round_start)
        else:
            res = clock.run()
        return PopulationResult(
            makespan=res.makespan, round_makespans=[],
            commit_times=[c.time for c in res.commits],
            cohort_sizes=[fleet.n] * run.rounds,
            events_processed=len(res.events), modes=["objects"],
            round_results=res.round_results)

    def _run_async_vectorized(self) -> PopulationResult:
        from repro_torch.fed.population_async import run_async_vectorized
        run, fleet = self.run_cfg, self.fleet
        if self._plane is not None and not self._plane.constant_rate:
            raise ValueError(
                "the SoA async kernel models dedicated constant-rate "
                "links; shared cells and time-varying links stay "
                "per-object — force='objects' or raise "
                "population_threshold")
        if self._plane is not None:
            up = np.array([l.rate_mbps for l in self._plane.uplinks])
            down = np.array([l.rate_mbps for l in self._plane.downlinks])
        else:
            # same rates NetworkPlane(fleet.links()) would carry
            up = down = fleet.rate_mbps
        tr = self._trainer
        res, n_events = run_async_vectorized(
            self._arrays, run.rounds, self._async_clock_config(),
            up_rate_mbps=up, down_rate_mbps=down, priorities=self._pri,
            collect_trace=self._collect_events, obs=self.obs,
            on_serve=tr.on_serve if tr is not None else None,
            on_commit=tr.commit_async if tr is not None else None,
            on_round_start=tr.on_round_start if tr is not None else None)
        return PopulationResult(
            makespan=res.makespan, round_makespans=[],
            commit_times=[c.time for c in res.commits],
            cohort_sizes=[fleet.n] * run.rounds,
            events_processed=n_events, modes=["vectorized"],
            round_results=res.round_results)
