"""Discrete-event round clock for the split-federated server (§IV, beyond
the closed-form Eqs. 10-12).

The analytic ``cost_model.makespan`` assumes a synchronous round, one server
slot, and a total order fixed before the round starts.  This engine replays
the same Eq. 10 phase structure as *events*

    fwd_done      client-side forward finished        (t = arrival + T^f)
    uplink_done   activations arrived at the server   (+ T^fc)
    server_start  a server slot dequeued the client   (queue discipline)
    server_done   server fwd+bwd finished             (+ service time)
    downlink_done activation gradients delivered      (+ T^bc)
    client_done   client-side backward finished       (+ T^b)

so that scheduling policies act as *online* queue disciplines (choose among
the jobs whose activations have actually arrived), the server may expose
multiple slots, a slot may serve a cohort *chunk* at once (the batched
vmapped server step), clients may arrive staggered (async / semi-sync
rounds), and a deadline may cut stragglers out mid-round.

With ``slots=1``, ``cohort_chunk=1`` and a fixed ``order``, the engine
reproduces ``cost_model.makespan`` exactly (tested) — the analytic model is
the degenerate case of this clock.

Transfers may be delegated to a **network plane** (``repro_torch.net``): when a
``NetworkPlane`` is attached, the uplink/downlink completions are computed
by integrating each job's PAYLOAD BYTES over the per-client time-varying
link rates (and, in shared-medium mode, over the contended cell shares)
instead of adding the fixed nominal-rate ``t_fc``/``t_bc`` durations.  A
constant-rate dedicated plane reproduces the plane-less timelines
bit-for-bit (regression-tested) — the legacy arithmetic is the degenerate
case of the plane.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

from repro_torch.core.cost_model import StepTimes, chunked_service_time
from repro_torch.net import NetworkPlane, shared_finish_times
from repro_torch.net.plane import decode_tuples, encode_tuples
from repro_torch.net.topology import EdgeTopology, edge_commit_legs
from repro_torch.obs import Observability, record_commit, record_sync_wave

__all__ = ["AGG_POLICIES", "ClockConfig", "ClockResult", "CommitEvent",
           "EngineResult", "FederationClock", "Job", "RoundPlan",
           "ServeEvent", "ServiceRecord", "async_downlink_instant",
           "async_uplink_instant", "jobs_from_times", "simulate_round"]


@dataclasses.dataclass(frozen=True)
class Job:
    """One client's Eq. 10 phase durations for this round."""
    uid: int
    t_f: float      # client forward
    t_fc: float     # activation uplink (nominal-rate fallback seconds)
    t_s: float      # server fwd+bwd (this client's remaining layers)
    t_bc: float     # activation-gradient downlink (nominal-rate fallback)
    t_b: float      # client backward
    arrival: float = 0.0   # round-relative start offset (async rounds)
    priority: float = 0.0  # policy="priority" key (e.g. Alg. 2's N_c/C)
    fc_bytes: float = 0.0  # uplink payload for the network plane (0 = t_fc)
    bc_bytes: float = 0.0  # downlink payload for the network plane (0 = t_bc)

    @property
    def ready(self) -> float:
        """When the job enters the server queue (nominal-rate links)."""
        return self.arrival + self.t_f + self.t_fc


@dataclasses.dataclass(frozen=True)
class ServiceRecord:
    """One server dispatch: a chunk of client uids served together."""
    slot: int
    uids: Tuple[int, ...]
    start: float
    end: float


@dataclasses.dataclass
class EngineResult:
    round_time: float
    service: List[ServiceRecord]            # dispatch order, chunk grouping
    completion: Dict[int, float]            # uid -> client_done time
    waits: Dict[int, float]                 # uid -> T^w (queue wait)
    dropped: List[int]                      # uids cut by the deadline
    events: List[Tuple[float, str, int]]    # (time, kind, uid) trace

    @property
    def order(self) -> List[int]:
        """Flat service order (chunk-major)."""
        return [u for rec in self.service for u in rec.uids]


def jobs_from_times(times: Sequence[StepTimes], uids: Sequence[int], *,
                    priorities: Optional[Sequence[float]] = None,
                    arrivals: Optional[Sequence[float]] = None) -> List[Job]:
    """Build engine jobs for the chosen cohort.  ``times``, ``priorities``
    and ``arrivals`` are all indexed by uid (full-fleet lists), so partial
    cohorts pick out exactly their own entries."""
    out = []
    for u in uids:
        st = times[u]
        out.append(Job(uid=u, t_f=st.t_f, t_fc=st.t_fc, t_s=st.t_s,
                       t_bc=st.t_bc, t_b=st.t_b,
                       arrival=arrivals[u] if arrivals is not None else 0.0,
                       priority=priorities[u] if priorities is not None else 0.0,
                       fc_bytes=st.fc_bytes, bc_bytes=st.bc_bytes))
    return out


# -- queue disciplines -------------------------------------------------------
# Each discipline maps an *arrived* job to a sort key; the smallest key is
# served next.  This is the online counterpart of ``scheduling.resolve_order``:
# FIFO picks by arrival, WF by largest server workload, "priority" by the
# caller-supplied key (Alg. 2 passes N_c^u / C_u so the clients with the
# longest client-side backward get their gradients first).

def _key_fifo(job: Job):
    return (job.ready, job.uid)


def _key_wf(job: Job):
    return (-job.t_s, job.uid)


def _key_priority(job: Job):
    return (-job.priority, job.uid)


def _key_bw(job: Job):
    """Bandwidth-aware: largest downlink + client-backward tail first.
    This static key uses the NOMINAL t_bc; with a network plane attached
    the engines re-predict the downlink from the live link state at every
    dispatch instead (see ``_net_bw_key``)."""
    return (-(job.t_bc + job.t_b), job.uid)


DISCIPLINES: Dict[str, Callable[[Job], tuple]] = {
    "fifo": _key_fifo,
    "wf": _key_wf,
    "priority": _key_priority,
    "bw": _key_bw,
}


def _net_bw_key(network: NetworkPlane, t: float, job: Job,
                concurrent: int = 0):
    """Live-network form of the "bw" discipline key at dispatch time ``t``
    (GLOBAL clock): predicted downlink duration + client backward."""
    if job.bc_bytes > 0:
        dl = network.predict_downlink(job.uid, t, job.bc_bytes,
                                      concurrent=concurrent) - t
    else:
        dl = job.t_bc
    return (-(dl + job.t_b), job.uid)


# -- network-plane transfer resolution ---------------------------------------
# Round-relative engines hand the plane GLOBAL instants (t_origin + local);
# a constant-rate plane skips the conversion entirely so the arithmetic —
# and therefore every timeline float — is bit-identical to the plane-less
# legacy path.

def _uplink_ready(jobs: Sequence[Job], network: Optional[NetworkPlane],
                  t_origin: float) -> Dict[int, float]:
    """Round-relative uplink-completion instant per uid."""
    ready: Dict[int, float] = {}
    shared: List[Job] = []
    for j in jobs:
        if network is None or j.fc_bytes <= 0:
            ready[j.uid] = j.ready
        elif network.shared:
            shared.append(j)
        elif network.constant_rate:
            ready[j.uid] = network.uplink_finish(
                j.uid, j.arrival + j.t_f, j.fc_bytes)
        else:
            ready[j.uid] = network.uplink_finish(
                j.uid, t_origin + (j.arrival + j.t_f), j.fc_bytes) - t_origin
    if shared:
        fins = shared_finish_times(
            network.capacity_mbps, network.uplinks,
            [(j.uid, t_origin + (j.arrival + j.t_f), j.fc_bytes)
             for j in shared])
        for j, f in zip(shared, fins):
            ready[j.uid] = f - t_origin
    return ready


def _downlink_done(served: Sequence[Tuple[int, float]],
                   by_uid: Dict[int, Job],
                   network: Optional[NetworkPlane],
                   t_origin: float) -> Dict[int, float]:
    """Round-relative downlink-completion instant for ``(uid, server_end)``
    pairs.  Downlink finishes never feed back into the round's dispatch
    decisions, so even the shared-medium case resolves in one batch."""
    out: Dict[int, float] = {}
    shared: List[Tuple[int, float]] = []
    for u, end in served:
        j = by_uid[u]
        if network is None or j.bc_bytes <= 0:
            out[u] = end + j.t_bc
        elif network.shared:
            shared.append((u, end))
        elif network.constant_rate:
            out[u] = network.downlink_finish(u, end, j.bc_bytes)
        else:
            out[u] = network.downlink_finish(
                u, t_origin + end, j.bc_bytes) - t_origin
    if shared:
        fins = shared_finish_times(
            network.capacity_mbps, network.downlinks,
            [(u, t_origin + end, by_uid[u].bc_bytes) for u, end in shared])
        for (u, _end), f in zip(shared, fins):
            out[u] = f - t_origin
    return out


def async_uplink_instant(network: Optional[NetworkPlane], job: Job) -> float:
    """Global instant a job entering its round at ``job.arrival`` reaches the
    server queue, over a dedicated (or absent) network.  Shared-medium
    uplinks go through a ``SharedCell`` instead — they are cell events, not
    a per-job offset.  The population-scale SoA kernel
    (``fed/population_async.py``) mirrors this elementwise; keeping both
    engines on the same expression is what keeps them bit-identical."""
    if network is not None and job.fc_bytes > 0:
        return network.uplink_finish(job.uid, job.arrival + job.t_f,
                                     job.fc_bytes)
    return job.ready


def async_downlink_instant(network: Optional[NetworkPlane], job: Job,
                           t: float) -> float:
    """Global instant a job served at ``t`` finishes its downlink, over a
    dedicated (or absent) network.  Counterpart of
    ``async_uplink_instant``; mirrored by the SoA async kernel."""
    if network is not None and job.bc_bytes > 0:
        return network.downlink_finish(job.uid, t, job.bc_bytes)
    return t + job.t_bc


def simulate_round(jobs: Sequence[Job], *, policy: str = "fifo",
                   order: Optional[Sequence[int]] = None, slots: int = 1,
                   cohort_chunk: int = 1, chunk_efficiency: float = 1.0,
                   deadline: Optional[float] = None,
                   network: Optional[NetworkPlane] = None,
                   t_origin: float = 0.0) -> EngineResult:
    """Run one round through the event clock.

    policy           online discipline ("fifo" | "wf" | "priority" | "bw") —
                     ignored when ``order`` is given;
    order            fixed uid sequence (the analytic / brute-force-optimal
                     mode): slots serve exactly this order, waiting for each
                     job's activations like ``cost_model.makespan`` does;
    slots            concurrent server executors;
    cohort_chunk     max clients dispatched together (batched server step);
    chunk_efficiency fraction of the summed sequential service time a k>1
                     chunk costs (1.0 = no batching win);
    deadline         jobs not dispatched by this time are dropped mid-round;
    network          optional network plane: transfer completions integrate
                     payload bytes over per-client (possibly time-varying,
                     possibly shared-medium-contended) link rates instead of
                     the jobs' fixed nominal durations;
    t_origin         GLOBAL instant this round's t=0 corresponds to (the
                     multi-round clock passes its current time so traced
                     links fade on the global timeline).
    """
    if slots < 1 or cohort_chunk < 1:
        raise ValueError("slots and cohort_chunk must be >= 1")
    if order is not None and sorted(order) != sorted(j.uid for j in jobs):
        raise ValueError("order must be a permutation of the job uids")
    if order is None and policy not in DISCIPLINES:
        raise KeyError(f"unknown queue discipline {policy!r}")

    by_uid = {j.uid: j for j in jobs}
    ready = _uplink_ready(jobs, network, t_origin)
    events: List[Tuple[float, str, int]] = []
    service: List[ServiceRecord] = []
    served: List[Tuple[int, float]] = []   # (uid, server_end) dispatch order
    completion: Dict[int, float] = {}
    waits: Dict[int, float] = {}
    dropped: List[int] = []

    # event heap holds arrivals; (time, seq) keeps ordering deterministic
    heap: List[Tuple[float, int, int]] = []
    for seq, j in enumerate(jobs):
        events.append((j.arrival + j.t_f, "fwd_done", j.uid))
        events.append((ready[j.uid], "uplink_done", j.uid))
        heapq.heappush(heap, (ready[j.uid], seq, j.uid))

    slot_free = [0.0] * slots
    queue: List[int] = []            # uids with activations at the server
    pending = list(order) if order is not None else None

    def drain_arrivals(now: float):
        while heap and heap[0][0] <= now:
            _, _, uid = heapq.heappop(heap)
            queue.append(uid)

    def sort_queue(now: float):
        if policy == "bw" and network is not None:
            queue.sort(key=lambda u: _net_bw_key(network, t_origin + now,
                                                 by_uid[u]))
        else:
            key = DISCIPLINES[policy]
            queue.sort(key=lambda u: key(by_uid[u]))

    def finish(uids: Sequence[int], slot: int, start: float, end: float):
        service.append(ServiceRecord(slot, tuple(uids), start, end))
        events.append((start, "server_start", uids[0]))
        events.append((end, "server_done", uids[0]))
        for u in uids:
            waits[u] = start - ready[u]
            served.append((u, end))

    n_left = len(jobs)
    while n_left > 0:
        slot = min(range(slots), key=lambda s: slot_free[s])
        now = slot_free[slot]
        drain_arrivals(now)

        if order is not None:
            # fixed-order mode: take the next uids in sequence, wait for them
            take = pending[:cohort_chunk]
            pending[:cohort_chunk] = []
            start = max(now, max(ready[u] for u in take))
            if deadline is not None and start > deadline:
                dropped.extend(take)
                n_left -= len(take)
                continue
        else:
            if not queue:
                # idle until the next activation arrives.  ALL idle slots
                # advance to that instant — bumping only the chosen slot
                # would let another slot with an earlier clock dispatch the
                # drained job "in the past" (negative wait).
                nxt = heap[0][0]
                if deadline is not None and nxt > deadline:
                    while heap:
                        dropped.append(heapq.heappop(heap)[2])
                        n_left -= 1
                    continue
                for s in range(slots):
                    slot_free[s] = max(slot_free[s], nxt)
                drain_arrivals(nxt)
                continue
            sort_queue(now)
            take = queue[:cohort_chunk]
            queue[:cohort_chunk] = []
            start = now
            if deadline is not None and start > deadline:
                dropped.extend(take)
                n_left -= len(take)
                continue

        span = chunked_service_time([by_uid[u].t_s for u in take],
                                    chunk_efficiency)
        finish(take, slot, start, start + span)
        slot_free[slot] = start + span
        n_left -= len(take)

    # downlinks resolve after dispatch (they never feed back into it);
    # under a shared medium the whole batch contends in one cell
    dl = _downlink_done(served, by_uid, network, t_origin)
    for u, _end in served:
        events.append((dl[u], "downlink_done", u))
        completion[u] = dl[u] + by_uid[u].t_b
        events.append((completion[u], "client_done", u))

    events.sort(key=lambda e: (e[0], e[1], e[2]))
    round_time = max(completion.values()) if completion else 0.0
    if deadline is not None and dropped:
        # the server waited until the deadline before cutting stragglers,
        # so the round cannot be shorter than the deadline itself
        round_time = max(round_time, deadline)
    return EngineResult(round_time=round_time, service=service,
                        completion=completion, waits=waits, dropped=dropped,
                        events=events)


# ===========================================================================
# Continuous-time multi-round federation clock
# ===========================================================================
# ``simulate_round`` models ONE round and hands time back to its caller at
# the barrier.  ``FederationClock`` owns time across rounds: under the
# ``sync`` aggregation policy it replays the per-round DES as barrier waves
# (bit-identical to the single-round engine), and under the async policies
# (``buffered`` k-of-U and ``staleness``) it runs a genuinely continuous
# event loop in which every client re-enters its next local round as soon
# as its previous client-side backward finishes, bounded by a
# ``max_inflight_rounds`` credit against the server's aggregation commits.
# The server queue is live: uploads from different local rounds coexist and
# the discipline re-sorts them at every dispatch.

AGG_POLICIES = ("sync", "buffered", "staleness")


@dataclasses.dataclass(frozen=True)
class ClockConfig:
    """Knobs of the multi-round clock (the DES-side subset of FedRunConfig)."""
    policy: str = "fifo"                 # online queue discipline
    slots: int = 1                       # concurrent server executors
    cohort_chunk: int = 1                # clients per batched dispatch
    chunk_efficiency: float = 1.0        # k>1 chunk cost vs summed sequential
    deadline: Optional[float] = None     # per-round straggler cut (sync only)
    agg_policy: str = "sync"             # sync | buffered | staleness
    agg_interval: int = 1                # sync: commit every I barriers
    buffer_k: int = 1                    # async: commit at k distinct uploads
    max_inflight_rounds: int = 1         # async: rounds past the last commit

    def __post_init__(self):
        if self.agg_policy not in AGG_POLICIES:
            raise KeyError(f"unknown aggregation policy {self.agg_policy!r}")
        if self.slots < 1 or self.cohort_chunk < 1:
            raise ValueError("slots and cohort_chunk must be >= 1")
        if not 0.0 < self.chunk_efficiency <= 1.0:
            raise ValueError("chunk_efficiency must be in (0, 1]")
        if self.agg_interval < 1 or self.buffer_k < 1:
            raise ValueError("agg_interval and buffer_k must be >= 1")
        if self.max_inflight_rounds < 1:
            raise ValueError("max_inflight_rounds must be >= 1")
        if self.agg_policy == "sync" and self.max_inflight_rounds != 1:
            raise ValueError("sync aggregation is a barrier: "
                             "max_inflight_rounds must be 1")
        if self.agg_policy != "sync":
            if self.policy not in DISCIPLINES:
                raise KeyError(f"async policies need an online queue "
                               f"discipline, got {self.policy!r}")
            if self.deadline is not None:
                raise ValueError("round deadlines are a synchronous-round "
                                 "notion; async policies pace clients "
                                 "individually instead")


@dataclasses.dataclass(frozen=True)
class ServeEvent:
    """One server dispatch in global (cross-round) time."""
    uids: Tuple[int, ...]
    rounds: Tuple[int, ...]       # each uid's local round index
    slot: int
    start: float
    end: float


@dataclasses.dataclass(frozen=True)
class CommitEvent:
    """One aggregation commit: the server folded the buffered contributions
    into global model version ``version``.

    ``overhead`` records the commit's extra delay: the caller's scalar
    return, or — when ``on_commit`` returns a per-uid mapping (migration
    charges, per-client redistribute) — the mapping's maximum.  Under
    plane-routed aggregation (``agg_bytes_fn``) the adapter transfers are
    NOT part of this figure; they show up as the commit landing at the
    merge instant and each contributor releasing at its downlink finish."""
    time: float
    version: int                   # version AFTER this commit (1-based)
    contributors: Tuple[int, ...]
    staleness: Tuple[int, ...]     # commits elapsed since each contributor's
    forced: bool = False           # last model refresh; 0 under sync
    overhead: float = 0.0          # redistribute transfer added by the caller


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Caller-supplied plan for one sync barrier wave (cohort sampling,
    per-round straggler rolls and fixed-order scheduling live with the
    caller, not the clock)."""
    jobs: List[Job]
    policy: str = "fifo"
    order: Optional[Sequence[int]] = None


@dataclasses.dataclass
class ClockResult:
    makespan: float
    serves: List[ServeEvent]
    commits: List[CommitEvent]
    rounds_completed: Dict[int, int]          # uid -> finished local rounds
    dropped: List[Tuple[int, int]]            # (uid, round) deadline cuts
    round_results: List[EngineResult]         # sync mode: one per barrier
    events: List[Tuple[float, str, int]]      # (time, kind, uid) trace
    preempted: bool = False                   # on_tick stopped the run early


class _AsyncState:
    """Mutable continuous-time loop state — exactly what a mid-flight
    snapshot must capture to resume the async event loop bit-for-bit.
    One field per piece of the loop; see ``FederationClock.state_dict``."""

    __slots__ = ("heap", "seq", "agg_seq", "started", "finished", "acked",
                 "model_version", "release", "free_at", "blocked", "jobs",
                 "queue", "slot_free", "buffer", "pending_aggs", "awaiting",
                 "agg_extra", "up_cell", "down_cell")


class FederationClock:
    """Persistent multi-round event engine.

    The caller owns the model math; the clock owns time.  It reports every
    server dispatch via ``on_serve`` (the caller runs the real jitted
    client-forward / server-step / client-backward there) and every
    aggregation commit via ``on_commit`` (the caller aggregates and returns
    the redistribute transfer time, which delays the contributors' next
    local round).

    ``times_fn(uid, local_round) -> StepTimes`` supplies per-round Eq. 10
    phase durations (so stragglers can be re-rolled per client round) and is
    consulted LIVE — a control plane that changes a client's cut between
    rounds changes its subsequent jobs; ``priorities`` feeds the
    ``priority`` discipline (Alg. 2's N_c/C) and is likewise read per round
    start, so in-place refreshes (``scheduling.refresh_priorities``) take
    effect immediately; ``network`` attaches a network plane — transfer
    completions then integrate payload bytes over the per-client link-rate
    processes on the clock's GLOBAL timeline (a traced link that fades at
    t=50s fades in whatever round is in flight then).

    ``agg_bytes_fn(uid) -> bytes`` opts into PLANE-ROUTED aggregation:
    instead of the caller folding a nominal-rate scalar into the commit
    overhead, each contributor's adapter upload travels its own uplink
    (contending in the shared-medium cell with any in-flight activation
    transfers), the model merge happens when the LAST contributor upload
    lands, and each contributor resumes only when its adapter download
    finishes.  ``on_commit`` then fires at the merge instant and its return
    value is EXTRA seconds beyond each contributor's download (migration
    shipping etc.), not the transfer itself.
    """

    def __init__(self, n_clients: int, rounds: int, cfg: ClockConfig, *,
                 times_fn: Optional[Callable[[int, int], StepTimes]] = None,
                 priorities: Optional[Sequence[float]] = None,
                 network: Optional[NetworkPlane] = None,
                 agg_bytes_fn: Optional[Callable[[int], float]] = None,
                 edges: Optional[EdgeTopology] = None,
                 summary_bytes: float = 0.0,
                 obs: Optional[Observability] = None):
        if n_clients < 1 or rounds < 1:
            raise ValueError("need at least one client and one round")
        if cfg.agg_policy != "sync" and times_fn is None:
            raise ValueError("async policies need times_fn(uid, round)")
        if cfg.agg_policy != "sync" and cfg.buffer_k > n_clients:
            raise ValueError("buffer_k cannot exceed the fleet size")
        if network is not None and network.n_clients != n_clients:
            raise ValueError("network plane must carry one link per client")
        if agg_bytes_fn is not None and network is None:
            raise ValueError("plane-routed aggregation (agg_bytes_fn) needs "
                             "a network plane to route through")
        if edges is not None:
            if agg_bytes_fn is None:
                raise ValueError("two-tier commits route adapters through "
                                 "the plane; edges needs agg_bytes_fn")
            if cfg.agg_policy != "sync":
                raise ValueError("two-tier hierarchical aggregation commits "
                                 "at sync barriers")
            covered = {u for cell in edges.cells for u in cell}
            if covered != set(range(n_clients)):
                raise ValueError("edge cells must partition the fleet")
        self.n, self.rounds, self.cfg = n_clients, rounds, cfg
        self.times_fn, self.priorities = times_fn, priorities
        self.network = network
        self.agg_bytes_fn = agg_bytes_fn
        self.edges = edges
        self.summary_bytes = float(summary_bytes)
        # observability bundle; None when no sink is enabled so every hot-path
        # hook is one attribute-is-None check (the zero-overhead contract)
        self.obs = obs if obs is not None and obs.enabled else None
        self.now = 0.0
        self.version = 0              # global model version (commit count)
        self.serves: List[ServeEvent] = []
        self.commits: List[CommitEvent] = []
        self.round_results: List[EngineResult] = []
        self.dropped: List[Tuple[int, int]] = []
        self.trace: List[Tuple[float, str, int]] = []
        # mid-flight checkpoint/resume state
        self._shared = network is not None and network.shared
        self._routed = agg_bytes_fn is not None
        self._astate: Optional[_AsyncState] = None   # live async loop state
        self._sync_rnd = 0            # next sync barrier wave to run
        self._preempted = False
        # run()-scoped caller callbacks (never serialized)
        self._on_serve = self._on_commit = self._on_round_start = None

    # ------------------------------------------------------------------ run
    def run(self, *, on_serve=None, on_commit=None, plan_fn=None,
            on_round_end=None, on_round_start=None,
            on_tick=None) -> ClockResult:
        """Run the federation to completion (or to a preemption point).

        sync:  ``plan_fn(rnd) -> RoundPlan`` builds each barrier wave;
               ``on_round_end(rnd, EngineResult) -> bool|None`` may return
               False to stop early (target-accuracy early exit).
        async: jobs are generated internally from ``times_fn``; ``plan_fn``
               and ``on_round_end`` are unused; ``on_round_start(uid, rnd,
               t)`` fires when a client enters a local round (the caller
               snapshots the client's model pull there).

        ``on_tick(now)`` fires at every snapshot-safe boundary — after each
        processed event under the async policies, after each barrier wave
        under sync.  The caller may call :meth:`state_dict` there (a pure
        read; it never perturbs the timeline) and may return ``False`` to
        PREEMPT the run: the clock stops immediately and the returned
        result carries ``preempted=True``.  A preempted clock — or a fresh
        one restored via :meth:`load_state_dict` — continues exactly where
        it stopped on the next ``run`` call.
        """
        self._preempted = False
        if self.cfg.agg_policy == "sync":
            self._run_sync(on_serve, on_commit, plan_fn, on_round_end,
                           on_tick)
        else:
            self._run_async(on_serve, on_commit, on_round_start, on_tick)
        self.trace.sort(key=lambda e: (e[0], e[1], e[2]))
        done = {u: 0 for u in range(self.n)}
        for ev in self.serves:
            for u in ev.uids:
                done[u] += 1
        return ClockResult(makespan=self.now, serves=self.serves,
                           commits=self.commits,
                           rounds_completed=done, dropped=self.dropped,
                           round_results=self.round_results,
                           events=self.trace, preempted=self._preempted)

    # ------------------------------------------------------------- sync mode
    def _run_sync(self, on_serve, on_commit, plan_fn, on_round_end,
                  on_tick=None):
        """Barrier waves: each round replays the single-round DES verbatim
        (exact single-round / Eq. 10-12 parity), then time advances by the round
        makespan plus any commit overhead before the next wave starts.
        Snapshot/resume granularity is the barrier (``self._sync_rnd`` is
        the next wave to run)."""
        if plan_fn is None:
            raise ValueError("sync mode needs plan_fn(rnd) -> RoundPlan")
        cfg = self.cfg
        for rnd in range(self._sync_rnd, self.rounds):
            plan = plan_fn(rnd)
            base = self.now
            res = simulate_round(plan.jobs, policy=plan.policy,
                                 order=plan.order, slots=cfg.slots,
                                 cohort_chunk=cfg.cohort_chunk,
                                 chunk_efficiency=cfg.chunk_efficiency,
                                 deadline=cfg.deadline,
                                 network=self.network, t_origin=base)
            for rec in res.service:
                ev = ServeEvent(uids=rec.uids, rounds=(rnd,) * len(rec.uids),
                                slot=rec.slot, start=base + rec.start,
                                end=base + rec.end)
                self.serves.append(ev)
                if on_serve is not None:
                    on_serve(ev)
            self.dropped.extend((u, rnd) for u in res.dropped)
            self.trace.extend((base + t, kind, uid)
                              for t, kind, uid in res.events)
            if self.obs is not None:
                record_sync_wave(self.obs, res, plan.jobs, base, rnd)
            self.now = base + res.round_time
            self.round_results.append(res)
            if (rnd + 1) % cfg.agg_interval == 0:
                served = tuple(sorted(res.completion))
                zeros = (0,) * len(served)
                if self.agg_bytes_fn is not None and served:
                    # plane-routed barrier sync: contributor adapters travel
                    # their own (possibly faded, possibly contended) links;
                    # merge at the last upload, resume at the last download.
                    # Download payloads are read AFTER on_commit ran — a
                    # control decision there redistributes at the new cuts.
                    # With an edge topology, members sync their own edge
                    # cell first and only merged summaries ride the
                    # backhaul (the cloud merge waits for the slowest
                    # cell, not the slowest client).
                    if self.edges is not None:
                        _, t_merge = edge_commit_legs(
                            self.edges, self.network, served, self.now,
                            self.agg_bytes_fn, self.summary_bytes, "up")
                    else:
                        t_merge = max(self._routed_leg(served, self.now,
                                                       "up").values())
                    overhead, per = self._commit(served, zeros, on_commit,
                                                 time=t_merge)
                    if self.edges is not None:
                        down_f, _ = edge_commit_legs(
                            self.edges, self.network, served, t_merge,
                            self.agg_bytes_fn, self.summary_bytes, "down")
                    else:
                        down_f = self._routed_leg(served, t_merge, "down")
                    extra = per if per is not None \
                        else {u: overhead for u in served}
                    self.now = max(self.now,
                                   max(down_f[u] + extra.get(u, 0.0)
                                       for u in served))
                else:
                    self._commit(served, zeros, on_commit)
            self._sync_rnd = rnd + 1
            if on_round_end is not None and on_round_end(rnd, res) is False:
                break
            if on_tick is not None and on_tick(self.now) is False:
                self._preempted = True
                break

    # ------------------------------------------------- routed adapter syncs
    def _routed_leg(self, contributors: Sequence[int], t: float,
                    direction: str) -> Dict[int, float]:
        """One direction of a barrier commit's adapter syncs through the
        plane, all starting at ``t`` with no other transfers in flight (the
        sync-barrier case — within a barrier, every activation transfer has
        already completed, so the syncs only contend with EACH OTHER).
        Returns ``{uid: finish_time}``."""
        net = self.network
        reqs = [(u, t, float(self.agg_bytes_fn(u))) for u in contributors]
        links = net.uplinks if direction == "up" else net.downlinks
        if net.shared:
            fins = shared_finish_times(net.capacity_mbps, links, reqs)
        else:
            fin = net.uplink_finish if direction == "up" \
                else net.downlink_finish
            fins = [fin(u, t0, b) for u, t0, b in reqs]
        return dict(zip(contributors, fins))

    # ------------------------------------------------------------ async mode
    # The continuous-time loop is STEPWISE: ``_async_step`` processes one
    # event, all mutable loop state lives in ``self._astate`` (an
    # ``_AsyncState``), and the boundary between any two steps is a valid
    # snapshot point — ``state_dict``/``load_state_dict`` serialize the
    # whole thing, and a restored clock's next ``run`` call continues the
    # event loop bit-for-bit where the snapshot froze it.

    def _run_async(self, on_serve, on_commit, on_round_start=None,
                   on_tick=None):
        self._on_serve, self._on_commit = on_serve, on_commit
        self._on_round_start = on_round_start
        if self._astate is None:
            self._astate = self._async_fresh()
            for u in range(self.n):
                self._start_round(u, 0.0)
        while self._async_step():
            if on_tick is not None and on_tick(self.now) is False:
                self._preempted = True
                break

    def _async_fresh(self) -> _AsyncState:
        S = _AsyncState()
        S.heap = []                     # (time, seq, kind, payload)
        S.seq = 0
        S.started = [0] * self.n        # local rounds entered
        S.finished = [0] * self.n       # local rounds fully completed
        S.acked = [0] * self.n          # finished rounds covered by a commit
        S.model_version = [0] * self.n  # version of each client's model copy
        S.release = [0.0] * self.n      # earliest next-round start (commit dl)
        S.free_at = [0.0] * self.n      # previous round's client_done
        S.blocked = set()               # out of inflight credit
        S.jobs = {}                     # (uid, round) -> Job
        S.queue = []                    # (uid, round) at the server
        S.slot_free = [0.0] * self.cfg.slots
        S.buffer = {}                   # uid -> latest finished local round
        # plane-routed aggregation state (agg_bytes_fn): in-flight commits
        # whose adapter transfers travel the links/cells as first-class
        # events; ``awaiting[u]`` counts adapter syncs a client must finish
        # before entering another local round
        S.agg_seq = 0
        S.pending_aggs = {}
        S.awaiting = {}
        S.agg_extra = {}                # shared-cell tid -> extra secs
        S.up_cell = self.network.make_cell("up") if self._shared else None
        S.down_cell = self.network.make_cell("down") if self._shared else None
        if self._shared and self.obs is not None:
            S.up_cell.obs = (self.obs, 0)
            S.down_cell.obs = (self.obs, 1)
        return S

    def _push(self, t, kind, payload):
        S = self._astate
        heapq.heappush(S.heap, (t, S.seq, kind, payload))
        S.seq += 1

    def _sched_cell(self, cell, kind):
        """(Re)schedule the cell's next predicted completion.  The
        version stamp invalidates predictions that an add/remove has
        re-timed since they were pushed."""
        nc = cell.next_completion()
        if nc is not None:
            self._push(nc, kind, cell.version)

    def _start_round(self, u, t):
        S, cfg, net = self._astate, self.cfg, self.network
        if S.started[u] >= self.rounds:
            return
        if S.awaiting.get(u, 0) > 0:
            return      # adapter sync in flight; resumes when it lands
        if S.started[u] - S.acked[u] >= cfg.max_inflight_rounds:
            S.blocked.add(u)
            if self.obs is not None and self.obs.metrics is not None:
                self.obs.metrics.inc("credit_gate_stalls")
            return
        rnd = S.started[u]
        S.started[u] += 1
        t0 = max(t, S.release[u], S.free_at[u])
        st = self.times_fn(u, rnd)
        pri = self.priorities[u] if self.priorities is not None else 0.0
        job = Job(uid=u, t_f=st.t_f, t_fc=st.t_fc, t_s=st.t_s,
                  t_bc=st.t_bc, t_b=st.t_b, arrival=t0, priority=pri,
                  fc_bytes=st.fc_bytes, bc_bytes=st.bc_bytes)
        S.jobs[(u, rnd)] = job
        if self._on_round_start is not None:
            self._on_round_start(u, rnd, t0)
        self.trace.append((t0 + job.t_f, "fwd_done", u))
        o = self.obs
        if o is not None and o.tracer is not None:
            o.tracer.span("fwd", "compute", t0, t0 + job.t_f, "client", u)
        if self._shared and net is not None and job.fc_bytes > 0:
            # the uplink contends in the cell from fwd_done on;
            # its completion is a cell event, not a fixed offset
            if o is not None:
                o.mark(f"ul:{u}:{rnd}", t0 + job.t_f)
            self._push(t0 + job.t_f, "up_start", (u, rnd))
            return
        ready = async_uplink_instant(net, job)
        self.trace.append((ready, "uplink_done", u))
        if o is not None:
            if o.tracer is not None:
                o.tracer.span("uplink", "net", t0 + job.t_f, ready,
                              "client", u)
            if o.metrics is not None:
                o.metrics.observe("uplink_s", ready - (t0 + job.t_f))
            o.mark(f"qw:{u}:{rnd}", ready)
        self._push(ready, "uplink", (u, rnd))

    def _sort_queue_async(self, t):
        S, net = self._astate, self.network
        if self.cfg.policy == "bw" and net is not None:
            conc = len(S.down_cell.active) if self._shared else 0
            S.queue.sort(key=lambda e: _net_bw_key(net, t, S.jobs[e],
                                                   concurrent=conc))
        else:
            key_of = DISCIPLINES[self.cfg.policy]
            S.queue.sort(key=lambda e: key_of(S.jobs[e]))

    def _try_dispatch(self, t):
        S, cfg = self._astate, self.cfg
        chunk = cfg.cohort_chunk
        while S.queue:
            s = min(range(cfg.slots), key=lambda i: S.slot_free[i])
            if S.slot_free[s] > t:
                return
            self._sort_queue_async(t)
            take = S.queue[:chunk]
            del S.queue[:chunk]
            span = chunked_service_time([S.jobs[e].t_s for e in take],
                                        cfg.chunk_efficiency)
            S.slot_free[s] = t + span
            self.trace.append((t, "server_start", take[0][0]))
            if self.obs is not None:
                for uu, rr in take:
                    self.obs.close("queue_wait", "queue", "queue_wait",
                                   f"qw:{uu}:{rr}", t, "client", uu)
            self._push(t + span, "served", (tuple(take), s, t))

    def _commit_buffer(self, t, forced):
        if self._routed:
            self._begin_commit(t, forced)
        else:
            self._do_commit(t, forced)

    def _do_commit(self, t, forced):
        S, cfg = self._astate, self.cfg
        contribs = tuple(sorted(S.buffer))
        stal = tuple(self.version - S.model_version[u] for u in contribs)
        overhead, per = self._commit(contribs, stal, self._on_commit, time=t,
                                     forced=forced)
        for u in contribs:
            S.model_version[u] = self.version
            S.acked[u] = S.finished[u]
            S.release[u] = t + (per.get(u, 0.0) if per is not None
                                else overhead)
        S.buffer.clear()
        for u in sorted(S.blocked):
            if S.started[u] - S.acked[u] < cfg.max_inflight_rounds:
                S.blocked.discard(u)
                self._start_round(u, t)

    # -- plane-routed aggregation: uploads -> merge -> downloads -------------
    def _begin_commit(self, t, forced):
        """Snapshot the buffer and launch the contributors' adapter
        uploads through the plane; the merge fires when the last one
        lands (``_merge_agg``)."""
        S, net = self._astate, self.network
        aid = S.agg_seq
        S.agg_seq += 1
        contribs = tuple(sorted(S.buffer))
        S.buffer.clear()
        S.pending_aggs[aid] = {"contribs": contribs,
                               "left": set(contribs), "forced": forced}
        o = self.obs
        for u in contribs:
            S.awaiting[u] = S.awaiting.get(u, 0) + 1
            b = float(self.agg_bytes_fn(u))
            if self._shared:
                if o is not None:
                    o.mark(f"au:{aid}:{u}", t)
                S.up_cell.add(t, ("aggup", aid, u), u, b)
            else:
                fin = net.uplink_finish(u, t, b)
                if o is not None and o.tracer is not None:
                    o.tracer.span("agg_uplink", "agg", t, fin, "client", u)
                self._push(fin, "aggup_done", (aid, u))
        if self._shared:
            self._sched_cell(S.up_cell, "up_net")

    def _agg_upload_landed(self, aid, u, t):
        S = self._astate
        self.trace.append((t, "agg_uplink_done", u))
        if self.obs is not None:
            self.obs.close("agg_uplink", "agg", None, f"au:{aid}:{u}", t,
                           "client", u)
        info = S.pending_aggs[aid]
        info["left"].discard(u)
        if not info["left"]:
            self._merge_agg(aid, t)

    def _merge_agg(self, aid, t):
        """All contributor uploads landed: fold the commit (caller model
        math via on_commit, which may return per-uid EXTRA seconds —
        migration shipping), then redistribute via the downlinks."""
        S, cfg, net = self._astate, self.cfg, self.network
        info = S.pending_aggs.pop(aid)
        contribs = info["contribs"]
        stal = tuple(self.version - S.model_version[u] for u in contribs)
        overhead, per = self._commit(contribs, stal, self._on_commit, time=t,
                                     forced=info["forced"])
        o = self.obs
        for u in contribs:
            S.model_version[u] = self.version
            S.acked[u] = S.finished[u]
            extra = per.get(u, 0.0) if per is not None else overhead
            b = float(self.agg_bytes_fn(u))
            if self._shared:
                if o is not None:
                    o.mark(f"ad:{aid}:{u}", t)
                S.agg_extra[("aggdown", aid, u)] = extra
                S.down_cell.add(t, ("aggdown", aid, u), u, b)
            else:
                fin = net.downlink_finish(u, t, b)
                if o is not None and o.tracer is not None:
                    o.tracer.span("agg_downlink", "agg", t, fin, "client", u)
                self._push(fin + extra, "aggdown_done", u)
        if self._shared:
            self._sched_cell(S.down_cell, "down_net")
        # the merge refreshed acked credit; un-gate blocked clients
        # (contributors still awaiting their download stay gated by
        # _start_round's awaiting guard)
        for u in sorted(S.blocked):
            if S.started[u] - S.acked[u] < cfg.max_inflight_rounds:
                S.blocked.discard(u)
                self._start_round(u, t)

    def _agg_download_landed(self, u, t):
        S, cfg = self._astate, self.cfg
        self.trace.append((t, "agg_downlink_done", u))
        S.awaiting[u] -= 1
        if S.awaiting[u] > 0:
            return
        del S.awaiting[u]
        S.release[u] = max(S.release[u], t)
        if u in S.blocked:
            if S.started[u] - S.acked[u] < cfg.max_inflight_rounds:
                S.blocked.discard(u)
                self._start_round(u, t)
        elif S.started[u] == S.finished[u]:
            self._start_round(u, t)

    def _async_step(self) -> bool:
        """Process ONE event from the continuous-time loop; returns False
        when the federation is complete.  The instant between two steps is
        a consistent snapshot boundary."""
        S, cfg, net = self._astate, self.cfg, self.network
        if not S.heap:
            if S.buffer:
                # tail flush: the remaining runners can no longer fill
                # the buffer to k on their own — commit what's there so
                # blocked clients regain credit and the tail of the
                # fleet reaches the global model (under plane-routed
                # aggregation the flush's transfers re-arm the heap)
                self._commit_buffer(self.now, forced=True)
                return bool(S.heap)
            return False
        t, _, kind, payload = heapq.heappop(S.heap)
        self.now = max(self.now, t)
        if kind == "uplink":
            S.queue.append(payload)
            self._try_dispatch(t)
        elif kind == "up_start":
            u, rnd = payload
            S.up_cell.add(t, payload, u, S.jobs[payload].fc_bytes)
            self._sched_cell(S.up_cell, "up_net")
        elif kind == "up_net":
            if payload != S.up_cell.version:
                return True     # contention re-timed this prediction
            arrived = False
            for tc, tid, uid in S.up_cell.advance(t):
                if tid[0] == "aggup":     # adapter sync, not a job
                    self._agg_upload_landed(tid[1], uid, tc)
                else:
                    self.trace.append((tc, "uplink_done", uid))
                    if self.obs is not None:
                        self.obs.close("uplink", "net", "uplink_s",
                                       f"ul:{uid}:{tid[1]}", tc,
                                       "client", uid)
                        self.obs.mark(f"qw:{uid}:{tid[1]}", tc)
                    S.queue.append(tid)
                    arrived = True
            if arrived:
                self._try_dispatch(t)
            self._sched_cell(S.up_cell, "up_net")
        elif kind == "served":
            take, s, t_start = payload
            ev = ServeEvent(uids=tuple(u for u, _ in take),
                            rounds=tuple(r for _, r in take),
                            slot=s, start=t_start, end=t)
            self.serves.append(ev)
            self.trace.append((t, "server_done", take[0][0]))
            if self._on_serve is not None:
                self._on_serve(ev)
            o = self.obs
            if o is not None:
                if o.tracer is not None:
                    o.tracer.span("serve", "server", t_start, t, "slot", s,
                                  attrs={"n": len(take)})
                if o.metrics is not None:
                    o.metrics.observe("serve_s", t - t_start)
                if o.ledger is not None:
                    o.ledger.server_span(ev.uids, t_start, t)
            for u, rnd in take:
                j = S.jobs[(u, rnd)]
                if self._shared and net is not None and j.bc_bytes > 0:
                    if o is not None:
                        o.mark(f"dl:{u}:{rnd}", t)
                    S.down_cell.add(t, (u, rnd), u, j.bc_bytes)
                    continue
                dl = async_downlink_instant(net, j, t)
                self.trace.append((dl, "downlink_done", u))
                self.trace.append((dl + j.t_b, "client_done", u))
                if o is not None:
                    if o.tracer is not None:
                        o.tracer.span("downlink", "net", t, dl, "client", u)
                        o.tracer.span("bwd", "compute", dl, dl + j.t_b,
                                      "client", u)
                    if o.metrics is not None:
                        o.metrics.observe("downlink_s", dl - t)
                self._push(dl + j.t_b, "client_done", (u, rnd))
            if self._shared and S.down_cell.active:
                self._sched_cell(S.down_cell, "down_net")
            self._try_dispatch(t)
        elif kind == "down_net":
            if payload != S.down_cell.version:
                return True     # contention re-timed this prediction
            for tc, tid, uid in S.down_cell.advance(t):
                if tid[0] == "aggdown":   # adapter sync, not a job
                    if self.obs is not None:
                        self.obs.close("agg_downlink", "agg", None,
                                       f"ad:{tid[1]}:{uid}", tc,
                                       "client", uid)
                    extra = S.agg_extra.pop(tid, 0.0)
                    self._push(tc + extra, "aggdown_done", uid)
                    continue
                j = S.jobs[tid]
                self.trace.append((tc, "downlink_done", uid))
                self.trace.append((tc + j.t_b, "client_done", uid))
                if self.obs is not None:
                    self.obs.close("downlink", "net", "downlink_s",
                                   f"dl:{uid}:{tid[1]}", tc, "client", uid)
                    if self.obs.tracer is not None:
                        self.obs.tracer.span("bwd", "compute", tc,
                                             tc + j.t_b, "client", uid)
                self._push(tc + j.t_b, "client_done", tid)
            self._sched_cell(S.down_cell, "down_net")
        elif kind == "aggup_done":
            aid, u = payload
            self._agg_upload_landed(aid, u, t)
        elif kind == "aggdown_done":
            self._agg_download_landed(payload, t)
        elif kind == "client_done":
            u, rnd = payload
            S.finished[u] += 1
            S.free_at[u] = t
            S.buffer[u] = rnd
            if self.obs is not None and self.obs.ledger is not None:
                self.obs.ledger.client_span(u, S.jobs[payload].arrival, t)
            if len(S.buffer) >= cfg.buffer_k:
                self._commit_buffer(t, forced=False)
            if u not in S.blocked and S.started[u] == rnd + 1:
                self._start_round(u, t)
        return True

    # ------------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        """Fully JSON-able mid-flight snapshot of the clock.

        Captures the global timeline (now/version/serves/commits/trace),
        the sync wave index, and — when the async loop is live — the whole
        event-loop state: the heap with in-flight rounds and their version
        stamps, per-policy aggregation buffers and staleness bookkeeping,
        inflight credits, and the shared cells' integrator state.  Taking
        a snapshot is a pure read; ``load_state_dict`` on a freshly
        constructed clock (same constructor arguments) followed by
        :meth:`run` continues the timeline bit-for-bit (regression-tested
        in tests/test_async_engine.py).  Floats survive the JSON round
        trip exactly (CPython repr).  See docs/checkpointing.md."""
        st = {
            "schema": 1,
            "now": self.now,
            "version": self.version,
            "sync_rnd": self._sync_rnd,
            "serves": [[list(e.uids), list(e.rounds), e.slot, e.start, e.end]
                       for e in self.serves],
            "commits": [[c.time, c.version, list(c.contributors),
                         list(c.staleness), c.forced, c.overhead]
                        for c in self.commits],
            "dropped": [list(d) for d in self.dropped],
            "trace": [list(e) for e in self.trace],
            "round_results": [self._enc_round(r) for r in self.round_results],
            "async": None,
        }
        S = self._astate
        if S is not None:
            st["async"] = {
                "heap": [[t, seq, kind, encode_tuples(p)]
                         for t, seq, kind, p in S.heap],
                "seq": S.seq, "agg_seq": S.agg_seq,
                "started": list(S.started), "finished": list(S.finished),
                "acked": list(S.acked),
                "model_version": list(S.model_version),
                "release": list(S.release), "free_at": list(S.free_at),
                "blocked": sorted(S.blocked),
                "jobs": [[u, r, [j.t_f, j.t_fc, j.t_s, j.t_bc, j.t_b,
                                 j.arrival, j.priority, j.fc_bytes,
                                 j.bc_bytes]]
                         for (u, r), j in S.jobs.items()],
                "queue": [list(e) for e in S.queue],
                "slot_free": list(S.slot_free),
                "buffer": [[u, r] for u, r in S.buffer.items()],
                "pending_aggs": [[aid, list(info["contribs"]),
                                  sorted(info["left"]), info["forced"]]
                                 for aid, info in S.pending_aggs.items()],
                "awaiting": [[u, k] for u, k in S.awaiting.items()],
                "agg_extra": [[encode_tuples(tid), x]
                              for tid, x in S.agg_extra.items()],
                "up_cell": S.up_cell.state_dict() if S.up_cell else None,
                "down_cell": S.down_cell.state_dict() if S.down_cell else None,
            }
        return st

    def load_state_dict(self, st: dict) -> None:
        """Restore a :meth:`state_dict` snapshot onto a freshly constructed
        clock (same n_clients/rounds/cfg/network/callables).  The next
        :meth:`run` call continues mid-flight instead of starting over."""
        if st.get("schema") != 1:
            raise ValueError(f"unknown clock snapshot schema "
                             f"{st.get('schema')!r}")
        self.now = float(st["now"])
        self.version = int(st["version"])
        self._sync_rnd = int(st["sync_rnd"])
        self.serves = [ServeEvent(uids=tuple(u), rounds=tuple(r), slot=s,
                                  start=t0, end=t1)
                       for u, r, s, t0, t1 in st["serves"]]
        self.commits = [CommitEvent(time=t, version=v,
                                    contributors=tuple(c),
                                    staleness=tuple(s), forced=f,
                                    overhead=o)
                        for t, v, c, s, f, o in st["commits"]]
        self.dropped = [tuple(d) for d in st["dropped"]]
        self.trace = [tuple(e) for e in st["trace"]]
        self.round_results = [self._dec_round(r) for r in st["round_results"]]
        A = st["async"]
        if A is None:
            self._astate = None
            return
        S = self._astate = self._async_fresh()
        S.heap = [(t, seq, kind, decode_tuples(p))
                  for t, seq, kind, p in A["heap"]]
        S.seq, S.agg_seq = int(A["seq"]), int(A["agg_seq"])
        S.started = [int(x) for x in A["started"]]
        S.finished = [int(x) for x in A["finished"]]
        S.acked = [int(x) for x in A["acked"]]
        S.model_version = [int(x) for x in A["model_version"]]
        S.release = [float(x) for x in A["release"]]
        S.free_at = [float(x) for x in A["free_at"]]
        S.blocked = set(A["blocked"])
        S.jobs = {(u, r): Job(uid=u, t_f=f[0], t_fc=f[1], t_s=f[2],
                              t_bc=f[3], t_b=f[4], arrival=f[5],
                              priority=f[6], fc_bytes=f[7], bc_bytes=f[8])
                  for u, r, f in A["jobs"]}
        S.queue = [tuple(e) for e in A["queue"]]
        S.slot_free = [float(x) for x in A["slot_free"]]
        S.buffer = {int(u): int(r) for u, r in A["buffer"]}
        S.pending_aggs = {int(aid): {"contribs": tuple(c), "left": set(left),
                                     "forced": bool(f)}
                          for aid, c, left, f in A["pending_aggs"]}
        S.awaiting = {int(u): int(k) for u, k in A["awaiting"]}
        S.agg_extra = {decode_tuples(tid): float(x)
                       for tid, x in A["agg_extra"]}
        if A["up_cell"] is not None:
            S.up_cell.load_state_dict(A["up_cell"])
        if A["down_cell"] is not None:
            S.down_cell.load_state_dict(A["down_cell"])

    @staticmethod
    def _enc_round(res: EngineResult) -> dict:
        return {"round_time": res.round_time,
                "service": [[r.slot, list(r.uids), r.start, r.end]
                            for r in res.service],
                "completion": [[u, t] for u, t in res.completion.items()],
                "waits": [[u, w] for u, w in res.waits.items()],
                "dropped": list(res.dropped),
                "events": [list(e) for e in res.events]}

    @staticmethod
    def _dec_round(st: dict) -> EngineResult:
        return EngineResult(
            round_time=float(st["round_time"]),
            service=[ServiceRecord(slot=s, uids=tuple(u), start=t0, end=t1)
                     for s, u, t0, t1 in st["service"]],
            completion={int(u): float(t) for u, t in st["completion"]},
            waits={int(u): float(w) for u, w in st["waits"]},
            dropped=[int(u) for u in st["dropped"]],
            events=[tuple(e) for e in st["events"]])

    # ---------------------------------------------------------------- commit
    def _commit(self, contributors, staleness, on_commit, *, time=None,
                forced=False) -> Tuple[float, Optional[Dict[int, float]]]:
        """Record one aggregation commit.  ``on_commit`` may return a scalar
        (seconds added for every contributor — the legacy redistribute
        transfer) or a ``{uid: seconds}`` mapping (per-contributor charges:
        plane-priced migrations, ragged redistributes; uids absent from the
        mapping pay nothing).  Returns ``(scalar, per_uid)`` where scalar is
        the mapping's max (what a sync barrier waits for) and per_uid is
        None for scalar returns."""
        t = self.now if time is None else time
        self.version += 1
        ev = CommitEvent(time=t, version=self.version,
                         contributors=tuple(contributors),
                         staleness=tuple(staleness), forced=forced)
        overhead, per_uid = 0.0, None
        if on_commit is not None:
            ret = on_commit(ev)
            if isinstance(ret, Mapping):
                per_uid = {int(u): float(s) for u, s in ret.items()}
                overhead = max(per_uid.values(), default=0.0)
            elif ret is not None:
                overhead = float(ret)
        ev = dataclasses.replace(ev, overhead=overhead)
        self.commits.append(ev)
        if self.obs is not None:
            record_commit(self.obs, ev)
        self.now = max(self.now, t + overhead)
        return overhead, per_uid
