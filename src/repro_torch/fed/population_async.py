"""Population-scale async federation: a struct-of-arrays event kernel.

``FederationClock``'s buffered/staleness loop paces every client
individually: each local round is its own arrival, uploads from different
rounds interleave in the server queue, and commits fire on the k-of-U
buffer count.  The per-object implementation builds a ``Job`` object, a
dict entry and several trace tuples per client-round and re-sorts a live
Python queue at every dispatch — fine for six phones, hopeless for the
ROADMAP's 10^5-client fleets.

This module is the scale path for that loop.  State is struct-of-arrays
(``JobArrays``-style per-client columns: next-event times, release/free
instants, in-flight round credits, model-version vector for the
staleness ``(1+s)^-alpha`` lineage), and the per-event updates are the
PURE functions ``engine.async_uplink_instant`` / ``async_downlink_instant``
applied elementwise over precomputed per-client transfer durations.  The
event heap itself stays scalar — bit-exactness with the per-object DES is
the regression anchor (the parity discipline of the engines) and both heap order
(global push-sequence tiebreak) and the ``max``/``+`` dispatch chains are
order-sensitive — but everything per-client behind it is array state, so
the kernel allocates no per-round objects at all.

Queue disciplines mirror ``vectorized_round``: "fifo"/"wf"/"priority"
keys are static per job and serve from a lazily-fed key heap (each job
pushed exactly once, O(log n) per event); "bw" re-keys the still-queued
set as arrays at each dispatch boundary through the batched rate query.

Scope (exactly the regime ``PopulationClock`` dispatches here): dedicated
constant-rate links, no aggregation-transport routing (commit overhead 0
unless a real-math ``on_commit`` returns a redistribute charge — the
``on_round_start``/``on_serve``/``on_commit`` hooks mirror the engine's
callback contract and are byte-free no-ops when None, so the timing-only
kernel is untouched).  Shared-medium cells integrate one contention
process across all transfers and stay per-object by contract; the
per-object ``FederationClock`` below ``population_threshold`` is the
parity oracle (tests/test_population_async.py pins timelines
float-for-float).

Copied from the JAX package's ``fed/population_async.py`` with its imports pointed into
the port; ``tests/test_torch_copies.py`` pins it bit for bit.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections.abc import Mapping
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import chunked_service_time
from repro_torch.fed.engine import (ClockConfig, ClockResult, CommitEvent,
                              ServeEvent)
from repro_torch.fed.population import _chunk_smallest
from repro_torch.obs import Observability, record_async_bulk

__all__ = ["run_async_vectorized"]


def run_async_vectorized(times: Dict[str, np.ndarray], rounds: int,
                         cfg: ClockConfig, *,
                         up_rate_mbps: np.ndarray,
                         down_rate_mbps: np.ndarray,
                         priorities: Optional[np.ndarray] = None,
                         collect_trace: bool = True,
                         obs: Optional[Observability] = None,
                         on_serve=None, on_commit=None, on_round_start=None
                         ) -> Tuple[ClockResult, int]:
    """Run ``rounds`` async local rounds per client over SoA state.

    ``times`` holds full-fleet float64 columns (``step_time_arrays``
    keys: t_f/t_fc/t_s/t_bc/t_b/fc_bytes/bc_bytes); ``up_rate_mbps`` /
    ``down_rate_mbps`` are each client's dedicated constant link rates.
    Returns ``(ClockResult, n_events)`` where the result's timeline is
    bit-identical to ``FederationClock.run()`` on the same inputs and
    ``n_events`` counts the trace entries the per-object clock would have
    recorded (maintained even with ``collect_trace=False``, the bench
    path that skips building the O(events) tuple list).
    """
    if cfg.agg_policy == "sync":
        raise ValueError("run_async_vectorized serves the async policies; "
                         "sync barriers go through vectorized_round")
    n = int(np.asarray(times["t_f"]).shape[0])
    if n < 1 or rounds < 1:
        raise ValueError("need at least one client and one round")
    if cfg.buffer_k > n:
        raise ValueError(f"buffer_k={cfg.buffer_k} exceeds the "
                         f"{n}-client fleet")
    if cfg.policy == "priority" and priorities is None:
        raise ValueError("the priority discipline needs per-client "
                         "priorities")

    # Scalar Python-float copies for the event loop: float64 round-trips
    # unchanged through tolist(), and the per-event arithmetic below must
    # be the per-object expressions operand-for-operand.
    t_f = np.asarray(times["t_f"], dtype=np.float64).tolist()
    t_fc = np.asarray(times["t_fc"], dtype=np.float64).tolist()
    t_s = np.asarray(times["t_s"], dtype=np.float64).tolist()
    t_bc = np.asarray(times["t_bc"], dtype=np.float64).tolist()
    t_b = np.asarray(times["t_b"], dtype=np.float64).tolist()
    fc_bytes = np.asarray(times["fc_bytes"], dtype=np.float64)
    bc_bytes = np.asarray(times["bc_bytes"], dtype=np.float64)
    up_bps = np.asarray(up_rate_mbps, dtype=np.float64) * 1e6
    down_bps = np.asarray(down_rate_mbps, dtype=np.float64) * 1e6
    for name, a in (("fc_bytes", fc_bytes), ("bc_bytes", bc_bytes),
                    ("up_rate_mbps", up_bps), ("down_rate_mbps", down_bps)):
        if a.shape != (n,):
            raise ValueError(f"{name} must be one value per client")
    # ConstantLink.finish_time(t, b) = t + b * 8.0 / (rate_mbps * 1e6):
    # precompute the per-client quotient once — the elementwise division
    # is the identical expression, so (instant + dur) reproduces every
    # per-object transfer finish bit-for-bit.
    up_dur = (fc_bytes * 8.0 / up_bps).tolist()
    down_dur = (bc_bytes * 8.0 / down_bps).tolist()
    has_fc = (fc_bytes > 0).tolist()
    has_bc = (bc_bytes > 0).tolist()

    dynamic_bw = cfg.policy == "bw"
    if cfg.policy == "wf":
        static_key = [-x for x in t_s]
    elif cfg.policy == "priority":
        static_key = (-np.asarray(priorities, dtype=np.float64)).tolist()
    else:
        static_key = None       # fifo: per-round nominal ready; bw: dynamic
    if dynamic_bw:
        bc_arr, t_bc_arr = bc_bytes, np.asarray(times["t_bc"])
        t_b_arr = np.asarray(times["t_b"])
        uid_arr = np.arange(n)
        queued = np.zeros(n, dtype=bool)
        queued_rnd = [0] * n
        n_queued = 0

    # ---------------------------------------------------------------- state
    # per-client columns (the SoA mirror of engine._AsyncState)
    started = [0] * n
    finished = [0] * n
    acked = [0] * n
    model_version = [0] * n
    release = [0.0] * n
    free_at = [0.0] * n
    blocked: set = set()
    buffer: Dict[int, int] = {}
    slot_free = [0.0] * cfg.slots
    heap: List[tuple] = []      # (t, seq, kind, payload); seq = push order
    seq = 0
    version = 0
    now = 0.0
    n_events = 0
    serves: List[ServeEvent] = []
    commits: List[CommitEvent] = []
    trace: List[Tuple[float, str, int]] = []
    # round-entry instants for the post-run bulk obs emission; recorded
    # only when a sink is live so the hot loop stays allocation-free
    obs = obs if obs is not None and obs.enabled else None
    t0_of: Dict[Tuple[int, int], float] = {}

    def push(t, kind, payload):
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, payload))
        seq += 1

    if not dynamic_bw:
        key_heap: List[Tuple[float, int, int]] = []   # (key, uid, rnd)

    def start_round(u, t):
        nonlocal n_events
        if started[u] >= rounds:
            return
        if started[u] - acked[u] >= cfg.max_inflight_rounds:
            blocked.add(u)
            if obs is not None and obs.metrics is not None:
                obs.metrics.inc("credit_gate_stalls")
            return
        rnd = started[u]
        started[u] += 1
        t0 = max(t, release[u], free_at[u])
        if obs is not None:
            t0_of[(u, rnd)] = t0
        if on_round_start is not None:
            on_round_start(u, rnd, t0)
        fwd = t0 + t_f[u]
        if collect_trace:
            trace.append((fwd, "fwd_done", u))
        # engine.async_uplink_instant elementwise: the plane resolves the
        # queue-entry instant, the QUEUE KEY stays the nominal Job.ready
        ready = fwd + up_dur[u] if has_fc[u] else fwd + t_fc[u]
        if collect_trace:
            trace.append((ready, "uplink_done", u))
        n_events += 2
        key = 0.0
        if not dynamic_bw:
            key = static_key[u] if static_key is not None else fwd + t_fc[u]
        push(ready, "uplink", (u, rnd, key))

    def try_dispatch(t):
        nonlocal n_queued, n_events
        while (n_queued if dynamic_bw else len(key_heap)):
            s = min(range(cfg.slots), key=lambda i: slot_free[i])
            if slot_free[s] > t:
                return
            if dynamic_bw:
                q = np.flatnonzero(queued)
                b = bc_arr[q]
                # engine._net_bw_key batched (dedicated constant rates are
                # always > 0): (t + bits/rate) - t keeps operand grouping
                dl = (t + b * 8.0 / down_bps[q]) - t
                dl = np.where(b > 0.0, dl, t_bc_arr[q])
                keys = -(dl + t_b_arr[q])
                sel = q[_chunk_smallest(keys, uid_arr[q], cfg.cohort_chunk)]
                take = [(int(u), queued_rnd[u]) for u in sel]
                queued[sel] = False
                n_queued -= len(take)
            else:
                take = []
                for _ in range(min(cfg.cohort_chunk, len(key_heap))):
                    _, u, rnd = heapq.heappop(key_heap)
                    take.append((u, rnd))
            span = chunked_service_time([t_s[u] for u, _ in take],
                                        cfg.chunk_efficiency)
            slot_free[s] = t + span
            if collect_trace:
                trace.append((t, "server_start", take[0][0]))
            n_events += 1
            push(t + span, "served", (tuple(take), s, t))

    def do_commit(t, forced):
        nonlocal version, now
        contribs = tuple(sorted(buffer))
        stal = tuple(version - model_version[u] for u in contribs)
        version += 1
        ev = CommitEvent(time=t, version=version, contributors=contribs,
                         staleness=stal, forced=forced)
        # engine._commit's overhead contract: a real-math on_commit may
        # return a scalar redistribute charge or a {uid: seconds} mapping;
        # with no callback the overhead stays 0.0 — byte-identical to the
        # timing-only kernel
        overhead, per_uid = 0.0, None
        if on_commit is not None:
            ret = on_commit(ev)
            if isinstance(ret, Mapping):
                per_uid = {int(u): float(s) for u, s in ret.items()}
                overhead = max(per_uid.values(), default=0.0)
            elif ret is not None:
                overhead = float(ret)
        commits.append(dataclasses.replace(ev, overhead=overhead))
        now = max(now, t + overhead)
        for u in contribs:
            model_version[u] = version
            acked[u] = finished[u]
            release[u] = t + (per_uid.get(u, 0.0) if per_uid is not None
                              else overhead)
        buffer.clear()
        for u in sorted(blocked):
            if started[u] - acked[u] < cfg.max_inflight_rounds:
                blocked.discard(u)
                start_round(u, t)

    # ----------------------------------------------------------- event loop
    for u in range(n):
        start_round(u, 0.0)
    while True:
        if not heap:
            if buffer:
                # tail flush at the current clock; unblocked clients may
                # re-arm the heap with fresh rounds
                do_commit(now, forced=True)
                if heap:
                    continue
            break
        t, _, kind, payload = heapq.heappop(heap)
        now = max(now, t)
        if kind == "uplink":
            u, rnd, key = payload
            if dynamic_bw:
                queued[u] = True
                queued_rnd[u] = rnd
                n_queued += 1
            else:
                heapq.heappush(key_heap, (key, u, rnd))
            try_dispatch(t)
        elif kind == "served":
            take, s, t_start = payload
            ev = ServeEvent(uids=tuple(u for u, _ in take),
                            rounds=tuple(r for _, r in take),
                            slot=s, start=t_start, end=t)
            serves.append(ev)
            if on_serve is not None:
                on_serve(ev)
            if collect_trace:
                trace.append((t, "server_done", take[0][0]))
            n_events += 1
            for u, rnd in take:
                # engine.async_downlink_instant elementwise
                dl = t + down_dur[u] if has_bc[u] else t + t_bc[u]
                done = dl + t_b[u]
                if collect_trace:
                    trace.append((dl, "downlink_done", u))
                    trace.append((done, "client_done", u))
                n_events += 2
                push(done, "client_done", (u, rnd))
            try_dispatch(t)
        else:   # client_done
            u, rnd = payload
            finished[u] += 1
            free_at[u] = t
            buffer[u] = rnd
            if len(buffer) >= cfg.buffer_k:
                do_commit(t, forced=False)
            if u not in blocked and started[u] == rnd + 1:
                start_round(u, t)

    trace.sort(key=lambda e: (e[0], e[1], e[2]))
    if obs is not None:
        # one bulk pass after the loop: spans/metrics/ledger reconstructed
        # from the same precomputed durations the loop dispatched with
        record_async_bulk(obs, serves, commits, t0_of, times, up_dur,
                          down_dur, has_fc, has_bc)
    done_count = {u: 0 for u in range(n)}
    for ev in serves:
        for u in ev.uids:
            done_count[u] += 1
    res = ClockResult(makespan=now, serves=serves, commits=commits,
                      rounds_completed=done_count, dropped=[],
                      round_results=[], events=trace, preempted=False)
    return res, n_events
