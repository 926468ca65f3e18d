"""Bulk span/metric emission for the DES engines.

The engines call these AFTER their timing math is done, on values already
computed — every function here is a pure read of engine results, so
enabling observability cannot perturb a single float of the timeline
(the obs-on == obs-off bit-exactness grid in tests/test_obs_parity.py is
the contract).  The vectorized kernels emit whole rounds per call
(``record_round_arrays`` / ``record_async_bulk``): NumPy column passes +
``Tracer.add_spans``, no per-event Python on the fast path.

Span taxonomy (see docs/observability.md):

  track "client" u : fwd(compute) uplink(net) queue_wait(queue)
                     downlink(net) bwd(compute) agg_uplink(agg)
                     agg_downlink(agg) dropped(drop)
  track "slot" s   : serve(server)
  track "fleet" 0  : commit(agg)
  track "control" 0: reassign(control)
  track "edge" e   : edge_sync(agg)
  track "cell" 0/1 : occupancy counter (0=up, 1=down)
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.obs.ledger import MemoryLedger
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import Tracer

__all__ = ["Observability", "record_async_bulk", "record_commit",
           "record_round_arrays", "record_sync_wave"]


class Observability:
    """The bundle the engines carry: any subset of tracer / metrics /
    ledger, each None when disabled.  ``enabled`` is False for an empty
    bundle — engines guard every emission on it, so a disabled plane
    costs one attribute check per hook."""

    def __init__(self, tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 ledger: Optional[MemoryLedger] = None):
        self.tracer = tracer
        self.metrics = metrics
        self.ledger = ledger
        # open cross-event instants (shared-medium transfers whose finish
        # is only known when the cell pops them): key -> start time.
        # Serialized with the bundle so kill/resume closes them identically.
        self._marks = {}

    @property
    def enabled(self) -> bool:
        return (self.tracer is not None or self.metrics is not None
                or self.ledger is not None)

    # -------------------------------------------------- cross-event pairing
    def mark(self, key: str, t: float) -> None:
        """Open a cross-event interval (finish instant not yet known)."""
        self._marks[key] = float(t)

    def close(self, name: str, cat: str, metric: Optional[str], key: str,
              t: float, kind: str, tid: int) -> None:
        """Close a :meth:`mark`-ed interval: emit the span and (when
        ``metric`` is given) fold the duration into a histogram.  Silently
        a no-op when ``key`` is not open — the dedicated-link paths emit
        eagerly and never mark."""
        t0 = self._marks.pop(key, None)
        if t0 is None:
            return
        if self.tracer is not None:
            self.tracer.span(name, cat, t0, t, kind, tid)
        if metric is not None and self.metrics is not None:
            self.metrics.observe(metric, t - t0)

    # ------------------------------------------------------- shared-cell hook
    def cell_note(self, t: float, occupancy: int, direction: int,
                  event: str) -> None:
        """One shared-cell state change: ``direction`` 0=up 1=down,
        ``event`` "add" | "pop"."""
        if self.tracer is not None:
            self.tracer.counter("occupancy", t, occupancy, "cell", direction)
        if self.metrics is not None:
            if event == "add":
                self.metrics.inc("cell_transfers")
                if occupancy > 1:
                    # admitting into a busy cell re-times every survivor
                    self.metrics.inc("cell_retimings", occupancy - 1)
            else:
                self.metrics.inc("cell_completions")

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        return {
            "tracer": self.tracer.state_dict() if self.tracer else None,
            "metrics": self.metrics.state_dict() if self.metrics else None,
            "ledger": self.ledger.state_dict() if self.ledger else None,
            "marks": dict(self._marks),
        }

    def load_state_dict(self, st: dict) -> None:
        self._marks = {str(k): float(v)
                       for k, v in st.get("marks", {}).items()}
        if st.get("tracer") is not None:
            if self.tracer is None:
                self.tracer = Tracer()
            self.tracer.load_state_dict(st["tracer"])
        if st.get("metrics") is not None:
            if self.metrics is None:
                self.metrics = MetricsRegistry()
            self.metrics.load_state_dict(st["metrics"])
        if st.get("ledger") is not None and self.ledger is not None:
            self.ledger.load_state_dict(st["ledger"])


def record_commit(obs: Observability, ev) -> None:
    """One aggregation commit (``engine.CommitEvent``) on the fleet track."""
    if obs.tracer is not None:
        obs.tracer.span("commit", "agg", ev.time, ev.time + ev.overhead,
                        "fleet", 0,
                        attrs={"version": ev.version,
                               "contributors": len(ev.contributors),
                               "forced": bool(ev.forced)})
    if obs.metrics is not None:
        obs.metrics.inc("commits")
        if ev.forced:
            obs.metrics.inc("commits_forced")
        obs.metrics.observe("commit_overhead_s", ev.overhead)
        if ev.staleness:
            obs.metrics.observe_bulk("staleness", np.asarray(ev.staleness,
                                                             dtype=np.float64))


def record_sync_wave(obs: Observability, res, jobs, base: float,
                     rnd: int) -> None:
    """Post-hoc emission for one per-object sync barrier wave.

    ``res`` is the ``EngineResult`` ``simulate_round`` returned for this
    wave (round-relative times), ``jobs`` its input jobs, ``base`` the
    global instant of the wave's t=0.  Reads only completed results —
    never touches the engine's arithmetic.
    """
    up, dl = {}, {}
    for t, kind, u in res.events:
        if kind == "uplink_done":
            up[u] = t
        elif kind == "downlink_done":
            dl[u] = t
    end_of = {u: rec.end for rec in res.service for u in rec.uids}
    tr, mx, lg = obs.tracer, obs.metrics, obs.ledger
    for j in jobs:
        u = j.uid
        if u not in end_of:          # dropped by the deadline
            if tr is not None:
                tr.instant("dropped", "drop", base + res.round_time,
                           "client", u)
            continue
        fwd = j.arrival + j.t_f
        if tr is not None:
            tr.span("fwd", "compute", base + j.arrival, base + fwd,
                    "client", u)
            tr.span("uplink", "net", base + fwd, base + up[u], "client", u)
            tr.span("queue_wait", "queue", base + up[u],
                    base + up[u] + res.waits[u], "client", u)
            tr.span("downlink", "net", base + end_of[u], base + dl[u],
                    "client", u)
            tr.span("bwd", "compute", base + dl[u],
                    base + res.completion[u], "client", u)
        if lg is not None:
            lg.client_span(u, base + j.arrival, base + res.completion[u])
    for rec in res.service:
        if tr is not None:
            tr.span("serve", "server", base + rec.start, base + rec.end,
                    "slot", rec.slot, attrs={"n": len(rec.uids),
                                             "round": rnd})
        if lg is not None:
            lg.server_span(rec.uids, base + rec.start, base + rec.end)
    if mx is not None:
        served_uids = sorted(end_of)
        fwd_of = {j.uid: j.arrival + j.t_f for j in jobs}
        mx.observe_bulk("queue_wait",
                        [res.waits[u] for u in served_uids], round=rnd)
        mx.observe_bulk("uplink_s",
                        [up[u] - fwd_of[u] for u in served_uids], round=rnd)
        mx.observe_bulk("downlink_s",
                        [dl[u] - end_of[u] for u in served_uids], round=rnd)
        mx.observe_bulk("serve_s", [rec.end - rec.start
                                    for rec in res.service], round=rnd)
        if res.dropped:
            mx.inc("dropped", len(res.dropped))


def record_round_arrays(obs: Observability, *, arrays, ready_arr, service,
                        served, dl, completion, waits, idx, dropped,
                        t_origin: float, rnd: int = 0) -> None:
    """Bulk emission for one ``vectorized_round`` invocation, from the
    kernel's own internal arrays/dicts after it finished — NumPy column
    passes and ``add_spans``, no per-event Python objects."""
    tr, mx, lg = obs.tracer, obs.metrics, obs.ledger
    if not served:
        if tr is not None:
            for u in dropped:
                tr.instant("dropped", "drop", t_origin, "client", u)
        return
    su = np.fromiter((u for u, _ in served), dtype=np.int64,
                     count=len(served))
    send = np.fromiter((e for _, e in served), dtype=np.float64,
                       count=len(served))
    pos = np.fromiter((idx[int(u)] for u in su), dtype=np.int64,
                      count=len(su))
    dlv = np.fromiter((dl[int(u)] for u in su), dtype=np.float64,
                      count=len(su))
    comp = np.fromiter((completion[int(u)] for u in su), dtype=np.float64,
                       count=len(su))
    w = np.fromiter((waits[int(u)] for u in su), dtype=np.float64,
                    count=len(su))
    arr = arrays.arrival[pos]
    fwd = arr + arrays.t_f[pos]
    rdy = ready_arr[pos]
    if tr is not None:
        tr.add_spans("fwd", "compute", t_origin + arr, t_origin + fwd,
                     "client", su)
        tr.add_spans("uplink", "net", t_origin + fwd, t_origin + rdy,
                     "client", su)
        tr.add_spans("queue_wait", "queue", t_origin + rdy,
                     t_origin + rdy + w, "client", su)
        tr.add_spans("downlink", "net", t_origin + send, t_origin + dlv,
                     "client", su)
        tr.add_spans("bwd", "compute", t_origin + dlv, t_origin + comp,
                     "client", su)
        for rec in service:
            tr.span("serve", "server", t_origin + rec.start,
                    t_origin + rec.end, "slot", rec.slot,
                    attrs={"n": len(rec.uids), "round": rnd})
        for u in dropped:
            tr.instant("dropped", "drop", t_origin, "client", u)
    if mx is not None:
        mx.observe_bulk("queue_wait", w)
        mx.observe_bulk("uplink_s", rdy - fwd)
        mx.observe_bulk("downlink_s", dlv - send)
        mx.observe_bulk("serve_s",
                        np.fromiter((rec.end - rec.start for rec in service),
                                    dtype=np.float64, count=len(service)))
        if dropped:
            mx.inc("dropped", len(dropped))
    if lg is not None:
        lg.client_span_bulk(su, t_origin + arr, t_origin + comp)
        for rec in service:
            lg.server_span(rec.uids, t_origin + rec.start,
                           t_origin + rec.end)


def record_async_bulk(obs: Observability, serves, commits, t0_of,
                      times: dict, up_dur, down_dur, has_fc,
                      has_bc) -> None:
    """Bulk emission for one ``run_async_vectorized`` run, after the event
    loop finished.  ``t0_of`` maps ``(uid, rnd) -> round-entry instant``
    (recorded by the kernel only when obs is on); transfer instants are
    reconstructed from the same precomputed per-client durations the
    kernel dispatched with, so every span boundary equals the loop's own
    floats."""
    tr, mx, lg = obs.tracer, obs.metrics, obs.ledger
    t_f = np.asarray(times["t_f"], dtype=np.float64)
    t_fc = np.asarray(times["t_fc"], dtype=np.float64)
    t_bc = np.asarray(times["t_bc"], dtype=np.float64)
    t_b = np.asarray(times["t_b"], dtype=np.float64)
    upd = np.asarray(up_dur, dtype=np.float64)
    dnd = np.asarray(down_dur, dtype=np.float64)
    fc = np.asarray(has_fc, dtype=bool)
    bc = np.asarray(has_bc, dtype=bool)
    flat = [(u, r, ev.start, ev.end)
            for ev in serves for u, r in zip(ev.uids, ev.rounds)]
    if flat:
        su = np.fromiter((f[0] for f in flat), dtype=np.int64,
                         count=len(flat))
        start = np.fromiter((f[2] for f in flat), dtype=np.float64,
                            count=len(flat))
        end = np.fromiter((f[3] for f in flat), dtype=np.float64,
                          count=len(flat))
        t0 = np.fromiter((t0_of[(f[0], f[1])] for f in flat),
                         dtype=np.float64, count=len(flat))
        fwd = t0 + t_f[su]
        rdy = np.where(fc[su], fwd + upd[su], fwd + t_fc[su])
        dlv = np.where(bc[su], end + dnd[su], end + t_bc[su])
        done = dlv + t_b[su]
        if tr is not None:
            tr.add_spans("fwd", "compute", t0, fwd, "client", su)
            tr.add_spans("uplink", "net", fwd, rdy, "client", su)
            tr.add_spans("queue_wait", "queue", rdy, start, "client", su)
            tr.add_spans("downlink", "net", end, dlv, "client", su)
            tr.add_spans("bwd", "compute", dlv, done, "client", su)
            for ev in serves:
                tr.span("serve", "server", ev.start, ev.end, "slot",
                        ev.slot, attrs={"n": len(ev.uids)})
        if mx is not None:
            mx.observe_bulk("queue_wait", start - rdy)
            mx.observe_bulk("uplink_s", rdy - fwd)
            mx.observe_bulk("downlink_s", dlv - end)
            mx.observe_bulk(
                "serve_s",
                np.fromiter((ev.end - ev.start for ev in serves),
                            dtype=np.float64, count=len(serves)))
        if lg is not None:
            lg.client_span_bulk(su, t0, done)
            for ev in serves:
                lg.server_span(ev.uids, ev.start, ev.end)
    for cv in commits:
        record_commit(obs, cv)
