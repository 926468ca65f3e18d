"""Span tracer for the DES hot paths: simulated-time spans + counters,
columnar storage, Chrome/Perfetto ``trace_event`` export.

Every record lives on a *track* ``(kind, tid)`` — ``("client", uid)``,
``("slot", s)``, ``("cell", 0|1)``, ``("edge", eid)``, ``("agg", aid)``,
``("control", 0)``, ``("fleet", 0)`` — which the exporter maps to one
Perfetto process per kind and one thread per tid, so a 16-client run
opens in ``chrome://tracing`` as 16 client swimlanes next to the server
slots and the shared-medium cells.

Storage is columnar (parallel Python lists; ``to_arrays`` gives NumPy
views) so the vectorized population kernels can bulk-append whole
rounds with ``add_spans`` — no per-event Python objects on the fast
path.  ``max_events`` bounds memory as a ring: the OLDEST spans fall
off first and ``dropped_spans``/``dropped_counters`` record how many.

Cross-event spans (a shared-medium transfer whose finish instant is
only known when the cell pops it) pair through ``begin(key, t)`` /
``end(name, cat, key, t, ...)``; the open-key table serializes with the
tracer, so a kill/resume at any event boundary replays to the same
trace as an uninterrupted run (pinned in tests/test_obs_parity.py).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Tracer", "Span", "TRACK_PIDS"]

# stable Perfetto pid per track kind (key order is the display order)
TRACK_PIDS: Dict[str, int] = {"client": 1, "slot": 2, "agg": 3, "cell": 4,
                              "edge": 5, "control": 6, "fleet": 7}


class Span:
    """One completed span, materialized from the columnar store (a
    convenience view for tests and ``tools/trace_summary.py`` — the hot
    paths never build these)."""
    __slots__ = ("name", "cat", "t_start", "t_end", "track", "attrs")

    def __init__(self, name, cat, t_start, t_end, track, attrs):
        self.name, self.cat = name, cat
        self.t_start, self.t_end = t_start, t_end
        self.track, self.attrs = track, attrs

    @property
    def dur(self) -> float:
        return self.t_end - self.t_start

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, {self.cat!r}, "
                f"[{self.t_start:.6f}, {self.t_end:.6f}], {self.track})")


class Tracer:
    """Columnar span/counter recorder in SIMULATED seconds."""

    def __init__(self, max_events: Optional[int] = None):
        if max_events is not None and max_events <= 0:
            raise ValueError("max_events must be > 0")
        self.max_events = max_events
        self.dropped_spans = 0
        self.dropped_counters = 0
        # span columns
        self._name: List[str] = []
        self._cat: List[str] = []
        self._t0: List[float] = []
        self._t1: List[float] = []
        self._tkind: List[str] = []
        self._tid: List[int] = []
        self._attrs: List[Optional[dict]] = []
        # counter columns ("C" events: a value sampled at an instant)
        self._cname: List[str] = []
        self._ct: List[float] = []
        self._cval: List[float] = []
        self._ckind: List[str] = []
        self._cid: List[int] = []
        # open cross-event spans: key -> start time
        self._open: Dict[str, float] = {}

    # ------------------------------------------------------------- recording
    def span(self, name: str, cat: str, t_start: float, t_end: float,
             kind: str, tid: int, attrs: Optional[dict] = None) -> None:
        """Record one completed span on track ``(kind, tid)``."""
        self._name.append(name)
        self._cat.append(cat)
        self._t0.append(float(t_start))
        self._t1.append(float(t_end))
        self._tkind.append(kind)
        self._tid.append(int(tid))
        self._attrs.append(attrs)
        if self.max_events is not None and len(self._name) > self.max_events:
            self._trim_spans(len(self._name) - self.max_events)

    def instant(self, name: str, cat: str, t: float, kind: str, tid: int,
                attrs: Optional[dict] = None) -> None:
        """Zero-duration marker (rendered as an arrow tick in Perfetto)."""
        self.span(name, cat, t, t, kind, tid, attrs)

    def add_spans(self, name: str, cat: str, t_start, t_end,
                  kind: str, tids) -> None:
        """Bulk-append one span per element — the vectorized-kernel path.

        ``t_start``/``t_end``/``tids`` are equal-length sequences (NumPy
        arrays or lists); attrs are None for bulk spans.
        """
        t0 = np.asarray(t_start, dtype=np.float64)
        t1 = np.asarray(t_end, dtype=np.float64)
        ids = np.asarray(tids, dtype=np.int64)
        n = len(ids)
        self._name.extend([name] * n)
        self._cat.extend([cat] * n)
        self._t0.extend(t0.tolist())
        self._t1.extend(t1.tolist())
        self._tkind.extend([kind] * n)
        self._tid.extend(ids.tolist())
        self._attrs.extend([None] * n)
        if self.max_events is not None and len(self._name) > self.max_events:
            self._trim_spans(len(self._name) - self.max_events)

    def counter(self, name: str, t: float, value: float,
                kind: str, tid: int) -> None:
        """Sample a counter value at instant ``t`` on track ``(kind, tid)``."""
        self._cname.append(name)
        self._ct.append(float(t))
        self._cval.append(float(value))
        self._ckind.append(kind)
        self._cid.append(int(tid))
        if self.max_events is not None and len(self._cname) > self.max_events:
            k = len(self._cname) - self.max_events
            del self._cname[:k], self._ct[:k], self._cval[:k]
            del self._ckind[:k], self._cid[:k]
            self.dropped_counters += k

    def add_counters(self, name: str, ts, values, kind: str, tid: int) -> None:
        """Bulk counter samples on ONE track (vectorized-kernel path)."""
        t = np.asarray(ts, dtype=np.float64)
        v = np.asarray(values, dtype=np.float64)
        n = len(t)
        self._cname.extend([name] * n)
        self._ct.extend(t.tolist())
        self._cval.extend(v.tolist())
        self._ckind.extend([kind] * n)
        self._cid.extend([int(tid)] * n)
        if self.max_events is not None and len(self._cname) > self.max_events:
            k = len(self._cname) - self.max_events
            del self._cname[:k], self._ct[:k], self._cval[:k]
            del self._ckind[:k], self._cid[:k]
            self.dropped_counters += k

    def begin(self, key: str, t: float) -> None:
        """Open a cross-event span (finish instant not yet known)."""
        self._open[key] = float(t)

    def end(self, name: str, cat: str, key: str, t: float,
            kind: str, tid: int, attrs: Optional[dict] = None) -> None:
        """Close a cross-event span opened with :meth:`begin`.  Silently a
        no-op when ``key`` is not open (the dedicated-link paths emit their
        spans eagerly and never call ``begin``)."""
        t0 = self._open.pop(key, None)
        if t0 is not None:
            self.span(name, cat, t0, t, kind, tid, attrs)

    def _trim_spans(self, k: int) -> None:
        del self._name[:k], self._cat[:k], self._t0[:k], self._t1[:k]
        del self._tkind[:k], self._tid[:k], self._attrs[:k]
        self.dropped_spans += k

    # --------------------------------------------------------------- reading
    def __len__(self) -> int:
        return len(self._name)

    @property
    def n_counters(self) -> int:
        return len(self._cname)

    def spans(self) -> List[Span]:
        """Materialized span views (tests / summary tooling only)."""
        return [Span(n, c, a, b, (k, i), at) for n, c, a, b, k, i, at in
                zip(self._name, self._cat, self._t0, self._t1,
                    self._tkind, self._tid, self._attrs)]

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Compact columnar form: names/cats as arrays of str objects,
        times as float64, tids as int64 (the bench/test-side view)."""
        return {
            "name": np.array(self._name, dtype=object),
            "cat": np.array(self._cat, dtype=object),
            "t_start": np.array(self._t0, dtype=np.float64),
            "t_end": np.array(self._t1, dtype=np.float64),
            "kind": np.array(self._tkind, dtype=object),
            "tid": np.array(self._tid, dtype=np.int64),
        }

    # ---------------------------------------------------------------- export
    def to_chrome(self, other_data: Optional[dict] = None) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object.

        Layout: one process per track KIND (stable pids from
        ``TRACK_PIDS``), one thread per tid within it.  Spans become "X"
        complete events with ``ts``/``dur`` in microseconds of simulated
        time; counters become "C" events on their kind's process.
        Metadata events come first, sorted, so the export is
        byte-reproducible for the golden-trace test.
        """
        events: List[dict] = []
        kinds_seen = sorted({*self._tkind, *self._ckind})
        threads = sorted({(k, i) for k, i in zip(self._tkind, self._tid)})
        for k in kinds_seen:
            pid = TRACK_PIDS.get(k, 99)
            events.append({"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_name",
                           "args": {"name": k}})
        for k, i in threads:
            pid = TRACK_PIDS.get(k, 99)
            events.append({"ph": "M", "pid": pid, "tid": i,
                           "name": "thread_name",
                           "args": {"name": f"{k} {i}"}})
        for n, c, a, b, k, i, at in zip(self._name, self._cat, self._t0,
                                        self._t1, self._tkind, self._tid,
                                        self._attrs):
            ev = {"ph": "X", "name": n, "cat": c,
                  "pid": TRACK_PIDS.get(k, 99), "tid": i,
                  "ts": a * 1e6, "dur": (b - a) * 1e6}
            if at:
                ev["args"] = at
            events.append(ev)
        for n, t, v, k, i in zip(self._cname, self._ct, self._cval,
                                 self._ckind, self._cid):
            events.append({"ph": "C", "name": f"{n}:{k}:{i}",
                           "cat": "counter", "pid": TRACK_PIDS.get(k, 99),
                           "tid": i, "ts": t * 1e6, "args": {"value": v}})
        out = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": dict(other_data or {})}
        out["otherData"].setdefault("clock", "simulated-seconds")
        out["otherData"].setdefault("dropped_spans", self.dropped_spans)
        out["otherData"].setdefault("dropped_counters", self.dropped_counters)
        return out

    def write_chrome(self, path, other_data: Optional[dict] = None) -> None:
        """Write the Chrome-trace JSON (sorted keys — schema-stable)."""
        with open(path, "w") as fh:
            json.dump(self.to_chrome(other_data), fh, sort_keys=True)

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        """Full JSON-able tracer state (columns + open cross-event spans +
        drop counters) so kill/resume replays to an identical trace."""
        return {
            "max_events": self.max_events,
            "dropped": [self.dropped_spans, self.dropped_counters],
            "spans": [list(self._name), list(self._cat), list(self._t0),
                      list(self._t1), list(self._tkind), list(self._tid),
                      list(self._attrs)],
            "counters": [list(self._cname), list(self._ct), list(self._cval),
                         list(self._ckind), list(self._cid)],
            "open": dict(self._open),
        }

    def load_state_dict(self, st: dict) -> None:
        self.max_events = st["max_events"]
        self.dropped_spans, self.dropped_counters = (int(x)
                                                     for x in st["dropped"])
        name, cat, t0, t1, kind, tid, attrs = st["spans"]
        self._name = [str(x) for x in name]
        self._cat = [str(x) for x in cat]
        self._t0 = [float(x) for x in t0]
        self._t1 = [float(x) for x in t1]
        self._tkind = [str(x) for x in kind]
        self._tid = [int(x) for x in tid]
        self._attrs = [dict(a) if a else None for a in attrs]
        cname, ct, cval, ckind, cid = st["counters"]
        self._cname = [str(x) for x in cname]
        self._ct = [float(x) for x in ct]
        self._cval = [float(x) for x in cval]
        self._ckind = [str(x) for x in ckind]
        self._cid = [int(x) for x in cid]
        self._open = {str(k): float(v) for k, v in st["open"].items()}
