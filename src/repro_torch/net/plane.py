"""The network plane: per-client links + optional shared-medium contention.

``NetworkPlane`` is what the engines talk to.  Two modes:

  dedicated      every client owns its uplink/downlink ``LinkModel``;
                 transfers never interact, so ``uplink_finish`` /
                 ``downlink_finish`` are pure functions (exact even for
                 time-varying traces);
  shared medium  concurrent transfers in one direction split a cell
                 capacity C: each in-flight transfer progresses at
                 min(own_link_rate(t), C / n_active).  ``SharedCell`` is
                 the exact piecewise integrator for that process — rates
                 change only at link-trace breakpoints and at transfer
                 add/remove instants, so every segment is integrable in
                 closed form.  In-flight transfers are re-timed whenever
                 contention changes: the engines schedule the cell's
                 ``next_completion()`` as a version-stamped event and
                 discard stale predictions after each add/remove.

Capacity is conserved by construction (sum of shares <= C at every
instant; property-tested in tests/test_net.py).
"""
from __future__ import annotations

import math
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.net.links import ConstantLink, LinkModel

__all__ = ["NetworkPlane", "SharedCell", "shared_finish_times"]

# a transfer is complete when fewer bits than this remain (fp dust from
# piecewise integration); 1e-3 bit at any real rate is << 1 ns of airtime
_EPS_BITS = 1e-3


def encode_tuples(x):
    """Recursively encode (possibly nested) tuples of JSON scalars as
    lists — the JSON-snapshot form of cell transfer ids and engine event
    payloads.  Scalars pass through unchanged."""
    return [encode_tuples(v) for v in x] if isinstance(x, tuple) else x


def decode_tuples(x):
    """Inverse of :func:`encode_tuples` (lists back to tuples)."""
    return tuple(decode_tuples(v) for v in x) if isinstance(x, list) else x


class SharedCell:
    """Exact processor-sharing integrator for one direction of a cell.

    ``add`` admits a transfer at time t; ``next_completion`` predicts the
    first finish under the CURRENT contention (pure — simulates on a copy);
    ``advance`` integrates the real state forward and pops every transfer
    completing on the way.  ``version`` increments at every add/remove so
    engines can invalidate previously-scheduled completion events.
    """

    def __init__(self, capacity_mbps: float, links: Sequence[LinkModel]):
        if capacity_mbps <= 0:
            raise ValueError("capacity_mbps must be > 0")
        self.cap_bps = float(capacity_mbps) * 1e6
        self.links = list(links)
        self.now = 0.0
        self.version = 0
        # tid -> [uid, remaining_bits]; dict preserves admission order
        self.active: Dict[Hashable, List] = {}
        # optional (Observability, direction) pair attached by the engines;
        # pure emission after each state change, never read by the math
        self.obs = None

    # ------------------------------------------------------------------ state
    def _rates_and_horizon(self, t: float, active) -> Tuple[dict, float]:
        """Per-transfer instantaneous rate at ``t`` and the earliest future
        instant any participating link's own rate may change."""
        share = self.cap_bps / len(active)
        rates, horizon = {}, math.inf
        for tid, (uid, _bits) in active.items():
            link = self.links[uid]
            rates[tid] = min(link.rate_bps_at(t), share)
            horizon = min(horizon, link.next_change(t))
        return rates, horizon

    # ------------------------------------------------------------------- api
    def add(self, t: float, tid: Hashable, uid: int, nbytes: float) -> None:
        """Admit transfer ``tid`` for client ``uid`` at time ``t``.  Any
        completion due before ``t`` must have been drained first (the
        engines guarantee this by processing events in time order)."""
        if tid in self.active:
            raise KeyError(f"transfer {tid!r} already in flight")
        self._integrate_to(max(t, self.now))
        self.active[tid] = [uid, float(nbytes) * 8.0]
        self.version += 1
        if self.obs is not None:
            o, d = self.obs
            o.cell_note(self.now, len(self.active), d, "add")

    def next_completion(self) -> Optional[float]:
        """Predicted instant of the FIRST transfer completion under current
        contention; None when the cell is idle.  Pure (copies state)."""
        if not self.active:
            return None
        now = self.now
        active = {tid: [uid, bits] for tid, (uid, bits) in self.active.items()}
        while True:
            rates, horizon = self._rates_and_horizon(now, active)
            t_fin = math.inf
            for tid, (_uid, bits) in active.items():
                r = rates[tid]
                if bits <= _EPS_BITS:
                    return now
                if r > 0.0:
                    t_fin = min(t_fin, now + bits / r)
            if t_fin <= horizon:
                if not math.isfinite(t_fin):
                    raise ValueError("shared cell stalls forever "
                                     "(all rates 0 with no future change)")
                return t_fin
            for tid, rec in active.items():
                rec[1] -= rates[tid] * (horizon - now)
            now = horizon

    def advance(self, t: float) -> List[Tuple[float, Hashable, int]]:
        """Integrate the real state to ``t`` and pop every transfer that
        completes on the way (or exactly at ``t``).  Returns
        ``[(finish_time, tid, uid), ...]`` in completion order; shares are
        re-split at each pop, which is what re-times the survivors."""
        done: List[Tuple[float, Hashable, int]] = []
        while True:
            nc = self.next_completion()
            if nc is None or nc > t + 1e-15:
                break
            self._integrate_to(nc)
            for tid in [k for k, (_u, bits) in self.active.items()
                        if bits <= _EPS_BITS]:
                uid, _ = self.active.pop(tid)
                self.version += 1
                if self.obs is not None:
                    o, d = self.obs
                    o.cell_note(nc, len(self.active), d, "pop")
                done.append((nc, tid, uid))
        self._integrate_to(t)
        return done

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        """JSON-able integrator state: clock, version stamp, and each
        in-flight transfer's remaining bits in admission order.  Transfer
        ids are tuples in the engines; they are encoded as lists here and
        re-tupled on load."""
        return {"now": self.now, "version": self.version,
                "active": [[encode_tuples(tid), uid, bits]
                           for tid, (uid, bits) in self.active.items()]}

    def load_state_dict(self, st: dict) -> None:
        self.now = float(st["now"])
        self.version = int(st["version"])
        self.active = {decode_tuples(tid): [int(uid), float(bits)]
                       for tid, uid, bits in st["active"]}

    # ------------------------------------------------------------- integrator
    def _integrate_to(self, t: float) -> None:
        """Drain bits from ``self.now`` to ``t`` assuming NO completion in
        between (callers step completion-to-completion via ``advance``)."""
        if t <= self.now or not self.active:
            self.now = max(self.now, t)
            return
        now = self.now
        while now < t:
            rates, horizon = self._rates_and_horizon(now, self.active)
            step_end = min(t, horizon)
            dt = step_end - now
            for tid, rec in self.active.items():
                rec[1] = max(rec[1] - rates[tid] * dt, 0.0)
            now = step_end
        self.now = t


def shared_finish_times(capacity_mbps: float, links: Sequence[LinkModel],
                        requests: Sequence[Tuple[int, float, float]]
                        ) -> List[float]:
    """Batch helper: exact finish times for ``(uid, t_start, nbytes)``
    transfer requests through ONE shared cell.  Usable whenever every start
    time is known up front (the sync round's uplinks all start at
    ``arrival + T^f``; its downlinks all start at server-finish instants
    that never depend on downlink completions)."""
    finish = [math.nan] * len(requests)
    cell = SharedCell(capacity_mbps, links)
    order = sorted(range(len(requests)), key=lambda i: (requests[i][1], i))
    for i in order:
        uid, t0, nbytes = requests[i]
        nc = cell.next_completion()
        while nc is not None and nc <= t0:
            for t_fin, tid, _uid in cell.advance(nc):
                finish[tid] = t_fin
            nc = cell.next_completion()
        cell.add(t0, i, uid, nbytes)
    nc = cell.next_completion()
    while nc is not None:
        for t_fin, tid, _uid in cell.advance(nc):
            finish[tid] = t_fin
        nc = cell.next_completion()
    return finish


class NetworkPlane:
    """Per-client links + optional shared cells, as one engine-facing object.

    ``uplinks[u]`` / ``downlinks[u]`` are client u's link models (downlinks
    default to the uplink models — symmetric channels, the paper's
    assumption).  With ``shared=True`` the plane also carries a cell
    ``capacity_mbps`` per direction; engines obtain a fresh stateful
    ``SharedCell`` per simulation via ``make_cell``.
    """

    def __init__(self, uplinks: Sequence[LinkModel],
                 downlinks: Optional[Sequence[LinkModel]] = None, *,
                 shared: bool = False,
                 capacity_mbps: Optional[float] = None):
        self.uplinks = list(uplinks)
        self.downlinks = list(downlinks) if downlinks is not None \
            else self.uplinks
        if not self.uplinks or len(self.downlinks) != len(self.uplinks):
            raise ValueError("need one uplink and one downlink per client")
        self.shared = bool(shared)
        self.capacity_mbps = capacity_mbps
        self._const_bps: Dict[str, Optional[list]] = {}
        self._constant_rate: Optional[bool] = None
        if self.shared:
            if capacity_mbps is None or capacity_mbps <= 0:
                raise ValueError("shared medium needs capacity_mbps > 0")
        elif capacity_mbps is not None:
            raise ValueError("capacity_mbps is only meaningful with "
                             "shared=True")

    @property
    def n_clients(self) -> int:
        """Fleet size (one uplink/downlink pair per client)."""
        return len(self.uplinks)

    @property
    def constant_rate(self) -> bool:
        """True when every link is constant and nothing contends — the
        engines may then use round-relative arithmetic (bit-exact plane-less
        parity) instead of global-time conversions.  Computed once per
        plane (the link lists never change after construction): the
        engines consult this per transfer, and an O(n) scan per query is
        an O(n^2) tax on a 10^4-client fleet."""
        if self._constant_rate is None:
            self._constant_rate = (
                not self.shared
                and all(l.constant_rate for l in self.uplinks)
                and all(l.constant_rate for l in self.downlinks))
        return self._constant_rate

    def nominal_mbps(self, uid: int) -> float:
        """Scalar rate summary the analytic Eq. 10 model plans with."""
        return self.uplinks[uid].nominal_mbps

    # ------------------------------------------------------ dedicated finishes
    def uplink_finish(self, uid: int, t_start: float, nbytes: float) -> float:
        """Exact dedicated-uplink landing instant (LinkModel.finish_time)."""
        if self.shared:
            raise RuntimeError("shared-medium uplinks go through a SharedCell")
        return self.uplinks[uid].finish_time(t_start, nbytes)

    def downlink_finish(self, uid: int, t_start: float, nbytes: float) -> float:
        """Exact dedicated-downlink landing instant (LinkModel.finish_time)."""
        if self.shared:
            raise RuntimeError("shared-medium downlinks go through a SharedCell")
        return self.downlinks[uid].finish_time(t_start, nbytes)

    # ------------------------------------------------------- batch rate query
    def rates_bps_at(self, t: float, uids=None, direction: str = "down"):
        """Batch rate query for the vectorized population engines: the
        listed clients' OWN-link rates (bps) at global instant ``t`` as one
        float64 array (whole fleet when ``uids`` is None).  Values are
        elementwise-identical to per-link ``rate_bps_at`` calls; constant
        links resolve through a per-direction cache built once per plane.
        The shared-medium capacity share is NOT folded in — it depends on
        the concurrency the caller is pricing (``predict_downlink``'s
        ``concurrent`` argument), so callers apply it themselves."""
        links = {"up": self.uplinks, "down": self.downlinks}[direction]
        if direction not in self._const_bps:
            self._const_bps[direction] = (
                np.array([l.rate_bps_at(0.0) for l in links])
                if all(l.constant_rate for l in links) else None)
        cached = self._const_bps[direction]
        if cached is not None:
            if uids is None:
                return cached.copy()
            return cached[np.asarray(uids, dtype=np.int64)]
        if uids is None:
            uids = range(len(links))
        return np.array([links[int(u)].rate_bps_at(t) for u in uids])

    # ------------------------------------------------------------ shared cells
    def make_cell(self, direction: str) -> SharedCell:
        """Fresh stateful contention cell ("up" | "down") for one engine
        run; each simulation owns its own integrators."""
        if not self.shared:
            raise RuntimeError("make_cell is shared-medium only")
        links = {"up": self.uplinks, "down": self.downlinks}[direction]
        return SharedCell(self.capacity_mbps, links)

    # ------------------------------------------------------------- predictions
    def predict_downlink(self, uid: int, t: float, nbytes: float, *,
                         concurrent: int = 0) -> float:
        """ESTIMATED downlink finish for the bandwidth-aware discipline:
        freeze the link's current rate (and, under a shared medium, the
        fair share against ``concurrent`` other in-flight downlinks).  A
        scheduling heuristic, not the exact integral."""
        r = self.downlinks[uid].rate_bps_at(t)
        if self.shared:
            r = min(r, self.capacity_mbps * 1e6 / (concurrent + 1))
        if r <= 0.0:
            nxt = self.downlinks[uid].next_change(t)
            return self.predict_downlink(uid, nxt, nbytes,
                                         concurrent=concurrent) \
                if math.isfinite(nxt) else math.inf
        return t + float(nbytes) * 8.0 / r

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        """JSON-able state of every link rate process (the cells are owned
        by whichever engine made them via :meth:`make_cell` and snapshot
        with that engine's state, not here).  Symmetric planes (downlinks
        ARE the uplinks) serialize the shared list once."""
        st = {"uplinks": [l.state_dict() for l in self.uplinks]}
        if self.downlinks is not self.uplinks:
            st["downlinks"] = [l.state_dict() for l in self.downlinks]
        return st

    def load_state_dict(self, st: dict) -> None:
        if len(st["uplinks"]) != len(self.uplinks):
            raise ValueError(f"snapshot carries {len(st['uplinks'])} uplink "
                             f"states for a {len(self.uplinks)}-client plane")
        for link, s in zip(self.uplinks, st["uplinks"]):
            link.load_state_dict(s)
        if "downlinks" in st:
            if self.downlinks is self.uplinks:
                raise ValueError("snapshot carries asymmetric downlink state "
                                 "but this plane is symmetric")
            if len(st["downlinks"]) != len(self.downlinks):
                raise ValueError("snapshot downlink count does not match "
                                 "the plane")
            for link, s in zip(self.downlinks, st["downlinks"]):
                link.load_state_dict(s)

    @classmethod
    def constant(cls, rate_mbps: float, n_clients: int) -> "NetworkPlane":
        """The legacy global-constant network as a plane (parity mode)."""
        return cls([ConstantLink(rate_mbps) for _ in range(n_clients)])
