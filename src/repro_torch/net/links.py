"""Per-client wireless link models (the network plane's rate processes).

The paper's §V setup fixes every client at 100 Mbps, which makes the
wireless terms T^fc/T^bc of Eq. 10 constants.  Real mobile links fade,
vary per client, and saturate — and split-LLM scheduling conclusions flip
under those dynamics (SplitLLM, arXiv:2501.13318; SFT-in-wireless,
arXiv:2501.09237).  A ``LinkModel`` answers one question exactly:

    finish_time(t_start, nbytes) -> wall-clock instant the last byte lands

by integrating the instantaneous rate over time.  Three processes:

  ConstantLink        fixed rate; byte-for-byte parity with the legacy
                      ``LinkProfile.transfer_s`` arithmetic (regression-
                      tested — the whole plane-less event timeline reproduces
                      bit-for-bit under it);
  TraceLink           piecewise-constant rate trace (driven by measured
                      bandwidth traces; the last segment's rate holds
                      forever);
  GilbertElliottLink  two-state good/bad Markov fading with fixed dwell
                      slots, deterministic under its seed.

Rates are megabits per second throughout (matching ``LinkProfile``); times
are seconds on the simulator's global clock.
"""
from __future__ import annotations

import bisect
import csv
import math
import os
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["BUNDLED_TRACES", "ConstantLink", "GilbertElliottLink",
           "LinkModel", "TraceLink", "bundled_trace", "bundled_trace_path"]

#: bandwidth CSVs shipped with the package (measured-style mobile traces)
_TRACES_DIR = os.path.join(os.path.dirname(__file__), "traces")
BUNDLED_TRACES = ("lte_4g5g",)


def bundled_trace_path(name: str = "lte_4g5g") -> str:
    """Filesystem path of a bundled bandwidth trace CSV."""
    if name not in BUNDLED_TRACES:
        raise KeyError(f"unknown bundled trace {name!r} "
                       f"(have {BUNDLED_TRACES})")
    return os.path.join(_TRACES_DIR, f"{name}.csv")


def bundled_trace(name: str = "lte_4g5g") -> Tuple[List[float], List[float]]:
    """Load a bundled trace as ``(breakpoints, rates_mbps)`` lists — the
    form ``FedRunConfig.link_traces`` accepts, convenient for deriving
    per-client variants (time-shifts, scaling) before building links."""
    link = TraceLink.from_csv(bundled_trace_path(name))
    return list(link.breakpoints), list(link.rates_mbps)


class LinkModel:
    """Time-varying point-to-point link: a piecewise-constant rate process.

    Subclasses implement ``rate_bps_at`` (instantaneous rate) and
    ``next_change`` (the next instant the rate may change); ``finish_time``
    integrates the shared way.  ``nominal_mbps`` is the scalar summary the
    analytic Eq. 10 model and the offline schedulers see.
    """

    #: True when the rate never varies — lets the engine keep its legacy
    #: round-relative arithmetic (exact plane-less parity) instead of converting
    #: through global time.
    constant_rate = False

    def rate_bps_at(self, t: float) -> float:
        """Instantaneous rate in bits/second at global instant ``t``."""
        raise NotImplementedError

    def next_change(self, t: float) -> float:
        """First instant strictly after ``t`` at which the rate may change
        (``math.inf`` for a constant link)."""
        raise NotImplementedError

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        """JSON-able mutable state (empty for stateless rate processes).

        Stateful processes (the seeded Gilbert–Elliott chain) override this
        so a mid-flight snapshot captures exactly the materialized slot
        sequence and RNG position — a resumed run observes the SAME fades
        at the same instants as the uninterrupted one."""
        return {}

    def load_state_dict(self, st: dict) -> None:
        """Restore :meth:`state_dict` output onto a freshly built link."""
        if st:
            raise ValueError(f"{type(self).__name__} carries no state, "
                             f"got {sorted(st)}")

    @property
    def nominal_mbps(self) -> float:
        raise NotImplementedError

    def finish_time(self, t_start: float, nbytes: float) -> float:
        """Instant the transfer of ``nbytes`` started at ``t_start`` lands,
        integrating rate over the piecewise-constant segments."""
        bits = float(nbytes) * 8.0
        if bits <= 0.0:
            return float(t_start)
        t = float(t_start)
        while True:
            r = self.rate_bps_at(t)
            nxt = self.next_change(t)
            if r > 0.0:
                t_done = t + bits / r
                if t_done <= nxt:
                    return t_done
            if not math.isfinite(nxt):
                raise ValueError(
                    f"{type(self).__name__}: transfer stalls forever "
                    f"(rate {r} bps with no future rate change)")
            bits -= r * (nxt - t)
            t = nxt

    def transfer_s(self, t_start: float, nbytes: float) -> float:
        """Duration form of :meth:`finish_time` (seconds of airtime)."""
        return self.finish_time(t_start, nbytes) - t_start


class ConstantLink(LinkModel):
    """Fixed-rate link — the legacy ``LinkProfile`` as a LinkModel.

    ``finish_time`` reproduces ``t_start + LinkProfile.transfer_s(nbytes)``
    with the SAME floating-point expression, so a constant-rate network
    plane is bit-for-bit identical to the pre-plane engine timelines.
    """

    constant_rate = True

    def __init__(self, rate_mbps: float):
        """
        >>> ConstantLink(100.0).finish_time(2.0, 12.5e6)  # 100 Mb / 100 Mbps
        3.0
        """
        if rate_mbps <= 0:
            raise ValueError("rate_mbps must be > 0")
        self.rate_mbps = float(rate_mbps)

    def rate_bps_at(self, t: float) -> float:
        return self.rate_mbps * 1e6

    def next_change(self, t: float) -> float:
        return math.inf

    @property
    def nominal_mbps(self) -> float:
        return self.rate_mbps

    def finish_time(self, t_start: float, nbytes: float) -> float:
        """Exactly ``LinkProfile.transfer_s``'s float expression, added to
        ``t_start`` — the bit-for-bit legacy-parity guarantee."""
        return t_start + nbytes * 8.0 / (self.rate_mbps * 1e6)

    def __repr__(self):
        return f"ConstantLink({self.rate_mbps} Mbps)"


class TraceLink(LinkModel):
    """Piecewise-constant rate from a bandwidth trace.

    ``breakpoints[i]`` is the instant segment i begins; the rate is
    ``rates_mbps[i]`` on ``[breakpoints[i], breakpoints[i+1])`` and the last
    rate holds forever after.  The first breakpoint must be 0.0 so every
    query instant is covered.  Mid-trace outages (rate 0) are allowed; the
    final rate must be positive so transfers always terminate.
    """

    def __init__(self, breakpoints: Sequence[float], rates_mbps: Sequence[float]):
        bp = [float(b) for b in breakpoints]
        rt = [float(r) for r in rates_mbps]
        if len(bp) != len(rt) or not bp:
            raise ValueError("need equal-length, non-empty breakpoints/rates")
        if bp[0] != 0.0:
            raise ValueError("trace must start at t=0")
        if any(b2 <= b1 for b1, b2 in zip(bp, bp[1:])):
            raise ValueError("breakpoints must be strictly increasing")
        if any(r < 0 for r in rt):
            raise ValueError("rates must be >= 0")
        if rt[-1] <= 0:
            raise ValueError("the final trace rate must be > 0 "
                             "(transfers must terminate)")
        self.breakpoints, self.rates_mbps = bp, rt

    @classmethod
    def from_csv(cls, path, *, time_col: int = 0, rate_col: int = 1,
                 rate_scale: float = 1.0,
                 delimiter: str = ",") -> "TraceLink":
        """Build a TraceLink from a measured bandwidth trace CSV.

        Rows are ``timestamp, rate`` (``time_col``/``rate_col`` pick the
        columns from wider files); a non-numeric header row is skipped.
        Timestamps are seconds, re-based so the trace starts at t=0 (most
        measured datasets start at an arbitrary epoch); rates are Mbps
        after multiplying by ``rate_scale`` (e.g. 8e-6 for bytes/s data).
        """
        times: List[float] = []
        rates: List[float] = []
        with open(os.fspath(path), newline="") as f:
            for row in csv.reader(f, delimiter=delimiter):
                if not row or not row[0].strip() or row[0].lstrip().startswith("#"):
                    continue
                try:
                    t = float(row[time_col])
                    r = float(row[rate_col])
                except (ValueError, IndexError):
                    if not times:   # header row
                        continue
                    raise ValueError(f"malformed trace row {row!r} in {path}")
                times.append(t)
                rates.append(r * rate_scale)
        if not times:
            raise ValueError(f"no trace rows in {path}")
        t0 = times[0]
        return cls([t - t0 for t in times], rates)

    def _segment(self, t: float) -> int:
        return max(bisect.bisect_right(self.breakpoints, t) - 1, 0)

    def rate_bps_at(self, t: float) -> float:
        return self.rates_mbps[self._segment(t)] * 1e6

    def next_change(self, t: float) -> float:
        i = bisect.bisect_right(self.breakpoints, t)
        return self.breakpoints[i] if i < len(self.breakpoints) else math.inf

    @property
    def nominal_mbps(self) -> float:
        """Duration-weighted mean rate over the traced horizon (the last
        segment counts with the mean segment length) — the scalar the
        analytic model and offline schedulers plan with."""
        bp, rt = self.breakpoints, self.rates_mbps
        if len(bp) == 1:
            return rt[0]
        durs = [b2 - b1 for b1, b2 in zip(bp, bp[1:])]
        durs.append(sum(durs) / len(durs))
        return sum(d * r for d, r in zip(durs, rt)) / sum(durs)

    def __repr__(self):
        return f"TraceLink({len(self.breakpoints)} segments)"


class GilbertElliottLink(LinkModel):
    """Two-state Markov fading channel (Gilbert–Elliott).

    Time is sliced into fixed ``dwell_s`` slots; the state chain starts
    good and flips good->bad with ``p_gb`` / bad->good with ``p_bg`` at
    each slot boundary.  The chain is materialized lazily from a private
    ``numpy`` Generator, so the slot sequence depends only on ``seed`` —
    never on query order (determinism is regression-tested).
    """

    def __init__(self, good_mbps: float, bad_mbps: float, *,
                 p_gb: float = 0.2, p_bg: float = 0.4, dwell_s: float = 0.5,
                 seed: int = 0):
        if good_mbps <= 0 or bad_mbps <= 0:
            raise ValueError("state rates must be > 0")
        if not (0.0 <= p_gb <= 1.0 and 0.0 <= p_bg <= 1.0):
            raise ValueError("transition probabilities must be in [0, 1]")
        if dwell_s <= 0:
            raise ValueError("dwell_s must be > 0")
        self.good_mbps, self.bad_mbps = float(good_mbps), float(bad_mbps)
        self.p_gb, self.p_bg, self.dwell_s = float(p_gb), float(p_bg), float(dwell_s)
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self._states: List[bool] = [True]     # slot 0 is good

    def _ensure(self, slot: int) -> None:
        while len(self._states) <= slot:
            good = self._states[-1]
            u = float(self._rng.random())
            self._states.append(u >= self.p_gb if good else u < self.p_bg)

    def state_at(self, t: float) -> bool:
        """True when the channel is in the good state at instant ``t``."""
        slot = max(int(t / self.dwell_s), 0)
        self._ensure(slot)
        return self._states[slot]

    def rate_bps_at(self, t: float) -> float:
        return (self.good_mbps if self.state_at(t) else self.bad_mbps) * 1e6

    def next_change(self, t: float) -> float:
        # strict progress: for non-dyadic dwell_s, float truncation can put
        # (slot+1)*dwell_s at or below t (e.g. t = 43*0.1) — returning t
        # would stall finish_time's segment walk and the SharedCell
        # integrator forever, so step one more slot in that case
        slot = max(int(t / self.dwell_s), 0)
        nxt = (slot + 1) * self.dwell_s
        return nxt if nxt > t else (slot + 2) * self.dwell_s

    @property
    def nominal_mbps(self) -> float:
        """Stationary mean rate pi_g * good + pi_b * bad."""
        denom = self.p_gb + self.p_bg
        pi_g = self.p_bg / denom if denom > 0 else 1.0
        return pi_g * self.good_mbps + (1.0 - pi_g) * self.bad_mbps

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        """Materialized slot chain + RNG position (JSON-able).  Restoring
        both makes the fading process continue bit-identically: slots
        already drawn replay verbatim, future slots draw from the exact
        generator position the snapshot froze."""
        return {"states": [int(s) for s in self._states],
                "rng": self._rng.bit_generator.state}

    def load_state_dict(self, st: dict) -> None:
        self._states = [bool(s) for s in st["states"]]
        self._rng.bit_generator.state = st["rng"]

    def __repr__(self):
        return (f"GilbertElliottLink(good={self.good_mbps}, "
                f"bad={self.bad_mbps}, seed={self.seed})")
