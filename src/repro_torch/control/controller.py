"""Controller policies: WHEN does the control plane re-solve?

Three policies (the ``controller=`` knob of ``FedRunConfig``):

  static    never — the setup-phase assignment is frozen, exactly the
            pre-control-plane behavior (bit-for-bit regression-tested);
  periodic  re-solve every ``resolve_every`` aggregation commits, link
            state notwithstanding (the classic fixed-cadence baseline);
  reactive  hysteresis-triggered: re-solve only when some decision-relevant
            signal LEAVES its planning band — a client's EWMA link-rate
            estimate drifts more than ``hysteresis`` (relative) away from
            the rate its current assignment was planned at (fade or
            recovery), or its memory headroom goes negative (pressure).
            The planning baselines advance every time a re-solve runs, so
            the controller does not flap inside the band.

A controller only picks the MOMENT; the solver picks the assignment and
the ControlLoop charges migration — see ``repro_torch.control.loop``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.control.telemetry import ClientSample

__all__ = ["CONTROLLERS", "Controller", "PeriodicController",
           "ReactiveController", "StaticController", "Trigger",
           "make_controller"]

CONTROLLERS = ("static", "periodic", "reactive")


@dataclasses.dataclass(frozen=True)
class Trigger:
    """A controller's decision to re-solve: why, and for WHOM.

    ``uids=None`` re-plans every eligible client (the periodic sweep);
    a tuple restricts the re-solve to exactly the clients whose signal
    left its band — one client's fade must not churn the whole fleet's
    assignment."""
    reason: str                 # periodic | fade | recovery | memory
    uids: Optional[Tuple[int, ...]] = None


class Controller:
    """Decision-moment policy.  ``should_resolve`` returns a
    :class:`Trigger` when the control plane should re-solve at this commit
    boundary, else None.  ``on_resolved`` is called after a solver run
    actually happened, with the uids that were re-planned, so the policy
    can advance its planning baselines for exactly those clients."""

    name = "?"

    def should_resolve(self, t: float, version: int,
                       samples: Sequence[ClientSample]) -> Optional[Trigger]:
        raise NotImplementedError

    def on_resolved(self, t: float, samples: Sequence[ClientSample],
                    uids: Sequence[int]) -> None:
        """Advance planning baselines after a solver run covered ``uids``."""
        pass

    # ----------------------------------------------------------- persistence
    def state_dict(self) -> dict:
        """JSON-able trigger bookkeeping (boundary counters, planning
        baselines).  Stateless policies return ``{}``."""
        return {}

    def load_state_dict(self, st: dict) -> None:
        if st:
            raise ValueError(f"{type(self).__name__} carries no state, "
                             f"got {sorted(st)}")


class StaticController(Controller):
    """Never re-solves — the frozen setup-phase assignment."""

    name = "static"

    def should_resolve(self, t, version, samples):
        return None


class PeriodicController(Controller):
    """Re-solve every ``resolve_every`` commit boundaries, fleet-wide."""

    name = "periodic"

    def __init__(self, resolve_every: int = 1):
        if resolve_every < 1:
            raise ValueError("resolve_every must be >= 1")
        self.resolve_every = int(resolve_every)
        self._boundaries = 0

    def should_resolve(self, t, version, samples):
        self._boundaries += 1
        if self._boundaries % self.resolve_every == 0:
            return Trigger("periodic")
        return None

    def state_dict(self) -> dict:
        return {"boundaries": self._boundaries}

    def load_state_dict(self, st: dict) -> None:
        self._boundaries = int(st["boundaries"])


class ReactiveController(Controller):
    """Hysteresis band on the per-client rate estimates + hard memory trigger.

    ``hysteresis`` is the relative half-width of the band: with 0.25, a
    client planned at 100 Mbps re-triggers below 75 (``fade``) or above
    125 (``recovery``) — and only THAT client is re-planned.  Memory
    headroom < 0 always triggers (``memory``) — shedding layers under
    pressure is a correctness matter, not a speed optimization, so it
    bypasses the band entirely and outranks rate triggers.
    """

    name = "reactive"

    def __init__(self, hysteresis: float = 0.25):
        if hysteresis <= 0.0:
            raise ValueError("hysteresis must be > 0")
        self.hysteresis = float(hysteresis)
        self.plan_rate: Dict[int, float] = {}   # uid -> planned-at rate

    def should_resolve(self, t, version, samples):
        pressure, faded, recovered = [], [], []
        for s in samples:
            if s.mem_headroom_bytes < 0.0:
                pressure.append(s.uid)
                continue
            base = self.plan_rate.get(s.uid, s.nominal_mbps)
            if s.rate_mbps < base * (1.0 - self.hysteresis):
                faded.append(s.uid)
            elif s.rate_mbps > base * (1.0 + self.hysteresis):
                recovered.append(s.uid)
        if pressure:
            return Trigger("memory", tuple(pressure))
        if faded:
            return Trigger("fade", tuple(faded + recovered))
        if recovered:
            return Trigger("recovery", tuple(recovered))
        return None

    def on_resolved(self, t, samples, uids):
        planned = set(uids)
        for s in samples:
            if s.uid in planned and math.isfinite(s.rate_mbps):
                self.plan_rate[s.uid] = s.rate_mbps

    def state_dict(self) -> dict:
        return {"plan_rate": {str(u): r for u, r in self.plan_rate.items()}}

    def load_state_dict(self, st: dict) -> None:
        self.plan_rate = {int(u): float(r)
                          for u, r in st["plan_rate"].items()}


def make_controller(name: str, *, resolve_every: int = 1,
                    hysteresis: Optional[float] = None) -> Controller:
    """Factory for the ``FedRunConfig.controller`` knob."""
    if name == "static":
        return StaticController()
    if name == "periodic":
        return PeriodicController(resolve_every=resolve_every)
    if name == "reactive":
        return ReactiveController(
            hysteresis=0.25 if hysteresis is None else hysteresis)
    raise KeyError(f"unknown controller {name!r} "
                   f"(choose from {CONTROLLERS})")
