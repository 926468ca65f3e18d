"""FleetSpec: one seeded spec for devices + links + memory budgets.

The old API built a fleet from three independent pieces —
``make_fleet(n, seed)`` for devices, ``make_link_fleet(n, seed)`` for
links, ``Simulator(links=...)`` to marry them — which made it easy to
mis-pair seeds or sizes and impossible to describe a population-scale
fleet at all (10^5 ``DeviceProfile`` objects is exactly the per-object
cost the SoA path exists to avoid).

``FleetSpec`` replaces the trio: ONE frozen, seeded description that
yields every materialization on demand —

    spec = FleetSpec(n=64, seed=3, link_model="gilbert")
    spec.devices()          # per-object DeviceProfiles (small fleets)
    spec.links()            # per-object LinkModels
    spec.cuts()             # paper cut assignment, cycled
    spec.memory_budgets()   # per-client memory ceilings (GB)
    spec.population()       # struct-of-arrays PopulationFleet (large fleets)

``devices()``/``links()`` reproduce the legacy ``make_fleet`` /
``make_link_fleet`` streams EXACTLY (each draws from its own fresh
``default_rng(seed)``, as the two old functions did), so the deprecated
wrappers in ``fed.devices`` are pure delegations and every seeded
experiment in the repo keeps its numbers.

Copied from the JAX package's ``fed/fleet.py`` with its imports pointed into
the port; ``tests/test_torch_copies.py`` pins it bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from repro_torch.core.cost_model import DeviceProfile
from repro_torch.fed.devices import LINK, PAPER_CLIENTS, PAPER_CUTS
from repro_torch.net import ConstantLink, GilbertElliottLink, LinkModel, TraceLink

__all__ = ["FleetSpec"]


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Seeded description of an n-client heterogeneous fleet.

    Device side: cycle the paper's six §V profiles with a deterministic
    +/- ``jitter`` TFLOPS spread.  Link side: per-client wireless links in
    the chosen ``link_model`` with a +/- ``link_jitter`` rate spread (see
    the legacy ``make_link_fleet`` docstring for the trace/gilbert
    shapes — the knobs are identical).
    """
    n: int
    seed: int = 0
    jitter: float = 0.25
    link_model: str = "gilbert"         # constant | trace | gilbert
    base_mbps: float = LINK.rate_mbps
    link_jitter: float = 0.3
    dwell_s: float = 0.5
    horizon_s: float = 120.0
    bad_fraction: float = 0.1
    p_gb: float = 0.2
    p_bg: float = 0.4

    def __post_init__(self):
        if self.n < 1:
            raise ValueError("fleet size must be >= 1")
        if not 0.0 <= self.jitter < 1.0 or not 0.0 <= self.link_jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        if not 0.0 < self.bad_fraction <= 1.0:
            raise ValueError("bad_fraction must be in (0, 1]")
        if self.link_model not in ("constant", "trace", "gilbert"):
            raise KeyError(f"unknown link fleet model {self.link_model!r}")

    # -- per-object materializations (small fleets) --------------------------

    def devices(self) -> List[DeviceProfile]:
        """The legacy ``make_fleet(n, seed, jitter)`` fleet, stream-exact."""
        rng = np.random.default_rng(self.seed)
        fleet = []
        for i in range(self.n):
            base = PAPER_CLIENTS[i % len(PAPER_CLIENTS)]
            scale = 1.0 + self.jitter * float(rng.uniform(-1.0, 1.0))
            fleet.append(DeviceProfile(f"{base.name}#{i}",
                                       tflops=base.tflops * scale,
                                       mem_gb=base.mem_gb,
                                       utilization=base.utilization))
        return fleet

    def links(self) -> List[LinkModel]:
        """The legacy ``make_link_fleet`` links, stream-exact."""
        rng = np.random.default_rng(self.seed)
        links: List[LinkModel] = []
        for i in range(self.n):
            rate = self.base_mbps * (
                1.0 + self.link_jitter * float(rng.uniform(-1.0, 1.0)))
            if self.link_model == "constant":
                links.append(ConstantLink(rate))
            elif self.link_model == "trace":
                phase = float(rng.uniform(0.0, 2.0 * math.pi))
                period = float(rng.uniform(8.0, 20.0)) * self.dwell_s
                ts = np.arange(0.0, self.horizon_s, self.dwell_s)
                # deep fades: troughs reach ~1/8 of the client's peak rate
                fade = 0.125 + 0.875 * (0.5 + 0.5 * np.sin(
                    2.0 * math.pi * ts / period + phase))
                noise = 1.0 + 0.2 * rng.uniform(-1.0, 1.0, size=ts.size)
                rates = np.maximum(rate * fade * noise, self.base_mbps * 0.02)
                links.append(TraceLink(ts.tolist(), rates.tolist()))
            else:   # gilbert
                links.append(GilbertElliottLink(
                    rate, rate * self.bad_fraction, p_gb=self.p_gb,
                    p_bg=self.p_bg, dwell_s=self.dwell_s,
                    seed=int(rng.integers(0, 2 ** 31))))
        return links

    def cuts(self) -> List[int]:
        """Paper cut assignment, cycled with the device profiles."""
        return [PAPER_CUTS[i % len(PAPER_CUTS)] for i in range(self.n)]

    def memory_budgets(self) -> List[float]:
        """Per-client memory ceilings in GB (from the cycled profiles —
        budgets carry no jitter, matching ``devices()``)."""
        return [PAPER_CLIENTS[i % len(PAPER_CLIENTS)].mem_gb
                for i in range(self.n)]

    # -- struct-of-arrays materialization (population fleets) ----------------

    def population(self, rate_override_mbps: Optional[float] = None):
        """Struct-of-arrays ``PopulationFleet`` holding the SAME fleet as
        ``devices()``/``cuts()`` without constructing ``n`` objects.  Link
        rates are each client's NOMINAL rate (the jittered base) — the
        vectorized path models constant-rate links; time-varying links go
        through the per-object fallback."""
        from repro_torch.fed.population import PopulationFleet
        k = len(PAPER_CLIENTS)
        idx = np.arange(self.n) % k
        base_tflops = np.array([d.tflops for d in PAPER_CLIENTS])
        dev_rng = np.random.default_rng(self.seed)
        # one vectorized draw consumes the identical stream as the scalar
        # per-device draws in devices() (pinned by the parity tests)
        scale = 1.0 + self.jitter * dev_rng.uniform(-1.0, 1.0, size=self.n)
        if rate_override_mbps is not None:
            rates = np.full(self.n, float(rate_override_mbps))
        else:
            rates = self._nominal_rates()
        return PopulationFleet(
            tflops=base_tflops[idx] * scale,
            utilization=np.array([d.utilization
                                  for d in PAPER_CLIENTS])[idx],
            mem_gb=np.array([d.mem_gb for d in PAPER_CLIENTS])[idx],
            cuts=np.array(PAPER_CUTS)[idx],
            rate_mbps=rates,
            coords=self.coords(),
        )

    def coords(self) -> np.ndarray:
        """Per-client planar positions in the unit square (the k-means
        cell-assignment input).  Drawn from a seed-derived rng stream
        INDEPENDENT of the device/link draws, so adding location never
        perturbs the ``devices()``/``links()``/``population()`` streams
        (those are pinned draw-for-draw by the parity tests)."""
        rng = np.random.default_rng([self.seed, 0xC311])
        return rng.random((self.n, 2))

    def _nominal_rates(self) -> np.ndarray:
        """Each client's nominal (good-state / peak) link rate, consuming
        the link rng stream exactly as ``links()`` does so the SoA rates
        equal the per-object links' nominal rates for every model."""
        rng = np.random.default_rng(self.seed)
        if self.link_model == "constant":
            return self.base_mbps * (
                1.0 + self.link_jitter * rng.uniform(-1.0, 1.0, size=self.n))
        trace_len = np.arange(0.0, self.horizon_s, self.dwell_s).size
        rates = np.empty(self.n)
        for i in range(self.n):
            rates[i] = self.base_mbps * (
                1.0 + self.link_jitter * float(rng.uniform(-1.0, 1.0)))
            # burn the per-link shape draws links() would consume next
            if self.link_model == "trace":
                rng.uniform(0.0, 2.0 * math.pi)
                rng.uniform(8.0, 20.0)
                rng.uniform(-1.0, 1.0, size=trace_len)
            else:   # gilbert
                rng.integers(0, 2 ** 31)
        return rates
