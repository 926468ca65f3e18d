"""Per-client runtime telemetry for the control plane.

The setup phase (§III) plans cuts from STATIC capability reports; the
control plane re-plans from what the run actually observes:

  link rate      sampled from the network plane's per-client rate processes
                 at commit instants, folded into an EWMA estimate (a single
                 instantaneous sample of a fading channel is noise; the
                 EWMA is what the hysteresis trigger compares against);
  step times     realized server-dispatch service spans and client round
                 completions reported by the FederationClock's serve
                 events (EWMA per client);
  memory         headroom = budget - analytic client footprint.  Budgets
                 are MUTABLE (``set_mem_budget``) so callers and tests can
                 inject memory-pressure events (another app claims RAM);
                 the reactive controller treats negative headroom as a
                 mandatory re-assignment trigger.

Everything here is plain bookkeeping — deterministic, no randomness, no
model math — so attaching telemetry to a run cannot perturb its timeline.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.memory_model import ModelBytes, client_memory, model_bytes
from repro_torch.net import NetworkPlane

__all__ = ["ClientSample", "TelemetryStore"]


@dataclasses.dataclass(frozen=True)
class ClientSample:
    """One client's telemetry snapshot at a decision instant."""
    uid: int
    rate_mbps: float            # EWMA link-rate estimate
    nominal_mbps: float         # the rate its assignment was planned for
    step_s: float               # EWMA realized serve span (nan = unobserved)
    mem_headroom_bytes: float   # budget - footprint at the CURRENT assignment


class TelemetryStore:
    """EWMA estimators + memory accounting for one fleet.

    ``alpha`` is the EWMA weight of the NEWEST sample; ``alpha=1`` trusts
    the instantaneous measurement (useful in tests), smaller values damp
    fading-channel noise.
    """

    def __init__(self, cfg: ModelConfig, n_clients: int,
                 nominal_mbps: Sequence[float],
                 mem_budget_bytes: Sequence[float], *,
                 alpha: float = 0.5, dtype_bytes: int = 4,
                 mb: Optional[ModelBytes] = None):
        if n_clients < 1:
            raise ValueError("need at least one client")
        if len(nominal_mbps) != n_clients or len(mem_budget_bytes) != n_clients:
            raise ValueError("need one nominal rate and one memory budget "
                             "per client")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.cfg = cfg
        self.n = n_clients
        self.alpha = float(alpha)
        self.dtype_bytes = int(dtype_bytes)
        self.mb = mb if mb is not None else model_bytes(cfg)
        self.rate_mbps: List[float] = [float(r) for r in nominal_mbps]
        self.mem_budget: List[float] = [float(b) for b in mem_budget_bytes]
        self.step_s: List[float] = [math.nan] * n_clients
        self.rate_samples = [0] * n_clients

    # ------------------------------------------------------------- observing
    def _ewma(self, old: float, new: float) -> float:
        if math.isnan(old):
            return new
        return (1.0 - self.alpha) * old + self.alpha * new

    def observe_rate(self, uid: int, mbps: float) -> None:
        """Fold one link-rate measurement (Mbps) into the EWMA estimate."""
        self.rate_mbps[uid] = self._ewma(self.rate_mbps[uid], float(mbps))
        self.rate_samples[uid] += 1

    def observe_transfer(self, uid: int, nbytes: float, seconds: float) -> None:
        """Realized-rate form: a transfer of ``nbytes`` took ``seconds``."""
        if seconds > 0.0 and nbytes > 0.0:
            self.observe_rate(uid, nbytes * 8.0 / (seconds * 1e6))

    def observe_step(self, uid: int, seconds: float) -> None:
        """Fold one realized serve/step span into the per-client EWMA."""
        self.step_s[uid] = self._ewma(self.step_s[uid], float(seconds))

    def sample_plane(self, network: NetworkPlane, t: float,
                     uids: Optional[Sequence[int]] = None) -> None:
        """Sample each client's instantaneous uplink rate at instant ``t``
        (the commit boundary) into the EWMA estimates."""
        for u in (range(self.n) if uids is None else uids):
            self.observe_rate(u, network.uplinks[u].rate_bps_at(t) / 1e6)

    # -------------------------------------------------------------- querying
    def set_mem_budget(self, uid: int, budget_bytes: float) -> None:
        """Inject a memory-pressure (or relief) event for one client."""
        self.mem_budget[uid] = float(budget_bytes)

    def mem_headroom(self, uid: int, cut: int, batch: int,
                     seq_len: int) -> float:
        """budget - analytic client footprint at (cut, batch, seq_len)."""
        need = client_memory(self.cfg, cut, batch, seq_len,
                             self.dtype_bytes, mb=self.mb)
        return self.mem_budget[uid] - need

    # ----------------------------------------------------------- persistence
    def state_dict(self) -> dict:
        """JSON-able estimator state (EWMAs, sample counts, live budgets) —
        restoring it resumes the control plane's view of the fleet exactly
        where a mid-flight snapshot froze it."""
        return {"rate_mbps": list(self.rate_mbps),
                "mem_budget": list(self.mem_budget),
                "step_s": list(self.step_s),
                "rate_samples": list(self.rate_samples)}

    def load_state_dict(self, st: dict) -> None:
        self.rate_mbps = [float(r) for r in st["rate_mbps"]]
        self.mem_budget = [float(b) for b in st["mem_budget"]]
        self.step_s = [float(s) for s in st["step_s"]]
        self.rate_samples = [int(c) for c in st["rate_samples"]]

    def snapshot(self, uid: int, cut: int, batch: int, seq_len: int,
                 nominal_mbps: float) -> ClientSample:
        """One client's telemetry view at a decision instant."""
        return ClientSample(uid=uid, rate_mbps=self.rate_mbps[uid],
                            nominal_mbps=float(nominal_mbps),
                            step_s=self.step_s[uid],
                            mem_headroom_bytes=self.mem_headroom(
                                uid, cut, batch, seq_len))
