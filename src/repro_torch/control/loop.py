"""The control loop: telemetry -> controller -> solver -> migration charge.

``ControlLoop`` is what a federation loop attaches to its clock.  At every
aggregation commit boundary it

  1. samples the network plane into the telemetry EWMAs,
  2. asks the controller whether to re-solve (static / periodic / reactive),
  3. re-solves the (cut, rank, batch) assignment for the ELIGIBLE clients
     (clients standing at this commit boundary with no in-flight rounds —
     migrating a client mid-round would tear its pulled model state),
  4. prices the migration: moved cuts re-ship prefix weights + adapters
     through the network plane AT THE LIVE LINK STATE (migrating onto a
     faded link is expensive, and the charge says so), and
  5. accepts only when the predicted per-round gain over ``gain_horizon``
     future rounds beats the migration bill — except under memory pressure,
     which is a hard constraint and migrates regardless.

Accepted changes are applied IN PLACE to the live ``cuts`` list the caller
shares with the loop, and the Alg. 2 priorities are refreshed in place so
the clock's online ``priority`` discipline immediately orders by the new
N_c^u / C_u (see ``core.scheduling.refresh_priorities``).

Two callers use this:
  * the pure-DES benches hand ``times_fn`` / ``priorities`` / ``on_commit``
    straight to a ``FederationClock``;
  * the real-math ``fed.Simulator`` calls :meth:`decide` from its commit
    handlers and applies the returned cut changes to its client state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.control.controller import Controller, make_controller
from repro_torch.control.solver import Assignment, predicted_span, solve_assignment
from repro_torch.control.telemetry import TelemetryStore
from repro_torch.core.cost_model import (DeviceProfile, LinkProfile, StepTimes,
                                         client_step_times, lora_upload_bytes,
                                         migration_bytes)
from repro_torch.core.memory_model import model_bytes
from repro_torch.core.scheduling import alg2_priorities, refresh_priorities
from repro_torch.net import NetworkPlane

__all__ = ["ControlLoop", "ReassignEvent"]


@dataclasses.dataclass(frozen=True)
class ReassignEvent:
    """One control decision (applied or rejected) for the run log."""
    time: float
    version: int                 # commit version the decision rode on
    trigger: str                 # periodic | fade | recovery | memory
    cut_changes: Dict[int, Tuple[int, int]]    # uid -> (old, new)
    rank_changes: Dict[int, Tuple[int, int]]
    batch_changes: Dict[int, Tuple[int, int]]
    predicted_gain_s: float      # per-round span gain at decision time
    migration_s: Dict[int, float]
    applied: bool

    @property
    def changed(self) -> bool:
        """True when the decision proposed at least one knob move."""
        return bool(self.cut_changes or self.rank_changes
                    or self.batch_changes)


class ControlLoop:
    """Commit-boundary control loop: telemetry → controller → solver →
    priced migration, applied in place to the live assignment.

    Accept/reject rule (:meth:`decide`): a proposed re-assignment is
    APPLIED iff the predicted per-round makespan gain times
    ``gain_horizon`` exceeds the worst per-client migration bill priced
    through the live links — except a ``memory`` trigger, which is a hard
    constraint and applies unconditionally.  Rejected proposals are still
    recorded in :attr:`decisions` (``applied=False``) for the run log.
    """

    def __init__(self, cfg: ModelConfig, devices: Sequence[DeviceProfile],
                 server: DeviceProfile, network: NetworkPlane,
                 cuts: List[int], *, batch: int, seq_len: int,
                 controller: "str | Controller" = "static",
                 resolve_every: int = 1, hysteresis: Optional[float] = None,
                 scheduler: str = "ours", mem_fraction: float = 0.5,
                 min_cut: int = 1, max_cut: Optional[int] = None,
                 gain_horizon: float = 10.0, dtype_bytes: int = 4,
                 ewma_alpha: float = 0.5,
                 rank_candidates: Optional[Sequence[int]] = None,
                 batch_candidates: Optional[Sequence[int]] = None):
        n = len(devices)
        if len(cuts) != n or network.n_clients != n:
            raise ValueError("devices, cuts and network plane must align")
        if gain_horizon <= 0:
            raise ValueError("gain_horizon must be > 0")
        self.cfg, self.devices, self.server = cfg, list(devices), server
        self.network = network
        self.cuts = cuts                        # LIVE, shared with the caller
        self.ranks = [cfg.lora.rank] * n        # live (DES-level knobs)
        self.batches = [int(batch)] * n
        self.seq_len = int(seq_len)
        self.min_cut = int(min_cut)
        self.max_cut = cfg.n_layers - 1 if max_cut is None else int(max_cut)
        self.gain_horizon = float(gain_horizon)
        self.dtype_bytes = int(dtype_bytes)
        # "optimal" has no cheap repeated-evaluation form; plan with Alg. 2
        self.scheduler = "ours" if scheduler == "optimal" else scheduler
        self.rank_candidates = tuple(rank_candidates) if rank_candidates else None
        self.batch_candidates = tuple(batch_candidates) if batch_candidates else None
        self._tfl = [d.tflops for d in self.devices]
        self._mb = model_bytes(cfg)
        self._nominal = [network.nominal_mbps(u) for u in range(n)]
        self._budgets = [d.mem_gb * (1024 ** 3) * mem_fraction
                         for d in self.devices]
        self.telemetry = TelemetryStore(cfg, n, self._nominal, self._budgets,
                                        alpha=ewma_alpha,
                                        dtype_bytes=dtype_bytes, mb=self._mb)
        self.controller = controller if isinstance(controller, Controller) \
            else make_controller(controller, resolve_every=resolve_every,
                                 hysteresis=hysteresis)
        self.pri: List[float] = alg2_priorities(self.cuts, self._tfl)
        self.decisions: List[ReassignEvent] = []
        self._times_cache: Dict[Tuple[int, int, int, int], StepTimes] = {}
        # optional Observability bundle (repro_torch.obs) attached by the caller;
        # decide() emits a reassign span / accept-reject counters through it
        self.obs = None

    # --------------------------------------------------------- clock-side API
    def times_fn(self, u: int, rnd: int = 0) -> StepTimes:
        """Eq. 10 terms at the LIVE assignment and the client's nominal rate
        (the DES benches hand this straight to ``FederationClock``; transfer
        bytes are integrated by the attached network plane)."""
        key = (u, self.cuts[u], self.ranks[u], self.batches[u])
        st = self._times_cache.get(key)
        if st is None:
            st = client_step_times(self.cfg, self.cuts[u], self.devices[u],
                                   self.server, LinkProfile(self._nominal[u]),
                                   self.batches[u], self.seq_len,
                                   lora_rank=self.ranks[u])
            self._times_cache[key] = st
        return st

    def agg_bytes(self, u: int) -> float:
        """Adapter sync payload at the client's LIVE cut/rank — hand this to
        ``FederationClock(agg_bytes_fn=...)`` for plane-routed aggregation."""
        return lora_upload_bytes(self.cfg, self.cuts[u], self.dtype_bytes,
                                 rank=self.ranks[u])

    def on_serve(self, ev) -> None:
        """Clock serve callback: fold realized dispatch spans into telemetry."""
        span = float(ev.end - ev.start)
        for u in ev.uids:
            self.telemetry.observe_step(u, span)

    def on_commit(self, ev) -> Dict[int, float]:
        """Clock commit callback for pure-DES runs: decide, return the
        per-client migration seconds as extra commit overhead."""
        _, mig = self.decide(ev.time, ev.contributors, ev.version)
        return mig

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        """JSON-able control-plane state for a mid-flight snapshot:
        telemetry EWMAs, controller trigger bookkeeping, the live
        rank/batch/priority lists, and the full decision log.  The live
        ``cuts`` list is owned (and serialized) by the caller."""
        return {
            "telemetry": self.telemetry.state_dict(),
            "controller": self.controller.state_dict(),
            "cuts": list(self.cuts),
            "ranks": list(self.ranks),
            "batches": list(self.batches),
            "pri": list(self.pri),
            "decisions": [self._enc_decision(d) for d in self.decisions],
        }

    def load_state_dict(self, st: dict) -> None:
        self.telemetry.load_state_dict(st["telemetry"])
        self.controller.load_state_dict(st["controller"])
        # cuts/pri restore IN PLACE: both lists are shared with the caller
        # (and, via times_fn/priorities, with a live FederationClock)
        self.cuts[:] = [int(c) for c in st["cuts"]]
        self.ranks = [int(r) for r in st["ranks"]]
        self.batches = [int(b) for b in st["batches"]]
        self.pri[:] = [float(p) for p in st["pri"]]
        self.decisions = [self._dec_decision(d) for d in st["decisions"]]

    @staticmethod
    def _enc_decision(d: ReassignEvent) -> dict:
        enc = lambda ch: [[u, a, b] for u, (a, b) in sorted(ch.items())]  # noqa: E731
        return {"time": d.time, "version": d.version, "trigger": d.trigger,
                "cut": enc(d.cut_changes), "rank": enc(d.rank_changes),
                "batch": enc(d.batch_changes), "gain": d.predicted_gain_s,
                "mig": [[u, s] for u, s in sorted(d.migration_s.items())],
                "applied": d.applied}

    @staticmethod
    def _dec_decision(st: dict) -> ReassignEvent:
        dec = lambda rows: {int(u): (int(a), int(b)) for u, a, b in rows}  # noqa: E731
        return ReassignEvent(
            time=float(st["time"]), version=int(st["version"]),
            trigger=st["trigger"], cut_changes=dec(st["cut"]),
            rank_changes=dec(st["rank"]), batch_changes=dec(st["batch"]),
            predicted_gain_s=float(st["gain"]),
            migration_s={int(u): float(s) for u, s in st["mig"]},
            applied=bool(st["applied"]))

    # ------------------------------------------------------------- decision
    def assignment(self) -> Assignment:
        """The LIVE (cut, rank, batch) assignment as an immutable value."""
        return Assignment(tuple(self.cuts), tuple(self.ranks),
                          tuple(self.batches))

    def _transfer_s(self, u: int, t: float, nbytes: float,
                    direction: str) -> float:
        """Migration shipping time through the plane at the live link state.
        Under a shared medium this uses the own-link/capacity estimate (the
        exact contended integral depends on transfers not yet scheduled)."""
        if nbytes <= 0:
            return 0.0
        links = self.network.downlinks if direction == "down" \
            else self.network.uplinks
        if self.network.shared:
            rate = min(links[u].rate_bps_at(t),
                       self.network.capacity_mbps * 1e6)
            if rate <= 0:
                rate = self._nominal[u] * 1e6
            return nbytes * 8.0 / rate
        return links[u].finish_time(t, nbytes) - t

    def decide(self, t: float, contributors: Sequence[int], version: int,
               eligible: Optional[Sequence[int]] = None
               ) -> Tuple[Dict[int, Tuple[int, int]], Dict[int, float]]:
        """Run the control loop at one commit boundary.

        ``contributors`` are the clients standing at this boundary;
        ``eligible`` (default: the contributors) further excludes clients
        the caller cannot migrate right now (in-flight rounds).  Returns
        ``(cut_changes, migration_seconds)`` — both empty when nothing
        happens.  Applied changes are already folded into the live
        ``cuts``/``ranks``/``batches``/``pri`` lists when this returns.
        """
        if self.controller.name == "static":
            return {}, {}
        self.telemetry.sample_plane(self.network, t)
        samples = [self.telemetry.snapshot(u, self.cuts[u], self.batches[u],
                                           self.seq_len, self._nominal[u])
                   for u in range(len(self.devices))]
        trigger = self.controller.should_resolve(t, version, samples)
        if trigger is None:
            return {}, {}
        adjustable = set(contributors if eligible is None else eligible)
        if trigger.uids is not None:
            # a targeted trigger re-plans only the deviating clients — and
            # only when they stand at THIS commit boundary (the others get
            # their turn at their own commits, where migration is safe)
            adjustable &= set(trigger.uids)
        adjustable = sorted(adjustable)
        if not adjustable:
            return {}, {}
        base = self.assignment()
        rates = list(self.telemetry.rate_mbps)
        base_span = predicted_span(self.cfg, self.devices, self.server, rates,
                                   base, self.seq_len,
                                   scheduler=self.scheduler)
        new_asg, new_span = solve_assignment(
            self.cfg, self.devices, self.server, rates, base, self.seq_len,
            adjustable=adjustable, min_cut=self.min_cut, max_cut=self.max_cut,
            mem_budget_bytes=self.telemetry.mem_budget, mb=self._mb,
            dtype_bytes=self.dtype_bytes, scheduler=self.scheduler,
            rank_candidates=self.rank_candidates,
            batch_candidates=self.batch_candidates)
        self.controller.on_resolved(t, samples, adjustable)

        cut_ch = {u: (base.cuts[u], new_asg.cuts[u])
                  for u in adjustable if new_asg.cuts[u] != base.cuts[u]}
        rank_ch = {u: (base.ranks[u], new_asg.ranks[u])
                   for u in adjustable if new_asg.ranks[u] != base.ranks[u]}
        batch_ch = {u: (base.batches[u], new_asg.batches[u])
                    for u in adjustable if new_asg.batches[u] != base.batches[u]}
        gain = base_span - new_span
        if not (cut_ch or rank_ch or batch_ch):
            return {}, {}

        # price the migration through the plane at the live link state
        mig: Dict[int, float] = {}
        for u, (old, new) in cut_ch.items():
            down_b, up_b = migration_bytes(self.cfg, old, new,
                                           self.dtype_bytes,
                                           rank=base.ranks[u])
            mig[u] = self._transfer_s(u, t, up_b, "up") \
                + self._transfer_s(u, t, down_b, "down")
        # accept when the horizon gain pays the worst migration bill;
        # memory pressure migrates unconditionally (hard constraint)
        bill = max(mig.values(), default=0.0)
        applied = trigger.reason == "memory" \
            or gain * self.gain_horizon > bill
        self.decisions.append(ReassignEvent(
            time=t, version=version, trigger=trigger.reason,
            cut_changes=cut_ch,
            rank_changes=rank_ch, batch_changes=batch_ch,
            predicted_gain_s=gain, migration_s=dict(mig), applied=applied))
        if self.obs is not None:
            if self.obs.tracer is not None:
                self.obs.tracer.span(
                    "reassign", "control", t, t + bill if applied else t,
                    "control", 0,
                    attrs={"trigger": trigger.reason, "applied": applied,
                           "gain_s": gain, "n_cut_changes": len(cut_ch)})
            if self.obs.metrics is not None:
                self.obs.metrics.inc("migration_accepted" if applied
                                     else "migration_rejected")
        if not applied:
            return {}, {}
        for u, (_, new) in cut_ch.items():
            self.cuts[u] = new
        for u, (_, new) in rank_ch.items():
            self.ranks[u] = new
        for u, (_, new) in batch_ch.items():
            self.batches[u] = new
        refresh_priorities(self.pri, self.cuts, self._tfl)
        return cut_ch, mig
