"""End-to-end federated simulation of the paper's schemes (§V), on PyTorch.
Port of ``src/repro/fed/simulator.py`` for the paper's own experiment:

  ours : memory-efficient SFL — parallel clients, ONE full server model,
         sequential per-client server LoRA updates, Alg. 2 scheduling,
         Eq. 5-9 aggregation every I rounds.
  sfl  : FedBERT-style SFL — the same updates; only the round time differs.
  sl   : split learning — one traveling adapter set, strictly sequential
         clients, model handoff between them; no aggregation.

Model math runs for real (client forward, server resume-at-cut,
activation-gradient backprop, LoRA/AdamW updates, FedAvg aggregation);
simulated wall-clock comes from the §IV analytical model (``mode="analytic"``)
or from the discrete-event ``FederationClock`` (``mode="event"``), exactly as
in the reference.  Under the event engine the clock owns time and calls back
into ``_serve_group`` at every server dispatch and into a commit handler at
every aggregation: sync barrier waves, or async ``buffered`` / ``staleness``
commits with in-flight rounds.  Transfers go through the network plane
(constant, trace, Gilbert-Elliott or caller-supplied links, optionally over a
shared cell); ``agg.transport="plane"`` routes the adapter syncs there too.
The server serves one client per dispatch, or cohort chunks of clients
in one dispatch: the masked-scan step over every layer with a cut per lane
(``cohort_impl="vmap"``, the default) or the cut-grouped ragged step
(``"ragged"``);
``NetConfig.quantize`` sends the activations (with error feedback) and the
gradients as int8; ``ObsConfig`` records spans, metrics and the memory
ledger without touching the timeline.  A ``FleetSpec`` (``fleet=``) builds
the devices, cuts and (under ``link_model="custom"``) links of a seeded
heterogeneous fleet; ``FleetConfig`` samples each round's cohort (uniform,
or Pareto-biased towards capable clients), slows straggling clients'
compute, and groups the clients into edge cells whose members aggregate
at their edge before the cloud merges the cell summaries.  Under the event engine a
``ControlConfig`` policy other than ``static`` attaches the control loop
(``repro_torch.control``), which may move clients' cuts at commit
boundaries: the commit re-slices the migrated clients' frozen prefixes and
redistributes the aggregate at the new cuts.  ``snapshot_every`` /
``snapshot_dir`` write mid-flight snapshots from the clock's tick callback
(``repro_torch.checkpointing``), ``preempt_at`` stops the clock at a
simulated instant, and ``resume_from`` (or ``resume``) continues a snapshot
in a fresh Simulator bit for bit.  ``run_federated_training`` routes a
fleet below ``fleet.population_threshold`` through the Simulator and one at
or above it through the cohort-resident ``PopulationTrainer``.

State updates are functional: every optimizer step and every aggregation
returns new tensors, so state the reference shares between clients (one
head for all after a commit, the frozen base weights inside each client's
truncated view) is never written through.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpointing import (PeriodicSnapshotter, load_snapshot, pack_json,
                                       unpack_json)
from repro_torch.comm import dequantize, quantize, quantize_with_feedback, transport_bytes
from repro_torch.configs.base import ModelConfig
from repro_torch.control import ControlLoop
from repro_torch.core import aggregation as agg_lib
from repro_torch.core import lora as lora_lib
from repro_torch.core import memory_model, splitfl
from repro_torch.core.cost_model import (DeviceProfile, LinkProfile, StepTimes,
                                         client_step_times, dtype_nbytes,
                                         lora_upload_bytes, makespan)
from repro_torch.core.scheduling import (ONLINE_DISCIPLINES, alg2_priorities,
                                         refresh_priorities, resolve_online,
                                         resolve_order)
from repro_torch.data import ClassificationLoader, EmotionDataset, dirichlet_partition
from repro_torch.device import resolve_device
from repro_torch.fed import metrics as M
from repro_torch.fed.config import FedRunConfig, validate_run_config
from repro_torch.fed.devices import LINK, SERVER
from repro_torch.fed.engine import ClockConfig, FederationClock, RoundPlan, jobs_from_times
from repro_torch.fed.fleet import FleetSpec
from repro_torch.fed.population import sample_cohort
from repro_torch.models import build_model
from repro_torch.net import (ConstantLink, GilbertElliottLink, LinkModel,
                             NetworkPlane, TraceLink)
from repro_torch.net.topology import EdgeTopology, edge_commit_legs
from repro_torch.obs import MemoryLedger, MetricsRegistry, Observability, Tracer
from repro_torch.optim import AdamW
from repro_torch.tree import tree_map

SFL_FRAGMENTATION = 1.04   # multi-model GPU contention overhead (paper §V-B)

# Gilbert-Elliott defaults for link_model="gilbert": the bad state drops to
# a tenth of the nominal rate; dwell/transition values give ~1/3 bad time
# at the 100 Mbps / ~0.5 s-transfer scale of the paper's setup
GE_BAD_FRACTION = 0.1
GE_P_GB, GE_P_BG, GE_DWELL_S = 0.2, 0.4, 0.5


@dataclasses.dataclass
class RoundRecord:
    round: int
    sim_time_s: float
    mean_loss: float
    accuracy: Optional[float] = None
    f1: Optional[float] = None


def fedavg_heads(heads, data_sizes):
    """Dataset-weighted FedAvg of the heads, summed from Python 0 in
    client order as the reference does."""
    w = np.array(data_sizes, np.float64)
    w /= w.sum()
    return sum(float(wi) * h for wi, h in zip(w, heads))


def _like(live, saved):
    """``saved`` (a loaded tree: dicts in sorted key order, named tuples as
    plain tuples) rebuilt in ``live``'s key order and container types."""
    return tree_map(lambda _live, leaf: leaf, live, saved)


class Simulator:
    def __init__(self, cfg: ModelConfig, devices: Optional[Sequence[DeviceProfile]] = None,
                 cuts: Optional[Sequence[int]] = None,
                 train: EmotionDataset = None,
                 test: EmotionDataset = None, run: FedRunConfig = None,
                 link: LinkProfile = LINK, server: DeviceProfile = SERVER,
                 links: Optional[Sequence[LinkModel]] = None,
                 fleet: Optional[FleetSpec] = None, *, device="cuda"):
        if fleet is not None:
            # one seeded spec yields devices, cuts and (under
            # link_model="custom") the per-client LinkModels
            if devices is not None or cuts is not None:
                raise ValueError("pass either fleet=FleetSpec(...) or "
                                 "explicit devices/cuts, not both")
            devices, cuts = fleet.devices(), fleet.cuts()
            if links is None and run is not None and run.net.link_model == "custom":
                links = fleet.links()
        if devices is None or cuts is None or run is None:
            raise TypeError("Simulator needs devices+cuts (or fleet=) and run=")
        if len(devices) != len(cuts):
            raise ValueError("one cut per device required")
        validate_run_config(run, len(devices))
        if run.fleet.size is not None and run.fleet.size != len(devices):
            raise ValueError(f"run.fleet.size={run.fleet.size} but "
                             f"{len(devices)} devices were materialized")
        self.device = resolve_device(device)
        if run.engine.fused_lora:
            # thread the kernel choice through config, as the reference does
            cfg = cfg.with_(lora=dataclasses.replace(cfg.lora, impl="fused"))
        self.cfg, self.run = cfg, run
        self.devices, self.cuts = list(devices), [int(c) for c in cuts]
        self._init_cuts = [int(c) for c in cuts]   # fingerprint anchor
        self.link, self.server_dev = link, server
        self.u = len(devices)
        # the network plane: per-client link models + optional shared medium
        # (link_model="constant" keeps the analytic numbers bit-identical)
        self.network = self._build_network(links)
        if run.engine.mode == "analytic" and not self.network.constant_rate:
            raise ValueError("the closed-form engine needs constant-rate "
                             "links (custom LinkModels must be ConstantLink);"
                             " set engine mode='event' for time-varying ones")
        # two-tier edge/cloud topology for hierarchical aggregation
        self._edges: Optional[EdgeTopology] = None
        if run.fleet.edge_cells > 1:
            if run.fleet.cell_assignment == "kmeans":
                if fleet is None:
                    raise ValueError(
                        "cell_assignment='kmeans' clusters per-client "
                        "coordinates, which only a FleetSpec carries — "
                        "pass fleet=FleetSpec(...) (or keep 'blocks')")
                self._edges = EdgeTopology.kmeans(
                    fleet.coords(), run.fleet.edge_cells, seed=run.seed,
                    backhaul_mbps=run.fleet.backhaul_mbps,
                    cell_capacity_mbps=run.fleet.edge_capacity_mbps)
            else:
                self._edges = EdgeTopology.grouped(
                    self.u, run.fleet.edge_cells,
                    backhaul_mbps=run.fleet.backhaul_mbps,
                    cell_capacity_mbps=run.fleet.edge_capacity_mbps)
        self._cap_ranks: Optional[np.ndarray] = None
        self.model = build_model(cfg, self.device)
        gen = torch.Generator(device=self.device)
        self.params = self.model.init_params(gen.manual_seed(run.seed))

        # non-IID data
        parts = dirichlet_partition(train.labels, self.u, run.alpha, run.seed)
        self.data_sizes = [len(p) for p in parts]
        self.loaders = [ClassificationLoader(train.subset(p), run.batch_size,
                                             seed=run.seed + i)
                        for i, p in enumerate(parts)]
        self.test = test

        # per-client state
        base_lora = self.model.init_lora(gen.manual_seed(run.seed + 1))
        self.lora_spec = tree_map(torch.zeros_like, base_lora)
        self.opt = AdamW(run.lr)
        self.client_params: List = []
        self.client_lora: List = []
        self.server_lora: List = []
        self.heads: List = []
        self.client_opt: List = []
        self.server_opt: List = []
        head0 = self.params.get("cls_head")
        for cut in self.cuts:
            pc = dict(self.params)
            pc["layers"] = lora_lib.slice_stack(self.params["layers"], 0, cut)
            self.client_params.append(pc)
            c, s = lora_lib.split_lora(base_lora, cut)
            full_shape = lora_lib.embed_in_full_shape(s, self.lora_spec, cut, "server")
            self.client_lora.append(c)
            self.server_lora.append(full_shape)
            self.heads.append(head0)
            self.client_opt.append(self.opt.init(c))
            self.server_opt.append(self.opt.init({"lora": full_shape, "head": head0}))

        # steps per distinct cut
        self._srv_steps = {}
        self._cli_steps = {}
        for cut in sorted(set(self.cuts)):
            self._srv_steps[cut] = splitfl.make_server_step_cls(
                self.model, self.opt, static_cut=cut)
            self._cli_steps[cut] = splitfl.make_client_step(self.model, self.opt, cut)
        # cohort chunks: one masked dispatch a chunk (vmap), or one
        # cut-grouped dispatch per cut of a chunk (ragged)
        self._srv_step_batched = None
        if run.engine.cohort_chunk > 1:
            self._srv_step_batched = splitfl.make_server_step_cls_batched(
                self.model, self.opt, impl=run.engine.cohort_impl)

        # analytic per-step Eq.10 terms (fixed per client); wireless terms
        # use each client's NOMINAL link rate — the event engine re-times
        # the transfers through the network plane from the payload bytes
        self.times: List[StepTimes] = [
            client_step_times(cfg, cut, dev, server,
                              LinkProfile(self.network.nominal_mbps(u)),
                              run.batch_size, run.seq_len)
            for u, (cut, dev) in enumerate(zip(self.cuts, self.devices))]
        # adaptive control plane: shares the LIVE self.cuts list (never
        # rebound), so an accepted re-assignment is immediately visible to
        # the wave planner, the per-round times and the aggregation byte
        # accounting.  The static controller attaches nothing at all.
        self._control: Optional[ControlLoop] = None
        if run.control.policy != "static":
            self._control = ControlLoop(
                cfg, self.devices, server, self.network, self.cuts,
                batch=run.batch_size, seq_len=run.seq_len,
                controller=run.control.policy, resolve_every=run.control.resolve_every,
                hysteresis=run.control.hysteresis, scheduler=run.engine.scheduler,
                max_cut=cfg.n_layers - 1)
        # observability plane: tracing, metrics and the memory ledger only
        # READ the clock's results, so a run with obs on follows the same
        # timeline as one with obs off
        self.obs: Optional[Observability] = None
        if run.obs.enabled:
            self.obs = Observability(
                tracer=(Tracer(max_events=run.obs.max_events)
                        if run.obs.trace else None),
                metrics=MetricsRegistry() if run.obs.metrics else None,
                ledger=(MemoryLedger.from_model(cfg, self.cuts,
                                                run.batch_size, run.seq_len)
                        if run.obs.memory_ledger else None))
            if self._control is not None:
                self._control.obs = self.obs    # reassign spans, accept/reject counters
        self.history: List[RoundRecord] = []
        self.sim_clock = 0.0
        # the reference's two streams: _round_rng draws each round's
        # stragglers over the whole fleet, then its cohort (the analytic
        # loop and the sync barrier waves alike); _async_rng re-rolls a
        # client's stragglers per local round under the async policies.
        # A snapshot carries both positions.
        self._round_rng = np.random.default_rng(run.seed + 7777)
        self._async_rng = np.random.default_rng(run.seed + 4242)
        self._active: List[int] = list(range(self.u))
        self._ef_residual: List[Optional[torch.Tensor]] = [None] * self.u  # uplink EF
        self._quant_ratio: Optional[float] = None
        self._times_this_round: List[StepTimes] = self.times
        # event-engine state: the standing global model (every commit
        # updates it; the async policies merge INTO it) and the per-serve
        # loss trace (t_server_done, uid, round, loss)
        self._global_full = base_lora
        self._global_head = head0
        self.loss_events: List[tuple] = []
        self._clock: Optional[FederationClock] = None
        self._wave_losses: List[float] = []
        self._on_round = None
        # causal consistency for in-flight async rounds: the client-side
        # state each (uid, round) pulled at round start, a per-client commit
        # counter, and the local updates discarded because a commit
        # refreshed the client while its round was still in flight
        self._round_pull: dict = {}
        self._client_version = [0] * self.u
        self.discarded_updates: List[tuple] = []   # (uid, round)
        # mid-flight checkpoint/resume: the periodic snapshotter rides the
        # clock's tick callback, a loaded clock snapshot waits here until
        # _run_event builds the clock, and clock_result records the last
        # run (preemption included)
        self._snapshotter: Optional[PeriodicSnapshotter] = None
        if run.snapshot_every is not None:
            self._snapshotter = PeriodicSnapshotter(run.snapshot_dir, run.snapshot_every)
        self._pending_clock_state: Optional[dict] = None
        self._resumed = False
        self.clock_result = None

    # --------------------------------------------------------------- network
    def _build_network(self, links: Optional[Sequence[LinkModel]]) -> NetworkPlane:
        """The run's network plane from the link knobs (or the caller's
        LinkModels under link_model='custom')."""
        run = self.run
        if run.net.link_model == "custom":
            if links is None:
                raise ValueError("link_model='custom' needs Simulator("
                                 "links=[LinkModel, ...])")
            if len(links) != self.u:
                raise ValueError("need one LinkModel per client")
            ups = list(links)
        elif links is not None:
            raise ValueError("explicit links= require link_model='custom'")
        elif run.net.link_model == "constant":
            ups = [ConstantLink(self.link.rate_mbps) for _ in range(self.u)]
        elif run.net.link_model == "trace":
            # entries are (breakpoints, rates) tuples or bandwidth-CSV paths
            ups = [TraceLink.from_csv(tr) if isinstance(tr, (str, Path))
                   else TraceLink(tr[0], tr[1]) for tr in run.net.traces]
        else:   # gilbert
            base = self.link.rate_mbps
            ups = [GilbertElliottLink(base, base * GE_BAD_FRACTION,
                                      p_gb=GE_P_GB, p_bg=GE_P_BG,
                                      dwell_s=GE_DWELL_S,
                                      seed=run.seed * 7919 + u)
                   for u in range(self.u)]
        return NetworkPlane(ups, shared=run.net.shared,
                            capacity_mbps=run.net.capacity_mbps)

    # ------------------------------------------------------------------ time
    def _transport_ratio(self) -> float:
        """int8+EF wireless shrink factor (cached; same every round)."""
        if self._quant_ratio is None:
            shape = (self.run.batch_size, self.run.seq_len, self.cfg.d_model)
            nb = dtype_nbytes(self.cfg.dtype)
            self._quant_ratio = (transport_bytes(shape, True, nb)
                                 / transport_bytes(shape, False, nb))
        return self._quant_ratio

    def _shrunk(self, st: StepTimes) -> StepTimes:
        """int8+EF transport shrinks both wireless transfers ~4x, and their
        payload bytes with them (the network plane integrates bytes)."""
        if not self.run.net.quantize:
            return st
        ratio = self._transport_ratio()
        return dataclasses.replace(st, t_fc=st.t_fc * ratio, t_bc=st.t_bc * ratio,
                                   fc_bytes=st.fc_bytes * ratio,
                                   bc_bytes=st.bc_bytes * ratio)

    def _straggled(self, st: StepTimes, rng: np.random.Generator) -> StepTimes:
        """A straggler (one draw from ``rng`` when ``straggler_prob`` > 0)
        runs its client compute ``straggler_slowdown`` times slower."""
        fleet = self.run.fleet
        if fleet.straggler_prob > 0 and rng.random() < fleet.straggler_prob:
            return dataclasses.replace(st, t_f=st.t_f * fleet.straggler_slowdown,
                                       t_b=st.t_b * fleet.straggler_slowdown)
        return st

    def _adjusted_times(self) -> List[StepTimes]:
        """Per-round Eq.10 terms: every client of the fleet rolls for a
        straggler on the round stream, then int8+EF shrinks the links."""
        return [self._shrunk(self._straggled(st, self._round_rng)) for st in self.times]

    def _async_times(self, u: int, rnd: int) -> StepTimes:
        """Eq.10 terms for ONE client's local round ``rnd`` — the async
        clock's per-(client, round) counterpart of ``_adjusted_times``
        (stragglers re-roll per local round on the async stream)."""
        return self._shrunk(self._straggled(self.times[u], self._async_rng))

    def _service_plan(self) -> List[List[int]]:
        """This round's server dispatch groups in order: chunks of
        ``cohort_chunk`` sampled clients of the scheduled order."""
        tfl = [d.tflops for d in self.devices]
        chunk = max(1, int(self.run.engine.cohort_chunk))
        order = resolve_order(self.run.engine.scheduler, self._times_this_round,
                              self.cuts, tfl)
        order = [u for u in order if u in self._active]
        return [order[i:i + chunk] for i in range(0, len(order), chunk)]

    def _sample_cohort(self) -> None:
        """This round's cohort into ``self._active`` by the fleet sampling
        policy: one draw from the round stream per sampled round, after
        the round's straggler rolls.  ``uniform`` draws the legacy
        participation fraction; ``pareto`` draws the same size with
        rank-Pareto weights towards capable clients (Jung et al. 2024)."""
        run = self.run
        if run.fleet.sampling == "full" or run.scheme == "sl":
            self._active = list(range(self.u))
            return
        self._active = sample_cohort(
            self._round_rng, self.u, run.fleet.sampling, run.fleet.rate,
            ranks=self._capability_ranks(), pareto_alpha=run.fleet.pareto_alpha)

    def _capability_ranks(self) -> np.ndarray:
        """Dense capability ranks (0 = fastest client, ties by uid) for the
        Pareto sampler — cached; the fleet's TFLOPS never change."""
        if self._cap_ranks is None:
            tfl = np.array([d.tflops for d in self.devices])
            order = np.lexsort((np.arange(self.u), -tfl))
            ranks = np.empty(self.u, dtype=np.int64)
            ranks[order] = np.arange(self.u)
            self._cap_ranks = ranks
        return self._cap_ranks

    def _round_time(self, order: Sequence[int]) -> float:
        t = self._times_this_round
        if self.run.scheme == "ours":
            span, _, _ = makespan(t, order)
            return span
        if self.run.scheme == "sfl":
            # all participating server submodels train concurrently on one
            # GPU: fair-share finish at max(arrival) + contended total work
            active = [t[u] for u in self._active]
            start = max(st.ready for st in active)
            busy = sum(st.t_s for st in active) * SFL_FRAGMENTATION
            return start + busy + max(st.t_bc + st.t_b for st in active)
        if self.run.scheme == "sl":
            # strictly sequential + client-side model handoff between clients
            mb = memory_model.model_bytes(self.cfg)
            total = 0.0
            for u, st in enumerate(t):
                handoff = self.link.transfer_s(mb.embed + mb.layers(0, self.cuts[u]))
                total += st.ready + st.t_s + st.t_bc + st.t_b + handoff
            return total
        raise KeyError(self.run.scheme)

    # ------------------------------------------------------------------ round
    def run_round(self, rnd: int) -> RoundRecord:
        """One closed-form (analytic-engine) barrier round.  Event-engine
        rounds are driven by the FederationClock inside ``run_training``."""
        if self.run.engine.mode == "event":
            raise RuntimeError("engine='event' rounds are owned by the "
                               "FederationClock; call run_training()")
        self._times_this_round = self._adjusted_times()
        self._sample_cohort()
        if self.run.scheme == "sl":
            losses, order = self._round_sl()
        else:
            losses, order = self._round_parallel()
        self.sim_clock += self._round_time(order)
        # aggregation phase (not for SL)
        if self.run.scheme != "sl" and (rnd + 1) % self.run.agg.interval == 0:
            self.sim_clock += self._commit_sync(None)
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        rec = RoundRecord(rnd, self.sim_clock, mean_loss)
        self.history.append(rec)
        return rec

    def _round_parallel(self):
        """Parallel client forwards, then scheduled server updates on the
        single full model — sequential per-client dispatches or
        cohort-chunked batched dispatches, per the service plan."""
        losses, order = [], []
        for grp in self._service_plan():
            if not grp:
                continue
            order.extend(grp)
            losses.extend(self._serve_group(grp))
        return losses, order

    def _batch(self, u: int) -> dict:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in self.loaders[u].next_batch().items()}

    def _serve_group(self, grp: List[int]) -> List[float]:
        """The real math of one server dispatch: each client's batch draw
        and forward (with the int8+EF uplink under ``net.quantize``), then
        the server step at its cut (one client) or the batched step of
        ``engine.cohort_impl`` over a cohort chunk (vmap: one masked
        dispatch; ragged: one per cut), then each client's backward.  Every
        client keeps its forward's autograd tape until its backward, so a
        chunk's tapes are all alive at once."""
        batches, acts, tapes = {}, {}, {}
        for u in grp:
            batch = self._batch(u)
            fwd, _ = self._cli_steps[self.cuts[u]]
            v, tapes[u] = fwd(self.client_params[u], self.client_lora[u], batch)
            if self.run.net.quantize:
                qx, self._ef_residual[u] = quantize_with_feedback(
                    v, self._ef_residual[u])
                v = dequantize(qx, v.dtype)
            batches[u], acts[u] = batch, v

        if len(grp) == 1:
            u = grp[0]
            loss, new_lora, new_head, new_opt, dv = self._srv_steps[self.cuts[u]](
                self.params, self.server_lora[u], self.heads[u],
                self.server_opt[u], acts[u], batches[u])
            self._apply_server_update(u, new_lora, new_head, new_opt)
            self._client_backward(u, tapes.pop(u), dv)
            return [float(loss)]
        loss_g, nl, nh, no, dv_g = self._srv_step_batched(
            self.params,
            lora_lib.stack_trees([self.server_lora[u] for u in grp]),
            torch.stack([self.heads[u] for u in grp]),
            lora_lib.stack_trees([self.server_opt[u] for u in grp]),
            torch.stack([acts[u] for u in grp]),
            lora_lib.stack_trees([batches[u] for u in grp]),
            [self.cuts[u] for u in grp])
        nls, nos = lora_lib.unstack_tree(nl), lora_lib.unstack_tree(no)
        losses = []
        for i, u in enumerate(grp):
            losses.append(float(loss_g[i]))
            self._apply_server_update(u, nls[i], nh[i], nos[i])
            self._client_backward(u, tapes.pop(u), dv_g[i])
        return losses

    def _round_sl(self):
        """SL baseline: ONE traveling full adapter set (kept in slot 0 as a
        full-shape tree); clients run strictly sequentially, each re-splits
        the traveling adapters at its own cut, trains, and folds back."""
        order = list(range(self.u))
        losses = []
        for u in order:
            cut = self.cuts[u]
            batch = self._batch(u)
            # hand-off: the client receives the traveling client-side adapters
            cli_lo, _ = lora_lib.split_lora(self.server_lora[0], cut)
            fwd, bwd = self._cli_steps[cut]
            v, tape = fwd(self.client_params[u], cli_lo, batch)
            loss, new_lora, new_head, new_opt, dv = self._srv_steps[cut](
                self.params, self.server_lora[0], self.heads[0],
                self.server_opt[0], v, batch)
            self._apply_server_update(0, new_lora, new_head, new_opt)
            losses.append(float(loss))
            new_cli, _ = bwd(tape, self.opt.init(cli_lo), dv)
            self._sl_fold_back(new_cli, cut)
        return losses, order

    def _sl_fold_back(self, client_part, cut: int) -> None:
        """Write the client's updated prefix back into the traveling set."""
        full = self.server_lora[0]
        merged = {}
        for key, sub in full.items():
            if key in lora_lib.STACKED_KEYS and key in client_part:
                merged[key] = tree_map(
                    lambda f, c: torch.cat([c.to(f.dtype), f[cut:]], dim=0),
                    sub, client_part[key])
            else:
                merged[key] = sub
        self.server_lora[0] = merged

    def _apply_server_update(self, u: int, new_lora, new_head, new_opt) -> None:
        self.server_lora[u] = new_lora
        self.heads[u] = new_head
        self.server_opt[u] = new_opt

    def _client_backward(self, u: int, tape, dv) -> None:
        if self.run.net.quantize:
            dv = dequantize(quantize(dv), dv.dtype)     # downlink int8
        _, bwd = self._cli_steps[self.cuts[u]]
        self.client_lora[u], self.client_opt[u] = bwd(tape, self.client_opt[u], dv)

    def _fedavg_head(self):
        return fedavg_heads(self.heads, self.data_sizes)

    def _commit_sync(self, ev) -> Union[float, Dict[int, float]]:
        """Barrier aggregation (Alg. 1 l.17-30, Eqs. 5-9) over the whole
        fleet.  Shared by the analytic round loop (``ev`` None) and the sync
        clock.  Returns the adapter upload + download time at the nominal
        link (a per-client mapping once migrations apply); under
        ``agg.transport='plane'`` the clock routes the transfers itself and
        only the migration charges are returned, and the analytic engine
        prices both legs in closed form over the plane's constant-rate links.

        A control-plane decision lands here, at the barrier commit: the
        aggregate is computed under the OLD cuts (what the clients trained),
        then cuts may move, then the aggregate is redistributed re-split at
        the NEW cuts."""
        servers_split = [lora_lib.split_lora(self.server_lora[u], self.cuts[u])[1]
                         for u in range(self.u)]
        if self._edges is not None:
            # two-tier Eq. 6-8: edge cells partially merge their members,
            # the cloud merges the edge summaries (telescopes to the flat
            # weighted mean; the edge partials are kept for inspection)
            fulls = [lora_lib.assemble_full(self.client_lora[u], servers_split[u],
                                            self.cuts[u])
                     for u in range(self.u)]
            agg_full, self.edge_summaries, self.edge_masses = \
                agg_lib.hierarchical_aggregate(
                    fulls, [float(s) for s in self.data_sizes],
                    [list(cell) for cell in self._edges.cells])
            new_c, new_s = [], []
            for cut in self.cuts:
                c, s = lora_lib.split_lora(agg_full, cut)
                new_c.append(c)
                new_s.append(s)
        else:
            new_c, new_s, agg_full = agg_lib.aggregation_round(
                self.client_lora, servers_split, self.cuts, self.data_sizes)
        # the upload leg shipped the adapters the clients trained: price it
        # at the pre-migration cuts, before any decision applies
        up_old = max(self.link.transfer_s(lora_upload_bytes(self.cfg, cut))
                     for cut in self.cuts)
        mig: Dict[int, float] = {}
        changes: Dict[int, Tuple[int, int]] = {}
        if self._control is not None and ev is not None:
            changes, mig = self._control.decide(ev.time, list(range(self.u)), ev.version)
            if changes:
                self._apply_cut_changes(changes)
                for u in changes:     # re-split the aggregate at the new cut
                    new_c[u], new_s[u] = lora_lib.split_lora(agg_full, self.cuts[u])
        self.client_lora = new_c
        self.server_lora = [
            lora_lib.embed_in_full_shape(s, self.lora_spec, cut, "server")
            for s, cut in zip(new_s, self.cuts)]
        head = self._fedavg_head()
        self.heads = [head] * self.u
        self._global_full, self._global_head = agg_full, head
        # optimizer states reset to match redistributed adapters
        self.client_opt = [self.opt.init(c) for c in self.client_lora]
        self.server_opt = [self.opt.init({"lora": s, "head": self.heads[u]})
                           for u, s in enumerate(self.server_lora)]
        if self.run.agg.transport == "plane":
            if ev is not None:
                # the clock ships the adapters through the plane; only the
                # migration charges are added, past each client's download
                return mig
            # the analytic engine runs the static controller: no cut moved;
            # with edge cells, the two-tier cell/backhaul legs
            bytes_of = lambda u: lora_upload_bytes(self.cfg, self.cuts[u])  # noqa: E731
            if self._edges is not None:
                _, up_bar = edge_commit_legs(
                    self._edges, self.network, range(self.u), 0.0,
                    bytes_of, self._summary_bytes(), "up")
                _, down_bar = edge_commit_legs(
                    self._edges, self.network, range(self.u), up_bar,
                    bytes_of, self._summary_bytes(), "down")
                return down_bar
            up = max(self.network.uplinks[u].finish_time(0.0, bytes_of(u))
                     for u in range(self.u))
            return max(self.network.downlinks[u].finish_time(up, bytes_of(u))
                       for u in range(self.u))
        # the nominal link: upload at the old cuts, download (the
        # redistribute) at the new ones; two-tier topologies add one
        # summary per direction over the backhaul
        hier = (2.0 * self._edges.backhaul_s(self._summary_bytes())
                if self._edges is not None else 0.0)
        if changes:
            # upload at the old cuts, download (the redistribute) at the new
            down_new = max(self.link.transfer_s(lora_upload_bytes(self.cfg, cut))
                           for cut in self.cuts)
            return {u: up_old + down_new + hier + mig.get(u, 0.0)
                    for u in range(self.u)}
        return 2 * up_old + hier

    # ------------------------------------------------------- event engine
    # Under engine="event" the FederationClock owns time and the simulator
    # supplies the math: the clock calls back into ``_serve_group`` at every
    # server dispatch and into a commit handler at every aggregation, and
    # the simulator folds the results into history/loss_events.

    def _summary_bytes(self) -> float:
        """One edge summary = the full-depth adapter set (every cell merges
        its members into one full LoRA tree before the backhaul hop)."""
        return lora_upload_bytes(self.cfg, self.cfg.n_layers)

    def _resolved_buffer_k(self) -> int:
        run = self.run
        if run.agg.buffer_k is not None:
            return run.agg.buffer_k
        # buffered: semi-sync half-cohort; staleness: fully async (every
        # upload commits, the discount keeps stale ones from dominating)
        return 1 if run.agg.policy == "staleness" else max(1, self.u // 2)

    def _run_event(self, verbose: bool = False):
        run = self.run
        if run.agg.policy == "sync":
            policy = "fifo"              # per-wave RoundPlan carries the real
            pri = None                   # discipline / fixed order
        else:
            policy, needs_pri = resolve_online(run.engine.scheduler)
            if not needs_pri:
                pri = None
            elif self._control is not None:
                # the control loop refreshes this list IN PLACE on every
                # accepted re-assignment, so the online priority discipline
                # orders by the live N_c/C ratios
                pri = self._control.pri
            else:
                pri = alg2_priorities(self.cuts, [d.tflops for d in self.devices])
        ccfg = ClockConfig(policy=policy, slots=run.engine.slots,
                           cohort_chunk=max(1, int(run.engine.cohort_chunk)),
                           chunk_efficiency=run.engine.chunk_efficiency,
                           deadline=run.engine.deadline,
                           agg_policy=run.agg.policy,
                           agg_interval=run.agg.interval,
                           buffer_k=self._resolved_buffer_k(),
                           max_inflight_rounds=run.agg.max_inflight)
        agg_bytes_fn = None
        if run.agg.transport == "plane":
            # live cuts: a migrated client ships its NEW adapter payload,
            # priced by the control loop's own accounting where one runs
            if self._control is not None:
                agg_bytes_fn = self._control.agg_bytes
            else:
                agg_bytes_fn = lambda u: lora_upload_bytes(self.cfg, self.cuts[u])  # noqa: E731
        clock = FederationClock(self.u, run.rounds, ccfg,
                                times_fn=self._async_times, priorities=pri,
                                network=self.network, agg_bytes_fn=agg_bytes_fn,
                                edges=(self._edges if agg_bytes_fn is not None
                                       else None),
                                summary_bytes=(self._summary_bytes()
                                               if self._edges is not None else 0.0),
                                obs=self.obs)
        self._clock = clock
        if self._pending_clock_state is not None:
            # resuming a mid-flight snapshot: the clock continues the
            # restored event loop instead of starting at t=0, and the
            # snapshot cadence continues past the resume point
            clock.load_state_dict(self._pending_clock_state)
            self._pending_clock_state = None
            if self._snapshotter is not None:
                self._snapshotter.fast_forward(clock.now)
        else:
            self._wave_losses = []
        tick = self._on_tick if (self._snapshotter is not None
                                 or run.preempt_at is not None) else None
        if run.agg.policy == "sync":
            res = clock.run(plan_fn=self._plan_wave, on_serve=self._on_serve,
                            on_commit=self._commit_sync,
                            on_round_end=lambda rnd, r:
                                self._on_round_end(rnd, r, verbose),
                            on_tick=tick)
        else:
            res = clock.run(on_serve=self._on_serve,
                            on_commit=lambda ev: self._commit_async(ev, verbose),
                            on_round_start=self._on_round_start, on_tick=tick)
            # final-state evaluation (the async analogue of the sync path's
            # last-round eval) — not for preempted runs, which are resumed
            # from the last snapshot rather than finished here
            if not res.preempted and self.history \
                    and self.history[-1].accuracy is None:
                rec = self.history[-1]
                rec.accuracy, rec.f1 = self.evaluate()
                if verbose:
                    print(f"[{run.scheme}/{run.engine.scheduler}/{run.agg.policy}] "
                          f"final t={rec.sim_time_s:9.1f}s "
                          f"acc={rec.accuracy:.4f} f1={rec.f1:.4f}")
        self.clock_result = res
        self.sim_clock = clock.now
        if run.obs.trace_dir is not None and self.obs is not None \
                and self.obs.tracer is not None:
            self.write_trace()
        return self.history

    def _on_tick(self, now: float) -> bool:
        """Clock tick callback (every event under async policies, every
        barrier under sync): write a due snapshot, then apply the
        fault-injection preemption knob.  Snapshots are pure reads — a run
        with snapshotting enabled follows the identical timeline."""
        if self._snapshotter is not None:
            self._snapshotter.maybe_save(now, self.state_dict)
        if self.run.preempt_at is not None and now >= self.run.preempt_at:
            return False
        return True

    def _on_round_start(self, u: int, rnd: int, t: float) -> None:
        """A client pulls its model copy when it ENTERS a local round; the
        lazily-executed math must use that copy, not whatever a later commit
        redistributed mid-flight."""
        self._round_pull[(u, rnd)] = (self.client_lora[u], self.client_opt[u],
                                      self._client_version[u])

    def _on_serve(self, ev) -> None:
        # run each client's round on the state it pulled at round start
        swapped = {}
        for u, r in zip(ev.uids, ev.rounds):
            pull = self._round_pull.pop((u, r), None)
            if pull is not None:
                swapped[u] = (r, pull[2], self.client_lora[u], self.client_opt[u])
                self.client_lora[u], self.client_opt[u] = pull[0], pull[1]
        losses = self._serve_group(list(ev.uids))
        for u, (r, pull_version, cur_lora, cur_opt) in swapped.items():
            if self._client_version[u] != pull_version:
                # a commit refreshed u while this round was in flight: the
                # stale local update loses the race — u continues from the
                # redistributed global (its server-side half already serves
                # from the post-commit state)
                self.client_lora[u], self.client_opt[u] = cur_lora, cur_opt
                self.discarded_updates.append((u, r))
                if self.obs is not None and self.obs.metrics is not None:
                    self.obs.metrics.inc("stale_discard")
        self._wave_losses.extend(losses)
        for u, r, ls in zip(ev.uids, ev.rounds, losses):
            self.loss_events.append((ev.end, u, r, ls))

    def _plan_wave(self, rnd: int) -> RoundPlan:
        """One sync barrier wave: re-roll stragglers, sample the cohort, and
        hand the clock this round's jobs and discipline (or fixed order) —
        the analytic round's plan."""
        run = self.run
        self._times_this_round = t = self._adjusted_times()
        self._sample_cohort()
        tfl = [d.tflops for d in self.devices]
        uids = sorted(self._active)
        if run.engine.scheduler in ONLINE_DISCIPLINES:
            policy, needs_pri = ONLINE_DISCIPLINES[run.engine.scheduler]
            pri = alg2_priorities(self.cuts, tfl) if needs_pri else None
            return RoundPlan(jobs=jobs_from_times(t, uids, priorities=pri),
                             policy=policy)
        # e.g. "optimal": no online form — replay its fixed order
        order = [u for u in resolve_order(run.engine.scheduler, t, self.cuts, tfl)
                 if u in self._active]
        return RoundPlan(jobs=jobs_from_times(t, uids), order=order)

    def _on_round_end(self, rnd: int, res, verbose: bool) -> bool:
        self.sim_clock = self._clock.now
        losses, self._wave_losses = self._wave_losses, []
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        rec = RoundRecord(rnd, self.sim_clock, mean_loss)
        self.history.append(rec)
        stop = self._maybe_eval(rnd, rec, verbose)
        if self._on_round is not None:
            self._on_round(rec)
        return not stop

    def _commit_async(self, ev, verbose: bool = False) -> Union[float, Dict[int, float]]:
        """Async commit: fold the buffered contributors into the standing
        global adapters with staleness-discounted Eq. 6-8 weights, anchor
        the absent data mass on the current global, and redistribute to the
        contributors only (they re-enter at the new version; the rest keep
        training until their own next commit)."""
        run = self.run
        contribs = list(ev.contributors)
        fulls = [lora_lib.assemble_full(
                     self.client_lora[u],
                     lora_lib.split_lora(self.server_lora[u], self.cuts[u])[1],
                     self.cuts[u])
                 for u in contribs]
        alpha = 0.0
        if run.agg.policy == "staleness":
            alpha = 0.5 if run.agg.staleness_alpha is None else run.agg.staleness_alpha
        w = [self.data_sizes[u] * agg_lib.staleness_discount(s, alpha)
             for u, s in zip(contribs, ev.staleness)]
        anchor = float(sum(self.data_sizes)
                       - sum(self.data_sizes[u] for u in contribs))
        self._global_full = agg_lib.merge_into_global(
            self._global_full, fulls, w, anchor)
        self._global_head = agg_lib.aggregate_full_weighted(
            [self._global_head] + [self.heads[u] for u in contribs],
            [anchor] + w)
        # control decision: contributors stand at this commit boundary, but
        # only those with NO in-flight local round may migrate (an in-flight
        # round pulled client state shaped by the old cut).  The upload leg
        # shipped OLD-cut adapters: price it before the decision applies.
        up_old = max(self.link.transfer_s(lora_upload_bytes(self.cfg, self.cuts[u]))
                     for u in contribs)
        mig: Dict[int, float] = {}
        changes: Dict[int, Tuple[int, int]] = {}
        if self._control is not None:
            inflight = {u for (u, _r) in self._round_pull}
            changes, mig = self._control.decide(
                ev.time, contribs, ev.version,
                eligible=[u for u in contribs if u not in inflight])
            if changes:
                self._apply_cut_changes(changes)
        for u in contribs:
            c, s = lora_lib.split_lora(self._global_full, self.cuts[u])
            self.client_lora[u] = c
            self.server_lora[u] = lora_lib.embed_in_full_shape(
                s, self.lora_spec, self.cuts[u], "server")
            self.heads[u] = self._global_head
            self.client_opt[u] = self.opt.init(c)
            self.server_opt[u] = self.opt.init(
                {"lora": self.server_lora[u], "head": self._global_head})
            self._client_version[u] += 1   # in-flight rounds of u now race
        if run.agg.transport == "plane":
            # the clock routes the adapter syncs; migrations ride as
            # per-client extras past each contributor's download
            ret: Union[float, Dict[int, float]] = mig
            effective = max(mig.values(), default=0.0)
        elif changes:
            # nominal charge: upload at the old cuts, redistribute at the new
            down_new = max(self.link.transfer_s(lora_upload_bytes(self.cfg, self.cuts[u]))
                           for u in contribs)
            ret = {u: up_old + down_new + mig.get(u, 0.0) for u in contribs}
            effective = max(ret.values())
        else:
            ret = effective = 2 * up_old
        # one history record per commit (wall-clock-indexed, NOT per round)
        losses, self._wave_losses = self._wave_losses, []
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        self.sim_clock = ev.time + effective
        rec = RoundRecord(len(self.history), self.sim_clock, mean_loss)
        self.history.append(rec)
        if len(self.history) % run.eval_every == 0:
            rec.accuracy, rec.f1 = self.evaluate()
            if verbose:
                print(f"[{run.scheme}/{run.engine.scheduler}/{run.agg.policy}] "
                      f"commit {ev.version:4d} t={rec.sim_time_s:9.1f}s "
                      f"loss={rec.mean_loss:.4f} acc={rec.accuracy:.4f} "
                      f"f1={rec.f1:.4f} "
                      f"stale={float(np.mean(ev.staleness)):.2f}")
        if self._on_round is not None:
            self._on_round(rec)
        return ret

    # ------------------------------------------------------- control plane
    @property
    def control_events(self):
        """ReassignEvents recorded by the control loop (empty when static)."""
        return [] if self._control is None else self._control.decisions

    def _apply_cut_changes(self, changes: Dict[int, Tuple[int, int]]) -> None:
        """The model side of a cut migration (commit boundaries only): the
        live ``self.cuts`` entries are already updated by the control loop;
        here the client's frozen prefix is re-sliced, the steps for the new
        cut are ensured, the Eq. 10 terms refreshed and the memory ledger
        told.  Adapters and optimizer states are NOT touched: the calling
        commit redistributes them from the aggregated global at the new cut.
        The cohort steps take any cut and need nothing."""
        run = self.run
        for u, (_old, new) in changes.items():
            pc = dict(self.params)
            pc["layers"] = lora_lib.slice_stack(self.params["layers"], 0, new)
            self.client_params[u] = pc
            if new not in self._srv_steps:
                self._srv_steps[new] = splitfl.make_server_step_cls(
                    self.model, self.opt, static_cut=new)
                self._cli_steps[new] = splitfl.make_client_step(self.model, self.opt, new)
            self.times[u] = client_step_times(
                self.cfg, new, self.devices[u], self.server_dev,
                LinkProfile(self.network.nominal_mbps(u)),
                run.batch_size, run.seq_len)
            if self.obs is not None and self.obs.ledger is not None:
                self.obs.ledger.set_cut(u, new)

    def _maybe_eval(self, rnd: int, rec: RoundRecord, verbose: bool) -> bool:
        """Per-round eval/early-stop; True means stop training."""
        run = self.run
        if (rnd + 1) % run.eval_every == 0 or rnd == run.rounds - 1:
            rec.accuracy, rec.f1 = self.evaluate()
            if verbose:
                print(f"[{run.scheme}/{run.engine.scheduler}] round {rnd+1:4d} "
                      f"t={rec.sim_time_s:9.1f}s loss={rec.mean_loss:.4f} "
                      f"acc={rec.accuracy:.4f} f1={rec.f1:.4f}")
            if (run.target_accuracy is not None
                    and rec.accuracy >= run.target_accuracy):
                return True
        return False

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def evaluate(self, max_batches: int = 32):
        """Global model = aggregate of the current full adapters (ours/sfl),
        the traveling set (sl), or the standing async global (buffered /
        staleness policies), evaluated centrally on the held-out set."""
        params = dict(self.params)
        if self.run.agg.policy != "sync":
            full = self._global_full
            params["cls_head"] = self._global_head
        elif self.run.scheme == "sl":
            full = self.server_lora[0]
            params["cls_head"] = self.heads[0]
        else:
            fulls = [lora_lib.assemble_full(
                         self.client_lora[u],
                         lora_lib.split_lora(self.server_lora[u], self.cuts[u])[1],
                         self.cuts[u])
                     for u in range(self.u)]
            full = agg_lib.aggregate_full(fulls, self.data_sizes)
            params["cls_head"] = self._fedavg_head()

        preds, golds = [], []
        loader = ClassificationLoader(self.test, self.run.batch_size, seed=0)
        for i, batch in enumerate(loader.all_batches()):
            if i >= max_batches:
                break
            bt = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
            logits = self.model.loss(params, full, bt)[1]
            preds.append(np.argmax(logits.cpu().numpy(), -1))
            golds.append(batch["label"])
        pred = np.concatenate(preds)
        gold = np.concatenate(golds)
        return M.accuracy(pred, gold), M.macro_f1(pred, gold)

    # ------------------------------------------------------------ training loop
    def run_training(self, verbose: bool = False, on_round=None):
        """Run the configured rounds; ``on_round(rec)`` is called after each
        record (a round, or an async commit) and its evaluation — a hook for
        per-round measurements."""
        self._on_round = on_round
        if self.run.resume_from is not None and not self._resumed:
            self.resume(self.run.resume_from)
        if self.run.engine.mode == "event":
            # time is owned by the FederationClock
            return self._run_event(verbose)
        for rnd in range(self.run.rounds):
            rec = self.run_round(rnd)
            stop = self._maybe_eval(rnd, rec, verbose)
            if on_round is not None:
                on_round(rec)
            if stop:
                break
        return self.history

    # ------------------------------------------------------------------ state
    def _fingerprint(self) -> str:
        """Identity hash of everything a snapshot is only valid against:
        model shape, initial assignment, fleet size, and every run knob
        except the snapshot/resume/preemption ones (the resuming config
        legitimately differs in exactly those).  For the same configuration
        it equals the reference's digest."""
        run = dataclasses.asdict(self.run)
        for k in ("snapshot_every", "snapshot_dir", "resume_from",
                  "preempt_at", "obs"):
            # obs is popped too: observability is pure reads, so a resuming
            # run may legitimately turn tracing on or off
            run.pop(k, None)
        doc = {"model": self.cfg.name, "n_layers": self.cfg.n_layers,
               "d_model": self.cfg.d_model, "cuts": self._init_cuts,
               "n_clients": self.u, "run": run}
        return hashlib.sha256(json.dumps(doc, sort_keys=True,
                                         default=str).encode()).hexdigest()

    def _des_state(self) -> dict:
        """JSON-able discrete-event-side state for a mid-flight snapshot:
        the clock (event heap, buffers, credits, cells), the network
        plane's rate processes, the control plane, both RNG streams, and
        the run log (history, pending wave losses, discard log)."""
        return {
            "clock": (self._clock.state_dict()
                      if self._clock is not None else None),
            "net": self.network.state_dict(),
            "control": (self._control.state_dict()
                        if self._control is not None else None),
            "round_rng": self._round_rng.bit_generator.state,
            "async_rng": self._async_rng.bit_generator.state,
            "history": [[r.round, r.sim_time_s, r.mean_loss, r.accuracy,
                         r.f1] for r in self.history],
            "wave_losses": list(self._wave_losses),
            "discarded": [list(d) for d in self.discarded_updates],
            "obs": (self.obs.state_dict() if self.obs is not None else None),
        }

    def state_dict(self) -> dict:
        """Whole-fleet training state for ``CheckpointManager.save`` /
        ``resume``, including the MID-FLIGHT state of an event-engine run:
        the clock's event loop, in-flight round pulls, RNG stream positions,
        link/cell processes and the control plane — the reference's keys.
        A pure read: live tensors go into the tree as they are (the writer
        copies them to the host), nothing draws from an RNG or advances
        the clock.  Loading it into an identically configured Simulator and
        calling ``run_training`` continues the run bit for bit.  The frozen
        base weights are not in it: a fresh Simulator rebuilds them from
        ``run.seed``."""
        return {
            "schema_version": np.int64(2),
            "fingerprint": pack_json(self._fingerprint()),
            "round": np.int64(len(self.history)),
            "sim_clock": np.float64(self.sim_clock),
            "cuts": np.asarray(self.cuts, np.int64),
            "client_lora": self.client_lora,
            "server_lora": self.server_lora,
            "heads": self.heads,
            "client_opt": [tuple(o) for o in self.client_opt],
            "server_opt": [tuple(o) for o in self.server_opt],
            "loader_state": np.asarray([ld.state() for ld in self.loaders],
                                       np.int64),
            "global_full": self._global_full,
            "global_head": self._global_head,
            "loss_events": (np.asarray(self.loss_events, np.float64)
                            if self.loss_events
                            else np.zeros((0, 4), np.float64)),
            "des": pack_json(self._des_state()),
            "client_version": np.asarray(self._client_version, np.int64),
            # in-flight round pulls: the client-side state each live
            # (uid, round) took at round start — trees, so they ride the
            # checkpoint next to the adapters (each leaf stored on its own,
            # also where it aliases a live adapter)
            "round_pull": {
                f"{u}:{r}": {"lora": lora, "opt": tuple(opt),
                             "ver": np.int64(ver)}
                for (u, r), (lora, opt, ver) in self._round_pull.items()},
            "ef_residual": {str(u): arr
                            for u, arr in enumerate(self._ef_residual)
                            if arr is not None},
        }

    def load_state_dict(self, st: dict) -> int:
        """Restore a :meth:`state_dict` (as ``checkpointing.load`` returns
        it, tensors on this Simulator's device); returns the number of
        history records restored.  Restored trees take the live trees' key
        order and container types."""
        self.sim_clock = float(st["sim_clock"])
        if "cuts" in st:    # a control plane may have migrated cuts mid-run
            saved = [int(c) for c in np.asarray(st["cuts"])]
            changes = {u: (self.cuts[u], c) for u, c in enumerate(saved)
                       if c != self.cuts[u]}
            if changes:
                for u, (_, c) in changes.items():
                    self.cuts[u] = c      # in place: shared with the loop
                self._apply_cut_changes(changes)
                if self._control is not None:
                    # the online priority discipline must order by the
                    # RESTORED cuts, not the setup-phase ratios
                    refresh_priorities(self._control.pri, self.cuts,
                                       [d.tflops for d in self.devices])
        lora_like, opt_like = self.client_lora[0], self.client_opt[0]
        self.client_lora = [_like(lora_like, t) for t in st["client_lora"]]
        self.server_lora = [_like(self.server_lora[0], t) for t in st["server_lora"]]
        self.heads = [_like(self.heads[0], t) for t in st["heads"]]
        self.client_opt = [_like(opt_like, o) for o in st["client_opt"]]
        self.server_opt = [_like(self.server_opt[0], o) for o in st["server_opt"]]
        if "loader_state" in st:
            for ld, s in zip(self.loaders, np.asarray(st["loader_state"])):
                ld.restore(s)
        if "global_full" in st:   # event-engine state
            self._global_full = _like(self._global_full, st["global_full"])
            self._global_head = _like(self._global_head, st["global_head"])
            self.loss_events = [(float(t), int(u), int(r), float(ls))
                                for t, u, r, ls in np.asarray(st["loss_events"])]
        # ---- mid-flight state (snapshot schema >= 2)
        if "des" in st:
            des = unpack_json(st["des"])
            self.network.load_state_dict(des["net"])
            if des["control"] is not None:
                if self._control is None:
                    raise ValueError("snapshot carries control-plane state "
                                     "but this run has controller='static'")
                self._control.load_state_dict(des["control"])
            self._round_rng.bit_generator.state = des["round_rng"]
            self._async_rng.bit_generator.state = des["async_rng"]
            self.history = [
                RoundRecord(int(r), float(t), float(l),
                            None if a is None else float(a),
                            None if f1 is None else float(f1))
                for r, t, l, a, f1 in des["history"]]
            self._wave_losses = [float(x) for x in des["wave_losses"]]
            self.discarded_updates = [tuple(d) for d in des["discarded"]]
            if des.get("obs") is not None and self.obs is not None:
                # snapshots written without obs (or loaded into a run that
                # turned it off) skip this: obs never gates a resume
                self.obs.load_state_dict(des["obs"])
            # the clock is rebuilt by _run_event; its restored event loop
            # waits here until then
            self._pending_clock_state = des["clock"]
        if "client_version" in st:
            self._client_version = [int(v)
                                    for v in np.asarray(st["client_version"])]
        self._round_pull = {}
        for key, rec in (st.get("round_pull") or {}).items():
            u, r = (int(x) for x in key.split(":"))
            self._round_pull[(u, r)] = (_like(lora_like, rec["lora"]),
                                        _like(opt_like, rec["opt"]),
                                        int(np.asarray(rec["ver"])))
        for u_str, arr in (st.get("ef_residual") or {}).items():
            self._ef_residual[int(u_str)] = arr
        return int(st["round"])

    def resume(self, path: str) -> int:
        """Load a snapshot (checkpoint file, or a rotated snapshot
        directory — resolves to the latest) written by an identically
        configured run, and position this simulator to continue it.  The
        snapshot's config fingerprint must match; the snapshot/resume/
        preemption knobs are allowed to differ.  Returns the number of
        history records restored."""
        st = load_snapshot(path, device=self.device)
        if "fingerprint" in st:
            want = unpack_json(st["fingerprint"])
            if want != self._fingerprint():
                raise ValueError(
                    "snapshot fingerprint mismatch: it was written by a "
                    "differently configured run (model/fleet/knobs); "
                    "rebuild the Simulator with the original configuration "
                    "to resume")
        rnd = self.load_state_dict(st)
        self._resumed = True
        return rnd

    def server_memory_report(self) -> memory_model.ServerMemoryReport:
        """The modelled server bytes of this run's scheme at its cuts
        (paper Table I)."""
        return memory_model.server_memory(
            self.cfg, self.run.scheme, self.cuts,
            self.run.batch_size, self.run.seq_len)

    # ------------------------------------------------------------------ obs
    def obs_other_data(self) -> dict:
        """Sidecar payload for the Chrome trace's ``otherData`` field:
        the metrics summary and the memory-ledger report (JSON-able)."""
        if self.obs is None:
            return {}
        out: dict = {}
        if self.obs.metrics is not None:
            out["metrics"] = self.obs.metrics.summary()
        if self.obs.ledger is not None:
            out["memory"] = self.obs.ledger.report()
        return out

    def write_trace(self, path: Optional[str] = None) -> str:
        """Write the Chrome/Perfetto trace JSON (plus the metrics/ledger
        sidecar under ``otherData``).  Default target is
        ``run.obs.trace_dir/trace.json``."""
        if self.obs is None or self.obs.tracer is None:
            raise ValueError("write_trace needs ObsConfig(trace=True)")
        if path is None:
            if self.run.obs.trace_dir is None:
                raise ValueError("pass path= or set ObsConfig(trace_dir=...)")
            d = Path(self.run.obs.trace_dir)
            d.mkdir(parents=True, exist_ok=True)
            path = str(d / "trace.json")
        else:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
        self.obs.tracer.write_chrome(path, other_data=self.obs_other_data())
        return path


def run_federated_training(cfg: ModelConfig, fleet_spec: FleetSpec, run: FedRunConfig,
                           train, test=None, *, verbose: bool = False, device="cuda"):
    """Fleet-size router for real-math federated training.

    Below ``run.fleet.population_threshold`` the per-object
    :class:`Simulator` runs (every engine feature, eager per-client
    state); at or above it the ``PopulationClock`` + ``PopulationTrainer``
    pair, which holds state for sampled clients only — same seeds, same
    sampling stream.  ``fleet_spec`` is a ``FleetSpec``; returns the
    object that trained (``Simulator`` or ``PopulationTrainer``, both
    carrying ``history``, ``loss_events`` and ``evaluate()``)."""
    if fleet_spec.n < run.fleet.population_threshold:
        sim = Simulator(cfg, fleet=fleet_spec, train=train, test=test, run=run,
                        device=device)
        sim.run_training(verbose=verbose)
        return sim
    from repro_torch.fed.population_training import train_population
    return train_population(cfg, fleet_spec.population(), run, train, test,
                            verbose=verbose, device=device)
