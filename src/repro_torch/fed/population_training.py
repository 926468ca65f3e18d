"""Real-math training on sampled cohorts at population scale, on PyTorch.
Port of ``src/repro/fed/population_training.py``.

``PopulationClock`` (fed/population.py) schedules 10^4-client rounds as
pure timing; this module supplies the training math for exactly the
cohorts those kernels dispatch.  A :class:`PopulationTrainer` attaches to
the clock and mirrors the per-object ``Simulator`` expression for
expression — client forward at the cut (Eq. 3), the batched/ragged
server step (Eq. 4), client backward, and the Eq. 5-9 commits — but
holds per-client adapter/optimizer state ONLY for sampled clients, via
``core.splitfl.CohortAdapterStore``.

Two commit regimes, keyed on ``run.fleet.population_threshold``:

  * ``exact``    (fleet below the threshold): commits fold FULL-LENGTH
    uid-ordered adapter lists where every untouched client is a cached
    slice view of the standing global.  ``split_lora`` /
    ``embed_in_full_shape`` / ``assemble_full`` only slice, copy and
    concatenate, and ``opt.init`` is deterministic, so the result is
    bit-identical to the eager per-object ``Simulator`` under matching
    seeds: loss events, history, adapter trees and the timeline.
  * ``anchored`` (at/above the threshold): commits anchor the absent
    data mass on the standing global (``merge_into_global`` /
    ``anchored_hierarchical_aggregate``) — O(cohort) tree ops instead of
    O(fleet), equal to the exact fold up to float rounding.

The streams are the Simulator's: model params from a generator seeded
with ``run.seed``, base adapters from ``run.seed + 1`` (the reference's
``PRNGKey(seed)`` and ``PRNGKey(seed + 1)``), the dirichlet partition and
per-client loader seeds, and the cohort sampling stream
``default_rng(seed + 7777)`` (drawn by the clock).  A parity run against
the JAX package moves the reference trainer's initial state across with
``bridge.load_reference_trainer_state``.  Stragglers and int8+EF
quantization draw per-object streams the trainer does not replicate —
``validate_population_training`` rejects those knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import aggregation as agg_lib
from repro_torch.core import lora as lora_lib
from repro_torch.core import splitfl
from repro_torch.core.cost_model import lora_upload_bytes
from repro_torch.data import ClassificationLoader, dirichlet_partition, iid_partition
from repro_torch.device import resolve_device
from repro_torch.fed import metrics as M
from repro_torch.fed.config import FedRunConfig, validate_population_training
from repro_torch.fed.devices import LINK
from repro_torch.fed.population import PopulationClock, PopulationFleet
from repro_torch.fed.simulator import RoundRecord, fedavg_heads
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.tree import tree_map

__all__ = ["PopulationTrainer", "train_population"]


class PopulationTrainer:
    """Cohort-resident training state + the Simulator-mirrored math that
    the ``PopulationClock`` drives through its serve/commit callbacks."""

    def __init__(self, cfg: ModelConfig, fleet: PopulationFleet,
                 run: FedRunConfig, train, test=None, *,
                 exact: Optional[bool] = None, device="cuda"):
        validate_population_training(run, fleet.n)
        self.device = resolve_device(device)
        if run.engine.fused_lora:
            cfg = cfg.with_(lora=dataclasses.replace(cfg.lora, impl="fused"))
        self.cfg, self.fleet, self.run = cfg, fleet, run
        self.exact = (fleet.n < run.fleet.population_threshold
                      if exact is None else bool(exact))
        self.model = build_model(cfg, self.device)
        gen = torch.Generator(device=self.device)
        self.params = self.model.init_params(gen.manual_seed(run.seed))
        if self.exact:
            # the Simulator's call (same min_per_client retry loop, same
            # rng stream): the parity with it depends on it
            parts = dirichlet_partition(train.labels, fleet.n, run.alpha, run.seed)
        else:
            # population scale: the dirichlet retry loop cannot satisfy
            # min_per_client across 10^4 clients; shard IID instead (equal
            # shard sizes also keep the batched serve shapes uniform)
            parts = iid_partition(len(train.labels), fleet.n, run.seed)
        self.data_sizes = [len(p) for p in parts]
        self._parts = parts
        self._train, self.test = train, test
        # per-client loaders materialize LAZILY (seed=run.seed+u draws from
        # no shared stream, so creation order cannot perturb parity)
        self._loaders: Dict[int, ClassificationLoader] = {}
        base_lora = self.model.init_lora(gen.manual_seed(run.seed + 1))
        self.lora_spec = tree_map(torch.zeros_like, base_lora)
        self.opt = AdamW(run.lr)
        cuts = fleet.cuts
        self.store = splitfl.CohortAdapterStore(
            self.lora_spec, self.opt, base_lora, self.params.get("cls_head"),
            lambda u: int(cuts[u]))
        self._cuts = cuts
        self.link = LINK
        # per distinct cut, filled on first dispatch
        self._client_params: Dict[int, dict] = {}
        self._srv_steps: Dict[int, object] = {}
        self._cli_steps: Dict[int, tuple] = {}
        self._srv_step_batched = None
        if run.engine.cohort_chunk > 1:
            self._srv_step_batched = splitfl.make_server_step_cls_batched(
                self.model, self.opt, impl=run.engine.cohort_impl)
        # Simulator-mirrored run products
        self.history: List[RoundRecord] = []
        self.loss_events: List[tuple] = []   # (t_server_done, uid, rnd, loss)
        self._wave_losses: List[float] = []
        self._round_pull: dict = {}
        self._client_version: Dict[int, int] = {}
        self.discarded_updates: List[tuple] = []
        self.sim_clock = 0.0
        self.clock_result = None
        # edge topology / obs arrive from the clock at attach time
        self._edges = None
        self.obs = None

    # ----------------------------------------------------------------- wiring
    def _bind(self, clock: PopulationClock) -> None:
        """Called by ``PopulationClock(..., trainer=...)``: share the edge
        topology and the obs bundle so commit math and ledger pricing see
        exactly what the timing kernels see."""
        if clock.fleet is not self.fleet:
            raise ValueError("trainer and clock must share one PopulationFleet")
        self._edges = clock._edges
        self.obs = clock.obs

    # ------------------------------------------------------------ step caches
    def _client_params_for(self, cut: int) -> dict:
        pc = self._client_params.get(cut)
        if pc is None:
            pc = dict(self.params)
            pc["layers"] = lora_lib.slice_stack(self.params["layers"], 0, cut)
            self._client_params[cut] = pc
        return pc

    def _steps_for(self, cut: int):
        srv = self._srv_steps.get(cut)
        if srv is None:
            srv = splitfl.make_server_step_cls(self.model, self.opt, static_cut=cut)
            self._srv_steps[cut] = srv
            self._cli_steps[cut] = splitfl.make_client_step(self.model, self.opt, cut)
        return srv, self._cli_steps[cut]

    def _loader(self, u: int) -> ClassificationLoader:
        ld = self._loaders.get(u)
        if ld is None:
            ld = ClassificationLoader(self._train.subset(self._parts[u]),
                                      self.run.batch_size, seed=self.run.seed + u)
            self._loaders[u] = ld
        return ld

    # ------------------------------------------------------------- serve math
    def _serve_group(self, grp: List[int]) -> List[float]:
        """Simulator._serve_group, cohort-resident: per-client batch draw +
        client forward at the cut, then ONE batched/ragged server dispatch
        (or the sequential step for size-1 groups), then each client's
        backward from the tape its forward kept."""
        batches, acts, tapes = {}, {}, {}
        for u in grp:
            slot = self.store.materialize(u)
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in self._loader(u).next_batch().items()}
            cut = int(self._cuts[u])
            _, (fwd, _) = self._steps_for(cut)
            acts[u], tapes[u] = fwd(self._client_params_for(cut), slot["client_lora"], batch)
            batches[u] = batch
        if len(grp) == 1:
            u = grp[0]
            slot = self.store.slot(u)
            srv, _ = self._steps_for(int(self._cuts[u]))
            loss, new_lora, new_head, new_opt, dv = srv(
                self.params, slot["server_lora"], slot["head"],
                slot["server_opt"], acts[u], batches[u])
            slot["server_lora"], slot["head"], slot["server_opt"] = new_lora, new_head, new_opt
            self._client_backward(u, tapes.pop(u), dv)
            return [float(loss)]
        slots = [self.store.slot(u) for u in grp]
        loss_g, nl, nh, no, dv_g = self._srv_step_batched(
            self.params,
            lora_lib.stack_trees([s["server_lora"] for s in slots]),
            torch.stack([s["head"] for s in slots]),
            lora_lib.stack_trees([s["server_opt"] for s in slots]),
            torch.stack([acts[u] for u in grp]),
            lora_lib.stack_trees([batches[u] for u in grp]),
            [int(self._cuts[u]) for u in grp])
        nls, nos = lora_lib.unstack_tree(nl), lora_lib.unstack_tree(no)
        losses = []
        for i, u in enumerate(grp):
            losses.append(float(loss_g[i]))
            slot = slots[i]
            slot["server_lora"], slot["head"], slot["server_opt"] = nls[i], nh[i], nos[i]
            self._client_backward(u, tapes.pop(u), dv_g[i])
        return losses

    def _client_backward(self, u: int, tape, dv) -> None:
        _, (_, bwd) = self._steps_for(int(self._cuts[u]))
        slot = self.store.slot(u)
        slot["client_lora"], slot["client_opt"] = bwd(tape, slot["client_opt"], dv)

    # ------------------------------------------------------- sync callbacks
    def on_sync_serve(self, uids, rnd: int, t_end: float) -> None:
        """One sync dispatch group served at ``t_end`` (the clock replays
        the kernel's service records in event order, so loss events land
        exactly where Simulator._on_serve puts them)."""
        losses = self._serve_group([int(u) for u in uids])
        self._wave_losses.extend(losses)
        for u, ls in zip(uids, losses):
            self.loss_events.append((t_end, int(u), rnd, ls))

    def commit_sync(self) -> float:
        """Barrier Eq. 5-9 commit over the WHOLE fleet; returns the nominal
        up+download charge ``2*up_old (+ backhaul)`` exactly as
        Simulator._commit_sync does under a static controller."""
        resident = self.store.resident_nbytes()
        charge = (self._commit_sync_exact() if self.exact
                  else self._commit_sync_anchored())
        if self.obs is not None and self.obs.metrics is not None:
            self.obs.metrics.observe("cohort_resident_bytes", resident)
        return charge

    def _full_of(self, u: int, slot) -> dict:
        cut = int(self._cuts[u])
        return lora_lib.assemble_full(
            slot["client_lora"], lora_lib.split_lora(slot["server_lora"], cut)[1], cut)

    def _exact_states(self):
        """Every client's (client_lora, server split, head) in uid order:
        a touched client's slot, an untouched one's fresh views of the
        standing global."""
        client_loras, servers_split, heads = [], [], []
        for u in range(self.fleet.n):
            cut = int(self._cuts[u])
            slot = self.store.peek(u)
            if slot is not None:
                client_loras.append(slot["client_lora"])
                servers_split.append(lora_lib.split_lora(slot["server_lora"], cut)[1])
                heads.append(slot["head"])
            else:
                c, s = self.store.fresh_views(cut)
                client_loras.append(c)
                servers_split.append(s)
                heads.append(self.store.global_head)
        return client_loras, servers_split, heads

    def _commit_sync_exact(self) -> float:
        n = self.fleet.n
        cuts = [int(c) for c in self._cuts]
        client_loras, servers_split, heads = self._exact_states()
        if self._edges is not None:
            fulls = [lora_lib.assemble_full(client_loras[u], servers_split[u], cuts[u])
                     for u in range(n)]
            agg_full, self.edge_summaries, self.edge_masses = \
                agg_lib.hierarchical_aggregate(
                    fulls, [float(s) for s in self.data_sizes],
                    [list(cell) for cell in self._edges.cells])
        else:
            _, _, agg_full = agg_lib.aggregation_round(
                client_loras, servers_split, cuts, self.data_sizes)
        head = fedavg_heads(heads, self.data_sizes)
        up_old = max(self.link.transfer_s(lora_upload_bytes(self.cfg, cut))
                     for cut in cuts)
        self.store.reset_global(agg_full, head)
        hier = (2.0 * self._edges.backhaul_s(self._summary_bytes())
                if self._edges is not None else 0.0)
        return 2 * up_old + hier

    def _commit_sync_anchored(self) -> float:
        touched = self.store.touched()
        fulls = [self._full_of(u, self.store.slot(u)) for u in touched]
        w_t = [float(self.data_sizes[u]) for u in touched]
        absent = float(sum(self.data_sizes)) - sum(w_t)
        heads = [self.store.global_head] + [self.store.slot(u)["head"] for u in touched]
        if not touched:
            agg_full, head = self.store.global_full, self.store.global_head
        elif self._edges is not None:
            cell_of = self._edges.cell_of()
            by_cell: Dict[int, List[int]] = {c: [] for c in range(len(self._edges.cells))}
            for i, u in enumerate(touched):
                by_cell[cell_of[u]].append(i)
            touched_set = set(touched)
            cell_absent = [sum(float(self.data_sizes[u]) for u in cell
                               if u not in touched_set)
                           for cell in self._edges.cells]
            agg_full, self.edge_summaries, self.edge_masses = \
                agg_lib.anchored_hierarchical_aggregate(
                    self.store.global_full, fulls, w_t,
                    [by_cell[c] for c in range(len(self._edges.cells))], cell_absent)
            head = agg_lib.aggregate_full_weighted(heads, [absent] + w_t)
        else:
            agg_full = agg_lib.merge_into_global(self.store.global_full, fulls, w_t, absent)
            head = agg_lib.aggregate_full_weighted(heads, [absent] + w_t)
        up_old = max(self.link.transfer_s(lora_upload_bytes(self.cfg, cut))
                     for cut in sorted(set(int(c) for c in self._cuts)))
        self.store.reset_global(agg_full, head)
        hier = (2.0 * self._edges.backhaul_s(self._summary_bytes())
                if self._edges is not None else 0.0)
        return 2 * up_old + hier

    def on_sync_round_end(self, rnd: int, now: float, verbose: bool = False) -> bool:
        """Round record + eval cadence (Simulator._on_round_end); returns
        True to stop early (target accuracy reached)."""
        self.sim_clock = now
        losses, self._wave_losses = self._wave_losses, []
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        rec = RoundRecord(rnd, now, mean_loss)
        self.history.append(rec)
        return self._maybe_eval(rnd, rec, verbose)

    def _maybe_eval(self, rnd: int, rec: RoundRecord, verbose: bool) -> bool:
        run = self.run
        if (rnd + 1) % run.eval_every == 0 or rnd == run.rounds - 1:
            if self.test is None:
                return False
            rec.accuracy, rec.f1 = self.evaluate()
            if verbose:
                print(f"[population/{run.engine.scheduler}] round {rnd+1:4d} "
                      f"t={rec.sim_time_s:9.1f}s loss={rec.mean_loss:.4f} "
                      f"acc={rec.accuracy:.4f} f1={rec.f1:.4f}")
            if run.target_accuracy is not None and rec.accuracy >= run.target_accuracy:
                return True
        return False

    # ------------------------------------------------------ async callbacks
    def on_round_start(self, u: int, rnd: int, t: float) -> None:
        slot = self.store.materialize(u)
        self._round_pull[(u, rnd)] = (slot["client_lora"], slot["client_opt"],
                                      self._client_version.get(u, 0))

    def on_serve(self, ev) -> None:
        """Async ServeEvent: run each member's round on the state it pulled
        at round start, discard updates that lost a commit race
        (Simulator._on_serve)."""
        swapped = {}
        for u, r in zip(ev.uids, ev.rounds):
            pull = self._round_pull.pop((u, r), None)
            if pull is not None:
                slot = self.store.materialize(u)
                swapped[u] = (r, pull[2], slot["client_lora"], slot["client_opt"])
                slot["client_lora"], slot["client_opt"] = pull[0], pull[1]
        losses = self._serve_group([int(u) for u in ev.uids])
        for u, (r, pull_version, cur_lora, cur_opt) in swapped.items():
            if self._client_version.get(u, 0) != pull_version:
                slot = self.store.slot(u)
                slot["client_lora"], slot["client_opt"] = cur_lora, cur_opt
                self.discarded_updates.append((u, r))
                if self.obs is not None and self.obs.metrics is not None:
                    self.obs.metrics.inc("stale_discard")
        self._wave_losses.extend(losses)
        for u, r, ls in zip(ev.uids, ev.rounds, losses):
            self.loss_events.append((ev.end, int(u), r, ls))

    def commit_async(self, ev) -> float:
        """Async commit (Simulator._commit_async under nominal transport):
        staleness-discounted anchored merge into the standing global,
        redistribute to the contributors only, one wall-clock-indexed
        history record per commit."""
        run = self.run
        contribs = [int(u) for u in ev.contributors]
        fulls = [self._full_of(u, self.store.materialize(u)) for u in contribs]
        alpha = 0.0
        if run.agg.policy == "staleness":
            alpha = 0.5 if run.agg.staleness_alpha is None else run.agg.staleness_alpha
        w = [self.data_sizes[u] * agg_lib.staleness_discount(s, alpha)
             for u, s in zip(contribs, ev.staleness)]
        anchor = float(sum(self.data_sizes) - sum(self.data_sizes[u] for u in contribs))
        new_full = agg_lib.merge_into_global(self.store.global_full, fulls, w, anchor)
        new_head = agg_lib.aggregate_full_weighted(
            [self.store.global_head] + [self.store.slot(u)["head"] for u in contribs],
            [anchor] + w)
        up_old = max(self.link.transfer_s(lora_upload_bytes(self.cfg, int(self._cuts[u])))
                     for u in contribs)
        self.store.set_global(new_full, new_head)
        for u in contribs:
            # redistribute == re-materialize from the new global; split +
            # embed + opt.init reproduce the Simulator's per-field assignment
            self.store.drop(u)
            self.store.materialize(u)
            self._client_version[u] = self._client_version.get(u, 0) + 1
        ret = 2 * up_old
        losses, self._wave_losses = self._wave_losses, []
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        self.sim_clock = ev.time + ret
        rec = RoundRecord(len(self.history), self.sim_clock, mean_loss)
        self.history.append(rec)
        if len(self.history) % run.eval_every == 0 and self.test is not None:
            rec.accuracy, rec.f1 = self.evaluate()
        return ret

    def finalize_async(self, preempted: bool = False) -> None:
        """Final-state evaluation, the async analogue of the sync path's
        last-round eval (Simulator._run_event's tail)."""
        if (not preempted and self.history and self.test is not None
                and self.history[-1].accuracy is None):
            rec = self.history[-1]
            rec.accuracy, rec.f1 = self.evaluate()

    # ------------------------------------------------------------------ eval
    def _summary_bytes(self) -> float:
        return lora_upload_bytes(self.cfg, self.cfg.n_layers)

    def _global_eval_state(self):
        """(full, head) the evaluator scores — the standing async global,
        or the sync aggregate of the CURRENT per-client state (untouched
        clients stand at the global, exactly like Simulator.evaluate)."""
        if self.run.agg.policy != "sync":
            return self.store.global_full, self.store.global_head
        touched = self.store.touched()
        if not touched:
            return self.store.global_full, self.store.global_head
        if self.exact:
            client_loras, servers_split, heads = self._exact_states()
            fulls = [lora_lib.assemble_full(c, s, int(self._cuts[u]))
                     for u, (c, s) in enumerate(zip(client_loras, servers_split))]
            return (agg_lib.aggregate_full(fulls, self.data_sizes),
                    fedavg_heads(heads, self.data_sizes))
        fulls = [self._full_of(u, self.store.slot(u)) for u in touched]
        w_t = [float(self.data_sizes[u]) for u in touched]
        absent = float(sum(self.data_sizes)) - sum(w_t)
        full = agg_lib.merge_into_global(self.store.global_full, fulls, w_t, absent)
        head = agg_lib.aggregate_full_weighted(
            [self.store.global_head] + [self.store.slot(u)["head"] for u in touched],
            [absent] + w_t)
        return full, head

    @torch.no_grad()
    def evaluate(self, max_batches: int = 32):
        if self.test is None:
            raise ValueError("no held-out set was provided")
        full, head = self._global_eval_state()
        params = dict(self.params)
        params["cls_head"] = head
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

    # ------------------------------------------------------------ accounting
    def resident_nbytes(self) -> float:
        return self.store.resident_nbytes()


def train_population(cfg: ModelConfig, fleet: PopulationFleet,
                     run: FedRunConfig, train, test=None, *,
                     force: Optional[str] = None, links=None, obs=None,
                     verbose: bool = False, device="cuda") -> PopulationTrainer:
    """Build a trainer + clock pair, run the federation, return the trainer
    (carrying ``history`` / ``loss_events`` / ``clock_result`` — the same
    surface ``Simulator.run_training`` leaves behind)."""
    trainer = PopulationTrainer(cfg, fleet, run, train, test, device=device)
    clock = PopulationClock(cfg, fleet, run, force=force, links=links,
                            obs=obs, trainer=trainer)
    trainer.clock_result = clock.run(verbose=verbose)
    return trainer
