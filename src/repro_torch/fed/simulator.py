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
simulated wall-clock comes from the §IV analytical model, exactly as in the
reference.  The slice covers the analytic engine with sync FedAvg over
constant links; the server serves one client per dispatch, or cohort
chunks of ``EngineConfig.cohort_chunk`` clients through the cut-grouped
ragged step (``cohort_impl="ragged"``); ``NetConfig.quantize`` sends the
activations (with error feedback) and the gradients as int8.  Every knob
outside the slice raises ``NotImplementedError`` naming the ROADMAP item
that brings it.

State updates are functional: every optimizer step and every aggregation
returns new tensors, so state the reference shares between clients (one
head for all after a commit, the frozen base weights inside each client's
truncated view) is never written through.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.comm import dequantize, quantize, quantize_with_feedback, transport_bytes
from repro_torch.configs.base import ModelConfig
from repro_torch.core import aggregation as agg_lib
from repro_torch.core import lora as lora_lib
from repro_torch.core import memory_model, splitfl
from repro_torch.core.cost_model import (DeviceProfile, LinkProfile, StepTimes,
                                         client_step_times, dtype_nbytes,
                                         lora_upload_bytes, makespan)
from repro_torch.core.scheduling import resolve_order
from repro_torch.data import ClassificationLoader, EmotionDataset, dirichlet_partition
from repro_torch.device import resolve_device
from repro_torch.fed import metrics as M
from repro_torch.fed.config import FedRunConfig, validate_run_config
from repro_torch.fed.devices import LINK, SERVER
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.tree import tree_map

SFL_FRAGMENTATION = 1.04   # multi-model GPU contention overhead (paper §V-B)


@dataclasses.dataclass
class RoundRecord:
    round: int
    sim_time_s: float
    mean_loss: float
    accuracy: Optional[float] = None
    f1: Optional[float] = None


def _not_in_slice(knob: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{knob} is not ported yet (ROADMAP Queue A, "
                               f"item {item})")


def check_slice(run: FedRunConfig) -> None:
    """Raise for every knob the port does not cover yet — none is ignored."""
    # the control and obs planes run only under the event engine, so they
    # are named before it
    if run.control.policy != "static":
        raise _not_in_slice(f"control policy={run.control.policy!r}", "8")
    if run.obs.enabled:
        raise _not_in_slice("observability (obs)", "8")
    if run.engine.mode != "analytic":
        raise _not_in_slice("engine mode='event'", "8")
    if run.engine.cohort_chunk != 1 and run.engine.cohort_impl == "vmap":
        raise _not_in_slice("engine cohort_chunk > 1 with cohort_impl='vmap' "
                            "(the masked-scan cohort step)", "6")
    if run.agg.policy != "sync":
        raise _not_in_slice(f"agg policy={run.agg.policy!r}", "8")
    if run.agg.transport != "nominal":
        raise _not_in_slice("agg transport='plane'", "8")
    if run.net.link_model != "constant" or run.net.shared:
        raise _not_in_slice("the network plane (non-constant or shared links)",
                            "8")
    if (run.snapshot_every is not None or run.resume_from is not None
            or run.preempt_at is not None):
        raise _not_in_slice("snapshots, resume and preemption", "8")
    if run.fleet.sampling != "full":
        raise _not_in_slice(f"fleet sampling={run.fleet.sampling!r}", "9")
    if run.fleet.edge_cells > 1:
        raise _not_in_slice("fleet edge_cells > 1", "9")
    if run.fleet.straggler_prob > 0:
        raise _not_in_slice("fleet straggler_prob > 0", "9")


class Simulator:
    def __init__(self, cfg: ModelConfig, devices: Optional[Sequence[DeviceProfile]] = None,
                 cuts: Optional[Sequence[int]] = None,
                 train: EmotionDataset = None,
                 test: EmotionDataset = None, run: FedRunConfig = None,
                 link: LinkProfile = LINK, server: DeviceProfile = SERVER,
                 links=None, fleet=None, *, device="cuda"):
        if links is not None:
            raise _not_in_slice("per-client LinkModels (links=)", "8")
        if fleet is not None:
            raise _not_in_slice("FleetSpec fleets (fleet=)", "9")
        if devices is None or cuts is None or run is None:
            raise TypeError("Simulator needs devices+cuts and run=")
        if len(devices) != len(cuts):
            raise ValueError("one cut per device required")
        validate_run_config(run, len(devices))
        check_slice(run)
        self.device = resolve_device(device)
        if run.engine.fused_lora:
            # thread the kernel choice through config, as the reference does
            cfg = cfg.with_(lora=dataclasses.replace(cfg.lora, impl="fused"))
        self.cfg, self.run = cfg, run
        self.devices, self.cuts = list(devices), [int(c) for c in cuts]
        self.link, self.server_dev = link, server
        self.u = len(devices)
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
        # cohort chunks: one cut-grouped ragged dispatch per cut of a chunk
        self._srv_step_batched = None
        if run.engine.cohort_chunk > 1:
            self._srv_step_batched = splitfl.make_server_step_cls_batched(
                self.model, self.opt, impl=run.engine.cohort_impl)

        # analytic per-step Eq.10 terms (fixed per client), at the nominal
        # constant link rate
        self.times: List[StepTimes] = [
            client_step_times(cfg, cut, dev, server, LinkProfile(self.link.rate_mbps),
                              run.batch_size, run.seq_len)
            for cut, dev in zip(self.cuts, self.devices)]
        self.history: List[RoundRecord] = []
        self.sim_clock = 0.0
        self._ef_residual: List[Optional[torch.Tensor]] = [None] * self.u  # uplink EF
        self._quant_ratio: Optional[float] = None
        self._times_this_round: List[StepTimes] = self.times

    # ------------------------------------------------------------------ time
    def _transport_ratio(self) -> float:
        """int8+EF wireless shrink factor (cached; same every round)."""
        if self._quant_ratio is None:
            shape = (self.run.batch_size, self.run.seq_len, self.cfg.d_model)
            nb = dtype_nbytes(self.cfg.dtype)
            self._quant_ratio = (transport_bytes(shape, True, nb)
                                 / transport_bytes(shape, False, nb))
        return self._quant_ratio

    def _adjusted_times(self) -> List[StepTimes]:
        """Per-round Eq.10 terms: int8+EF transport shrinks both wireless
        transfers ~4x (stragglers are outside the slice)."""
        if not self.run.net.quantize:
            return self.times
        ratio = self._transport_ratio()
        return [dataclasses.replace(st, t_fc=st.t_fc * ratio, t_bc=st.t_bc * ratio,
                                    fc_bytes=st.fc_bytes * ratio,
                                    bc_bytes=st.bc_bytes * ratio)
                for st in self.times]

    def _service_plan(self) -> List[List[int]]:
        """This round's server dispatch groups in order: chunks of
        ``cohort_chunk`` clients of the scheduled order."""
        tfl = [d.tflops for d in self.devices]
        chunk = max(1, int(self.run.engine.cohort_chunk))
        order = resolve_order(self.run.engine.scheduler, self._times_this_round,
                              self.cuts, tfl)
        return [order[i:i + chunk] for i in range(0, len(order), chunk)]

    def _round_time(self, order: Sequence[int]) -> float:
        t = self._times_this_round
        if self.run.scheme == "ours":
            span, _, _ = makespan(t, order)
            return span
        if self.run.scheme == "sfl":
            # all server submodels train concurrently on one GPU: fair-share
            # finish at max(arrival) + contended total work
            start = max(st.ready for st in t)
            busy = sum(st.t_s for st in t) * SFL_FRAGMENTATION
            return start + busy + max(st.t_bc + st.t_b for st in t)
        if self.run.scheme == "sl":
            # strictly sequential + client-side model handoff between clients
            mb = memory_model.model_bytes(self.cfg)
            total = 0.0
            for u, st in enumerate(t):
                handoff = self.link.transfer_s(mb.embed + self.cuts[u] * mb.per_layer)
                total += st.ready + st.t_s + st.t_bc + st.t_b + handoff
            return total
        raise KeyError(self.run.scheme)

    # ------------------------------------------------------------------ round
    def run_round(self, rnd: int) -> RoundRecord:
        """One closed-form (analytic-engine) barrier round."""
        self._times_this_round = self._adjusted_times()
        if self.run.scheme == "sl":
            losses, order = self._round_sl()
        else:
            losses, order = self._round_parallel()
        self.sim_clock += self._round_time(order)
        # aggregation phase (not for SL)
        if self.run.scheme != "sl" and (rnd + 1) % self.run.agg.interval == 0:
            self.sim_clock += self._commit_sync()
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
            order.extend(grp)
            losses.extend(self._serve_group(grp))
        return losses, order

    def _batch(self, u: int) -> dict:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in self.loaders[u].next_batch().items()}

    def _serve_group(self, grp: List[int]) -> List[float]:
        """The real math of one server dispatch: each client's batch draw
        and forward (with the int8+EF uplink under ``net.quantize``), then
        the server step at its cut (one client) or ONE cut-grouped ragged
        dispatch (a cohort chunk), then each client's backward.  Every
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
        """Dataset-weighted FedAvg of the heads, summed from Python 0 in
        client order as the reference does."""
        w = np.array(self.data_sizes, np.float64)
        w /= w.sum()
        return sum(float(wi) * h for wi, h in zip(w, self.heads))

    def _commit_sync(self) -> float:
        """Barrier aggregation (Alg. 1 l.17-30, Eqs. 5-9) over the whole
        fleet; returns the adapter upload + download time at the nominal
        link."""
        servers_split = [lora_lib.split_lora(self.server_lora[u], self.cuts[u])[1]
                         for u in range(self.u)]
        new_c, new_s, _ = agg_lib.aggregation_round(
            self.client_lora, servers_split, self.cuts, self.data_sizes)
        up = max(self.link.transfer_s(lora_upload_bytes(self.cfg, cut))
                 for cut in self.cuts)
        self.client_lora = new_c
        self.server_lora = [
            lora_lib.embed_in_full_shape(s, self.lora_spec, cut, "server")
            for s, cut in zip(new_s, self.cuts)]
        head = self._fedavg_head()
        self.heads = [head] * self.u
        # optimizer states reset to match redistributed adapters
        self.client_opt = [self.opt.init(c) for c in self.client_lora]
        self.server_opt = [self.opt.init({"lora": s, "head": self.heads[u]})
                           for u, s in enumerate(self.server_lora)]
        return 2 * up

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
        """Global model = aggregate of the current full adapters (ours/sfl)
        or the traveling set (sl), evaluated centrally on the held-out
        set."""
        params = dict(self.params)
        if self.run.scheme == "sl":
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
        round and its evaluation (a hook for per-round measurements)."""
        for rnd in range(self.run.rounds):
            rec = self.run_round(rnd)
            stop = self._maybe_eval(rnd, rec, verbose)
            if on_round is not None:
                on_round(rec)
            if stop:
                break
        return self.history

    def server_memory_report(self) -> memory_model.ServerMemoryReport:
        """The modelled server bytes of this run's scheme at its cuts
        (paper Table I)."""
        return memory_model.server_memory(
            self.cfg, self.run.scheme, self.cuts,
            self.run.batch_size, self.run.seq_len)
