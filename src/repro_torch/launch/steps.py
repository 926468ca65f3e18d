"""The launch layer's steps: the train, prefill and serve steps of one (architecture x
input shape) on the one-card mesh.  Port of ``src/repro/launch/steps.py``.

These are what the dry-run traces and executes.  As in the reference, the
LoRA adapters and the optimizer state are ARGUMENTS of the step (never
baked in), so the server's per-client adapter switching is a swap of the
tensors passed in: the paper's memory-efficiency mechanism.  A
:class:`StepBundle`'s ``args`` are ``meta`` stand-ins (the reference's
``ShapeDtypeStruct``s): ``.analyze()`` traces the step on them
(``cost_analysis``) where the reference lowers and compiles; the same
``fn`` runs on real tensors on the mesh's card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core.splitfl import as_trainable, make_server_step, tree_grad
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import Mesh, dp_axes
from repro_torch.launch.sharding import ShardingPolicy
from repro_torch.models import build_model, input_specs, long_context_variant
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import AdamW
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass
class StepBundle:
    name: str
    cfg: ModelConfig
    fn: Callable                    # the step
    args: Tuple[PyTree, ...]        # meta stand-ins for .analyze()
    mesh: Mesh

    def analyze(self) -> cost_analysis.OpCosts:
        return cost_analysis.analyze(self.fn, *self.args)


def _dp_total(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def resolve_cfg(cfg: ModelConfig, shape: InputShape,
                swa_window: int = 8192) -> ModelConfig:
    """Apply the long-context sliding-window variant where required."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",):
        return long_context_variant(cfg, swa_window)
    return cfg


def build_step(cfg: ModelConfig, shape: InputShape, mesh: Mesh,
               policy: ShardingPolicy = ShardingPolicy(), *,
               lr: float = 1e-5, remat: bool = True) -> StepBundle:
    """The step of ``shape.kind`` for ``cfg``:

    * train — (params, lora, opt_state, batch) -> (loss, lora, opt_state):
      the full loss at cut 0 on the scan path (``remat`` honoured), its
      adapter gradients and one AdamW update; with ``policy.microbatch``
      = mb > 1, where every batch leaf divides, the mb micro-batches run in
      turn, their gradients summed and divided by mb before the one update;
    * prefill — (params, lora, batch) -> (last-token logits, caches);
    * decode — (params, lora, cache, token, pos) -> (logits, cache) at
      ``cache_len`` = the sliding window or the sequence; the cache is
      written in place (where the reference may donate it) and the
      stand-in position is the last slot, an int read on the host as
      ``serve_step`` reads it.

    The MoE dispatch runs in ``dp_size`` groups, or under
    ``policy.moe_shard_map`` as the sharded form (``moe_mlp_sharded``)."""
    cfg = resolve_cfg(cfg, shape)
    model = build_model(cfg, mesh.device)
    opt = AdamW(lr)
    dp_tot = _dp_total(mesh)
    moe_mesh = mesh if policy.moe_shard_map else None
    pspec = model.params_spec()
    lspec = model.lora_spec()

    cache_len = None
    if shape.kind == "decode":
        cache_len = cfg.sliding_window if cfg.sliding_window else shape.seq_len
    specs = input_specs(cfg, shape, model, cache_len=cache_len)

    def make_ctx(batch):
        # the VLM's vision prefix and text make up the shape's seq_len
        return model.make_ctx(shape.seq_len, batch["tokens"].device, moe_groups=dp_tot,
                              moe_mesh=moe_mesh)

    if shape.kind == "train":
        ospec = opt.init(lspec)

        def batch_loss(params, lo, batch):
            if cfg.family == "encdec":
                loss, _ = model.loss(params, lo, batch, remat=remat)
                return loss
            loss, _ = model.loss(params, lo, batch, cut=0, side="full", path="scan",
                                 remat=remat, ctx=make_ctx(batch))
            return loss

        def grads(params, lo, batch):
            with torch.enable_grad():
                loss = batch_loss(params, lo, batch)
                g, _ = tree_grad(loss, lo)
            return loss.detach(), g

        mb = max(policy.microbatch, 1)
        if mb > 1 and all(v.shape[0] % mb == 0 for v in tree_leaves(specs)):
            # gradient accumulation: the activation peak scales with B/mb;
            # one optimizer update per global batch
            def step(params, lora, opt_state, batch):
                lo = as_trainable(lora)
                loss_sum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
                g_sum = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                       device=t.device), lora)
                n = batch["tokens"].shape[0] // mb
                for i in range(mb):
                    micro = tree_map(lambda v: v[i * n:(i + 1) * n], batch)
                    loss, g = grads(params, lo, micro)
                    loss_sum = loss_sum + loss
                    g_sum = tree_map(torch.add, g_sum, g)
                g = tree_map(lambda x: x / mb, g_sum)
                new_lora, new_opt = opt.update(g, opt_state, tree_map(torch.Tensor.detach, lo))
                return loss_sum / mb, new_lora, new_opt
        else:
            def step(params, lora, opt_state, batch):
                lo = as_trainable(lora)
                loss, g = grads(params, lo, batch)
                new_lora, new_opt = opt.update(g, opt_state, tree_map(torch.Tensor.detach, lo))
                return loss, new_lora, new_opt

        return StepBundle(shape.step_name, cfg, step, (pspec, lspec, ospec, specs), mesh)

    if shape.kind == "prefill":
        @torch.no_grad()
        def step(params, lora, batch):
            if cfg.family == "encdec":
                return model.prefill(params, lora, batch)
            return model.prefill(params, lora, batch, ctx=make_ctx(batch))

        return StepBundle(shape.step_name, cfg, step, (pspec, lspec, specs), mesh)

    if shape.kind == "decode":
        window = cfg.sliding_window

        @torch.no_grad()
        def step(params, lora, cache, token, pos):
            return model.serve_step(params, lora, cache, token, pos, window=window)

        args = (pspec, lspec, specs["cache"], specs["token"], cache_len - 1)
        return StepBundle(shape.step_name, cfg, step, args, mesh)

    raise ValueError(shape.kind)


def build_server_resume_step(cfg: ModelConfig, mesh: Mesh,
                             policy: ShardingPolicy = ShardingPolicy(), *,
                             batch: int, seq_len: int, lr: float = 1e-5,
                             remat: bool = True) -> StepBundle:
    """The paper's Alg. 1 server step (Eq. 4) as one step for every cut:
    resume at a cut that is a 0-d int32 tensor, from the uploaded
    activations, through the masked scan path
    (``core.splitfl.make_server_step(path="scan")``); returns (loss,
    new_lora, new_opt, dv)."""
    model = build_model(cfg, mesh.device)
    opt = AdamW(lr)
    pspec = model.params_spec()
    lspec = model.lora_spec()
    ospec = opt.init(lspec)
    v_spec = _meta((batch, seq_len, cfg.d_model), torch_dtype(cfg.dtype))
    i32 = torch.int32
    bspec = {"tokens": _meta((batch, seq_len), i32)}
    if cfg.n_classes:
        bspec["label"] = _meta((batch,), i32)
    else:
        bspec["targets"] = _meta((batch, seq_len), i32)
    step = make_server_step(model, opt, path="scan", remat=remat)
    args = (pspec, lspec, ospec, v_spec, bspec, _meta((), i32))
    return StepBundle("server_resume_step", cfg, step, args, mesh)
