"""Per-family residual blocks — the dense attention block of the encoder
slice.  Port of ``src/repro/models/blocks.py`` (``dense_init``,
``dense_train``); the MoE, RWKV6 and Mamba2 blocks come with their slices
(ROADMAP Queue A, item 10).

    init(gen, cfg, device)          -> params for ONE layer (unstacked)
    train(cfg, p, lora, x, ctx)    -> (x, aux_loss)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def dense_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    return {
        "ln1": L.init_norm(cfg, device),
        "attn": L.attn_init(gen, cfg, device),
        "ln2": L.init_norm(cfg, device),
        "mlp": L.mlp_init(gen, cfg, device),
    }


def _attn_lora(lora):
    return (lora or {}).get("attn")


def dense_train(cfg: ModelConfig, p: dict, lora, x: torch.Tensor, ctx: dict):
    pos = ctx["positions"]
    h = L.apply_norm(cfg, p["ln1"], x)
    q, k, v = L.qkv_project(cfg, p["attn"], _attn_lora(lora), h)
    a = L.attention_full(q, k, v, causal=ctx["causal"], window=ctx.get("window"),
                         q_pos=pos, k_pos=pos, impl=cfg.attn_impl)
    x = x + L.attn_out(cfg, p["attn"], _attn_lora(lora), a)
    h = L.apply_norm(cfg, p["ln2"], x)
    x = x + L.mlp_apply(cfg, p["mlp"], (lora or {}).get("mlp"), h)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


DENSE = {"init": dense_init, "train": dense_train}
BLOCKS = {"encoder": DENSE}


def get_block(cfg: ModelConfig) -> dict:
    if cfg.family not in BLOCKS:
        raise NotImplementedError(
            f"family {cfg.family!r} comes with a later slice of the port "
            "(ROADMAP Queue A, item 10)")
    return BLOCKS[cfg.family]
