"""Plain forward of the benchmark's two families, in float32.

``dense``: a pre-norm decoder (RMSNorm with a (1 + w) scale, RoPE on the
two halves of each head, causal grouped-query attention, a SiLU-gated
MLP) with its LM head tied to the embedding.  ``encoder``: a pre-norm
encoder (LayerNorm, learned positions, bidirectional attention, a tanh
GELU MLP) with a classifier on the first position.  Each of q, k, v and o
carries a LoRA adapter: y = x W + s (x A^T) B^T.

Weights come in the layout the benchmark makes them (``harness.weights``):
stacked on a leading layer axis, (in, out) matrices.  Adapters come per
layer as ``{target: {"a": (r, in), "b": (out, r)}}``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from plainref.numerics import Precision


def rms_norm(x, w, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w.float())


def layer_norm(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def norm(mc, p, x):
    if mc["norm"] == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def rope(x, theta):
    """x (B, S, H, D) at positions 0..S-1; the two halves rotate."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def lora_proj(prec: Precision, x, w, ad, scale):
    y = prec.mm(x, w)
    if ad is not None:
        y = y + scale * prec.mm(prec.mm(x, ad["a"].t()), ad["b"].t())
    return y


def attention(prec: Precision, q, k, v, causal: bool):
    """q (B,S,H,D), k/v (B,T,K,D): each group of H/K query heads reads one
    key head."""
    h, kh, d = q.shape[2], k.shape[2], q.shape[3]
    q = q.transpose(1, 2)                                           # (B,H,S,D)
    k = k.repeat_interleave(h // kh, dim=2).permute(0, 2, 3, 1)     # (B,H,D,T)
    v = v.repeat_interleave(h // kh, dim=2).transpose(1, 2)         # (B,H,T,D)
    scores = prec.mm(q, k) / math.sqrt(d)
    if causal:
        s, t = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(s, t, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = prec.mm(probs, v).transpose(1, 2)                         # (B,S,H,D)
    return out.reshape(out.shape[0], out.shape[1], h * d)


def layer_params(params, i):
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in params.items()}


def block(mc, prec: Precision, p, ad, x):
    """One layer: p this layer's weights, ad its adapters (or None)."""
    ad = ad or {}
    scale = mc["lora"]["alpha"] / mc["lora"]["rank"]
    b, s, _ = x.shape
    hd, nh, nk = mc["head_dim"], mc["n_heads"], mc["n_kv_heads"]
    h = norm(mc, p["ln1"], x)
    att = p["attn"]
    q = lora_proj(prec, h, att["wq"], ad.get("wq"), scale).reshape(b, s, nh, hd)
    k = lora_proj(prec, h, att["wk"], ad.get("wk"), scale).reshape(b, s, nk, hd)
    v = lora_proj(prec, h, att["wv"], ad.get("wv"), scale).reshape(b, s, nk, hd)
    if mc["positional"] == "rope":
        q, k = rope(q, mc["rope_theta"]), rope(k, mc["rope_theta"])
    a = attention(prec, q, k, v, mc["causal"])
    x = x + lora_proj(prec, a, att["wo"], ad.get("wo"), scale)
    h = norm(mc, p["ln2"], x)
    mlp = p["mlp"]
    up = prec.mm(h, mlp["wu"])
    if mc["activation"] == "silu":
        up = F.silu(prec.mm(h, mlp["wg"])) * up
    elif mc["activation"] == "gelu":
        up = F.gelu(up, approximate="tanh")
    else:
        raise KeyError(mc["activation"])
    return x + prec.mm(up, mlp["wd"])


def layers(mc, prec, params, adapters, x, lo, hi):
    """Layers [lo, hi); ``adapters[i]`` holds layer i's adapters."""
    for i in range(lo, hi):
        x = block(mc, prec, layer_params(params["layers"], i), adapters.get(i), x)
    return x


def embed(mc, params, tokens):
    x = params["embed"].float()[tokens.long()]
    if mc["positional"] == "learned":
        x = x + params["pos_embed"].float()[: tokens.shape[1]]
    return x


def lm_nll_sum(mc, prec, params, h, targets):
    """The summed next-token negative log-likelihood over the tied head."""
    h = norm(mc, params["final_norm"], h)
    logits = prec.mm(h, params["embed"].t())
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (logz - gold).sum()


def cls_logits(mc, prec, params, head, h):
    h = norm(mc, params["final_norm"], h)
    return prec.mm(h[:, 0, :], head)
