"""Per-family residual blocks: the dense attention block (encoder, dense
decoder LM and the VLM's language model, with an optional int8 KV cache),
the MoE block (dense attention and a capacity-based top-k expert
dispatch), the RWKV6 "Finch" block, the Mamba2 (SSD) block of the
hybrid family's backbone, and the per-layer hybrid's layer (a Mamba2 or
an attention mixer, then an MLP; ``ModelConfig.layer_types``).  Port of
``src/repro/models/blocks.py``, with the per-layer hybrid the port's own.

    init(gen, cfg, device)                   -> params for ONE layer (unstacked)
    train(cfg, p, lora, x, ctx)              -> (x, aux_loss)
    prefill(cfg, p, lora, x, ctx)            -> (x, cache, aux_loss)
    init_cache(cfg, batch, cache_len, device) -> cache for one layer
    decode(cfg, p, lora, x, cache, pos, ctx) -> (x, cache)

``ctx`` is a plain dict: positions, causal, window, ``arange`` (the
positions are 0..S-1, built so by the model), and for the MoE block
``moe_groups`` (the tokens split into that many equal dispatch groups,
each with its own capacity, sort and aux loss), ``moe_dense_fallback``
(every expert on every token, as decode runs) and ``moe_aux_rows`` (the
aux loss returned per batch row, each row its group's, for groups that
are whole rows: the port's form of a vmapped per-lane aux, which the
masked scan sets for a per-row cut), and ``moe_mesh`` (a one-card mesh:
the sharded form, ``moe_mlp_sharded``).  ``decode`` writes the
new token's state into ``cache`` in place (a per-layer view of the
model's stacked cache) and returns it: the reference returns an updated
copy, which the caller then uses in place of the old one.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.models import layers as L
from repro_torch.obs import wall

Tensor = torch.Tensor


# ===========================================================================
# dense attention block
# ===========================================================================

def dense_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    return {
        "ln1": L.init_norm(cfg, device),
        "attn": L.attn_init(gen, cfg, device),
        "ln2": L.init_norm(cfg, device),
        "mlp": L.mlp_init(gen, cfg, device),
    }


def _attn_lora(lora):
    return (lora or {}).get("attn")


def _residual(cfg: ModelConfig, x: Tensor, o: Tensor) -> Tensor:
    """x plus the branch ``o``, times ``residual_multiplier`` where that is not 1."""
    m = cfg.residual_multiplier
    return x + o if m == 1.0 else x + o * m


def _attention_branch(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    """norm, then attention (the softmax scale ``attention_multiplier``):
    the branch's output and the roped K/V."""
    pos = ctx["positions"]
    with wall.span("norm") as sp:
        h = sp.output(L.apply_norm(cfg, p["ln1"], sp.input(x)))
    with wall.span("attention") as sp:
        q, k, v = L.qkv_project(cfg, p["attn"], _attn_lora(lora), sp.input(h), pos)
        a = L.attention_full(q, k, v, causal=ctx["causal"], window=ctx.get("window"),
                             q_pos=pos, k_pos=pos, impl=cfg.attn_impl,
                             arange=ctx.get("arange", False), chunk=cfg.attn_chunk,
                             scale=cfg.attention_multiplier)
        o = sp.output(L.attn_out(cfg, p["attn"], _attn_lora(lora), a))
    return o, k, v


def _mlp_residual(cfg: ModelConfig, p: dict, lora, x: Tensor) -> Tensor:
    """norm, then the MLP, added to the residual."""
    with wall.span("norm") as sp:
        h = sp.output(L.apply_norm(cfg, p["ln2"], sp.input(x)))
    with wall.span("mlp") as sp:
        o = sp.output(L.mlp_apply(cfg, p["mlp"], (lora or {}).get("mlp"), sp.input(h)))
    return _residual(cfg, x, o)


def dense_prefill(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    """The training forward; also returns the roped K/V as the cache contents."""
    o, k, v = _attention_branch(cfg, p, lora, x, ctx)
    # each branch's output is freed once added, as a temporary would be: held
    # to the return, it shifts the caching allocator's blocks and its peak
    x = _residual(cfg, x, o)
    del o
    x = _mlp_residual(cfg, p, lora, x)
    return x, {"k": k, "v": v}, torch.zeros((), dtype=torch.float32, device=x.device)


def dense_train(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    x, _, aux = dense_prefill(cfg, p, lora, x, ctx)
    return x, aux


def dense_init_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> dict:
    """Zero K/V of (B, T, K, Dh) in the model's type; with
    ``kv_cache_dtype="int8"`` int8 codes and one f32 absmax scale per
    (token, head) instead (about 0.53x the bytes)."""
    shp = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        sshp = (batch, cache_len, cfg.n_kv_heads)
        return {"k": torch.zeros(shp, dtype=torch.int8, device=device),
                "v": torch.zeros(shp, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshp, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(sshp, dtype=torch.float32, device=device)}
    dt = L.torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shp, dtype=dt, device=device),
            "v": torch.zeros(shp, dtype=dt, device=device)}


def _quant_rows(x: Tensor):
    """x: (B,1,K,D) -> (int8 codes, (B,1,K) f32 scales): the per-row absmax
    code of the reference, in plain PyTorch as there (round half to even)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _decode_attn(cfg: ModelConfig, p: dict, lora, h: Tensor, cache: dict,
                 pos: int, ctx: dict):
    """Write this token's K/V into the cache, attend, return the context.

    Under a window the slot is ``pos % cache_len``; without one it is
    ``pos``, clamped to the last slot as ``jax.lax.dynamic_update_slice``
    clamps an out-of-range start (there every slot is then valid).  A cache
    with ``k_scale`` holds int8 codes: the token's K/V are quantized per
    (token, head) row, written with their scales, and the whole cache is
    read back dequantized in ``h``'s type."""
    window = ctx.get("window")
    cache_len = cache["k"].shape[1]
    q, k, v = L.qkv_project(cfg, p, lora, h, ctx["positions"])
    slot = pos % cache_len if window is not None else min(pos, cache_len - 1)
    if "k_scale" in cache:
        for name, t in (("k", k), ("v", v)):
            codes, scale = _quant_rows(t)
            cache[name][:, slot] = codes[:, 0]
            cache[name + "_scale"][:, slot] = scale[:, 0]
        k_read, v_read = ((cache[name].float() * cache[name + "_scale"][..., None]).to(h.dtype)
                          for name in ("k", "v"))
    else:
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        k_read, v_read = cache["k"], cache["v"]
    idx = torch.arange(cache_len, device=h.device)
    valid = idx < min(pos + 1, cache_len) if window is not None else idx <= pos
    return L.attention_decode(q, k_read, v_read, valid, cfg.attention_multiplier), cache


def dense_decode(cfg: ModelConfig, p: dict, lora, x: Tensor, cache: dict,
                 pos: int, ctx: dict):
    h = L.apply_norm(cfg, p["ln1"], x)
    a, cache = _decode_attn(cfg, p["attn"], _attn_lora(lora), h, cache, pos, ctx)
    x = _residual(cfg, x, L.attn_out(cfg, p["attn"], _attn_lora(lora), a))
    h = L.apply_norm(cfg, p["ln2"], x)
    x = _residual(cfg, x, L.mlp_apply(cfg, p["mlp"], (lora or {}).get("mlp"), h))
    return x, cache


DENSE = {"init": dense_init, "train": dense_train, "prefill": dense_prefill,
         "decode": dense_decode, "init_cache": dense_init_cache}


# ===========================================================================
# MoE block: dense attention + sorted capacity-based top-k expert dispatch
# ===========================================================================

def moe_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    m = cfg.moe
    d, ff, e = cfg.d_model, m.d_ff_expert, m.num_experts
    dt = L.torch_dtype(cfg.dtype)
    p = {"ln1": L.init_norm(cfg, device), "attn": L.attn_init(gen, cfg, device),
         "ln2": L.init_norm(cfg, device)}
    experts = {"we_u": (L._normal(gen, (e, d, ff), device) / math.sqrt(d)).to(dt),
               "we_d": (L._normal(gen, (e, ff, d), device) / math.sqrt(ff)).to(dt)}
    if cfg.activation in ("silu", "geglu"):      # gated
        experts["we_g"] = (L._normal(gen, (e, d, ff), device) / math.sqrt(d)).to(dt)
    p["wr_router"] = L.dense_init(gen, d, e, torch.float32, device)
    p["experts"] = experts
    return p


def _router(cfg: ModelConfig, p: dict, lora, xg: Tensor):
    """xg: (T, d) -> normalized top-k gates (T, k), expert ids (T, k) and the
    router's probabilities (T, E), in f32 (the router and its adapter are
    f32 whatever the model's type)."""
    scale = cfg.lora.alpha / cfg.lora.rank
    logits = L.lora_apply(xg.float(), p["wr_router"], (lora or {}).get("wr_router"),
                          scale, impl=cfg.lora.impl)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gates, eidx, probs


def _expert_ffn(cfg: ModelConfig, ex: dict, xec: Tensor) -> Tensor:
    """xec: (E, C, d) -> (E, C, d), every expert's gated MLP on its slots."""
    up = torch.bmm(xec, ex["we_u"].to(xec.dtype))
    if "we_g" in ex:
        up = L._act(cfg, torch.bmm(xec, ex["we_g"].to(xec.dtype))) * up
    else:
        up = L._act(cfg, up)
    return torch.bmm(up, ex["we_d"].to(xec.dtype))


def _expert_counts(flat_e: Tensor, e: int) -> Tensor:
    """Entries routed to each of the e experts.  ``torch.bincount`` would
    read the largest id back to the host to size its output (a sync per
    layer and decode step); an integer scatter-add into e slots does not,
    and integer sums do not depend on the order of the adds."""
    return torch.zeros(e, dtype=torch.long, device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))


def _aux_loss(cfg: ModelConfig, counts: Tensor, probs: Tensor) -> Tensor:
    """Switch-style load-balance loss: E * <fraction routed, mean prob>."""
    frac = counts.float() / counts.sum()
    return cfg.moe.num_experts * torch.dot(frac, probs.mean(dim=0)) * cfg.moe.router_aux_coef


def _moe_group_sorted(cfg: ModelConfig, p: dict, lora, xg: Tensor, routed=None):
    """Capacity-based sorted dispatch within one group. xg: (T, d).

    ``routed`` is the group's (gates, ids, probs) when the caller routed
    every group at once (:func:`moe_mlp`), else the router runs here.  The
    reference's scatter-adds become gathers: each (token, choice) entry,
    sorted stably by expert, keeps slot ``pos_in_seg`` of its expert while
    that is below the capacity (later ones drop); each kept slot takes its
    one entry, each entry its one slot, and each token sums its k gated
    results in choice order.  No index receives two contributions, so no
    value depends on the order of atomic adds, forward or backward."""
    m = cfg.moe
    t, d = xg.shape
    k, e = m.top_k, m.num_experts
    gates, eidx, probs = routed if routed is not None else _router(cfg, p, lora, xg)
    n = t * k
    cap = max(1, int(math.ceil(n / e * m.capacity_factor)))
    dev = xg.device

    flat_e = eidx.reshape(-1)                          # (N,) entry t*k + j
    order = torch.sort(flat_e, stable=True).indices    # sorted position -> entry
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)           # entry -> sorted position
    sorted_e = flat_e[order]
    counts = _expert_counts(flat_e, e)
    seg_start = torch.cumsum(counts, 0) - counts
    pos_in_seg = torch.arange(n, device=dev) - seg_start[sorted_e]
    keep = pos_in_seg < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_seg,
                       torch.full_like(pos_in_seg, e * cap))   # e*cap: dropped

    # dispatch: slot (expert, c) takes sorted entry seg_start + c while c is
    # below its expert's count, else the zero row at index n
    x_sel = xg[:, None, :].expand(t, k, d).reshape(n, d)[order]
    slot = torch.arange(cap, device=dev)
    src = torch.where(slot[None, :] < counts[:, None], seg_start[:, None] + slot[None, :],
                      torch.full((e, cap), n, dtype=seg_start.dtype, device=dev))
    buf = F.pad(x_sel, (0, 0, 0, 1))[src.reshape(-1)].reshape(e, cap, d)
    y = _expert_ffn(cfg, p["experts"], buf).reshape(e * cap, d)
    y_sorted = F.pad(y, (0, 0, 0, 1))[dest]            # dropped entries read zeros
    g_sorted = gates.reshape(-1)[order].to(y_sorted.dtype)
    contrib = (y_sorted * g_sorted[:, None])[inv].reshape(t, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out.to(xg.dtype), _aux_loss(cfg, counts, probs)


def _moe_group_dense(cfg: ModelConfig, p: dict, lora, xg: Tensor, routed=None):
    """Compute-all-experts fallback for tiny token counts (decode)."""
    m = cfg.moe
    t, d = xg.shape
    gates, eidx, probs = routed if routed is not None else _router(cfg, p, lora, xg)
    y_all = _expert_ffn(cfg, p["experts"], xg[None].expand(m.num_experts, t, d))
    onehot = F.one_hot(eidx, m.num_experts).to(xg.dtype)          # (T,k,E)
    comb = torch.einsum("tke,tk->te", onehot, gates.to(xg.dtype))
    out = torch.einsum("etd,te->td", y_all, comb)
    return out, _aux_loss(cfg, _expert_counts(eidx.reshape(-1), m.num_experts), probs)


def moe_mlp(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    """The expert MLP over x (B, S, d): the tokens split into ``moe_groups``
    equal groups (one when they do not divide), each dispatched alone as
    the reference's ``jax.vmap`` over groups does.  The router runs once
    over every token, so that a cohort-grouped (G, r, d) router adapter
    meets its own lane's rows (the tokens are lane-major); the groups then
    take their slices.  Returns (out, aux): aux the mean of the groups',
    or with ``moe_aux_rows`` one per batch row, its group's.  With
    ``ctx["moe_mesh"]`` set (and the dense fallback off) the sharded form
    runs instead (:func:`moe_mlp_sharded`), as in the reference."""
    if ctx.get("moe_mesh") is not None and not ctx.get("moe_dense_fallback"):
        return moe_mlp_sharded(cfg, p, lora, x, ctx)
    b, s, d = x.shape
    groups = max(1, ctx.get("moe_groups", 1))
    tokens = b * s
    if tokens % groups:
        groups = 1
    x2 = x.reshape(tokens, d)
    gates, eidx, probs = _router(cfg, p, lora, x2)
    fn = _moe_group_dense if ctx.get("moe_dense_fallback") else _moe_group_sorted
    tg = tokens // groups
    outs, auxs = [], []
    for i in range(groups):
        sl = slice(i * tg, (i + 1) * tg)
        o, a = fn(cfg, p, lora, x2[sl], routed=(gates[sl], eidx[sl], probs[sl]))
        outs.append(o)
        auxs.append(a)
    out = (outs[0] if groups == 1 else torch.cat(outs)).reshape(b, s, d)
    aux = torch.stack(auxs)
    if ctx.get("moe_aux_rows"):
        if b % groups:
            raise ValueError(f"moe_aux_rows needs groups of whole rows: {b} rows "
                             f"in {groups} groups")
        return out, aux.repeat_interleave(b // groups)
    return out, aux.mean()


def moe_mlp_sharded(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    """The reference's ``shard_map`` MoE on the one-card mesh: its local
    function over every token, which is :func:`moe_mlp` with
    ``cfg.moe_token_chunks`` dispatch groups (one when the tokens do not
    divide), each with its own capacity and drops, the aux loss averaged
    over them (the reference scans the blocks so that one block's capacity
    buffers are alive at a time).  Its ``psum`` over "model" and ``pmean``
    over the dp axes are the identity at size 1; ``moe_groups`` and
    ``moe_aux_rows`` are not read, as the reference's local function does
    not read them."""
    return moe_mlp(cfg, p, lora, x, {**ctx, "moe_mesh": None,
                                     "moe_groups": max(1, cfg.moe_token_chunks),
                                     "moe_aux_rows": False})


def moe_prefill(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    """The training forward; also returns the roped K/V as the cache contents."""
    pos = ctx["positions"]
    h = L.apply_norm(cfg, p["ln1"], x)
    q, k, v = L.qkv_project(cfg, p["attn"], _attn_lora(lora), h, pos)
    a = L.attention_full(q, k, v, causal=ctx["causal"], window=ctx.get("window"),
                         q_pos=pos, k_pos=pos, impl=cfg.attn_impl,
                         arange=ctx.get("arange", False), chunk=cfg.attn_chunk)
    x = x + L.attn_out(cfg, p["attn"], _attn_lora(lora), a)
    h = L.apply_norm(cfg, p["ln2"], x)
    y, aux = moe_mlp(cfg, p, lora, h, ctx)
    return x + y, {"k": k, "v": v}, aux


def moe_train(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    x, _, aux = moe_prefill(cfg, p, lora, x, ctx)
    return x, aux


def moe_decode(cfg: ModelConfig, p: dict, lora, x: Tensor, cache: dict,
               pos: int, ctx: dict):
    h = L.apply_norm(cfg, p["ln1"], x)
    a, cache = _decode_attn(cfg, p["attn"], _attn_lora(lora), h, cache, pos, ctx)
    x = x + L.attn_out(cfg, p["attn"], _attn_lora(lora), a)
    h = L.apply_norm(cfg, p["ln2"], x)
    y, _ = moe_mlp(cfg, p, lora, h, dict(ctx, moe_dense_fallback=True))
    return x + y, cache


MOE = {"init": moe_init, "train": moe_train, "prefill": moe_prefill,
       "decode": moe_decode, "init_cache": dense_init_cache}


# ===========================================================================
# RWKV6 "Finch" block: time-mix (data-dependent decay WKV) + channel-mix
# ===========================================================================

def _rwkv_dims(cfg: ModelConfig):
    dh = cfg.ssm.head_dim
    return cfg.d_model // dh, dh  # (H, Dh)


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    s = cfg.ssm
    h, dh = _rwkv_dims(cfg)
    dt = L.torch_dtype(cfg.dtype)
    f32 = torch.float32

    def full(shape, value):
        return torch.full(shape, value, dtype=f32, device=device)

    tm = {
        "ln": L.init_norm(cfg, device),
        "mu_x": full((d,), 0.5),
        "mu": full((5, d), 0.5),
        "w1": L.dense_init(gen, d, 5 * s.ddlerp_rank, f32, device),
        "w2": L._normal(gen, (5, s.ddlerp_rank, d), device) * 0.01,
        "w0": full((d,), -6.0),                        # decay base (slow decay)
        "wd1": L.dense_init(gen, d, s.decay_rank, f32, device),
        "wd2": L.dense_init(gen, s.decay_rank, d, f32, device) * 0.1,
        "u": L._normal(gen, (h, dh), device) * 0.5,
        "wr": L.dense_init(gen, d, d, dt, device),
        "wk": L.dense_init(gen, d, d, dt, device),
        "wv": L.dense_init(gen, d, d, dt, device),
        "wg": L.dense_init(gen, d, d, dt, device),
        "wo": L.dense_init(gen, d, d, dt, device),
        "ln_x_scale": full((d,), 1.0),
        "ln_x_bias": full((d,), 0.0),
    }
    cm = {
        "ln": L.init_norm(cfg, device),
        "mu_k": full((d,), 0.5),
        "mu_r": full((d,), 0.5),
        "wk": L.dense_init(gen, d, ff, dt, device),
        "wv": L.dense_init(gen, ff, d, dt, device),
        "wr": L.dense_init(gen, d, d, dt, device),
    }
    return {"tm": tm, "cm": cm}


def _ddlerp(p: dict, x: Tensor, x_prev: Tensor):
    """Data-dependent lerp producing the 5 mixed inputs (w,k,v,r,g)."""
    xx = x_prev - x
    xxx = x + xx * p["mu_x"].to(x.dtype)
    proj = torch.tanh(xxx.float() @ p["w1"])
    b, s, _ = proj.shape
    proj = proj.reshape(b, s, 5, -1)
    deltas = torch.einsum("bsfr,frd->bsfd", proj, p["w2"])
    m = p["mu"][None, None] + deltas                   # (B,S,5,d)
    mixed = x[:, :, None, :] + xx[:, :, None, :] * m.to(x.dtype)
    return [mixed[:, :, i, :] for i in range(5)]


def _tm_projections(cfg: ModelConfig, p: dict, lora, x: Tensor, x_prev: Tensor):
    """Everything in the time-mix up to (and excluding) the WKV recurrence."""
    scale = cfg.lora.alpha / cfg.lora.rank
    impl = cfg.lora.impl
    lget = (lora or {}).get
    h, dh = _rwkv_dims(cfg)
    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)
    w = p["w0"] + torch.tanh(xw.float() @ p["wd1"]) @ p["wd2"]
    decay = torch.exp(-torch.exp(w))                   # (B,S,d) in (0,1)
    r = L.lora_apply(xr, p["wr"], lget("wr"), scale, impl=impl)
    k = L.lora_apply(xk, p["wk"], lget("wk"), scale, impl=impl)
    v = L.lora_apply(xv, p["wv"], lget("wv"), scale, impl=impl)
    g = F.silu(L.lora_apply(xg, p["wg"], lget("wg"), scale, impl=impl))
    b, s, _ = x.shape
    shp = (b, s, h, dh)
    return (r.reshape(shp), k.reshape(shp), v.reshape(shp),
            decay.reshape(shp), g)


def wkv_scan(r: Tensor, k: Tensor, v: Tensor, decay: Tensor, u: Tensor,
             state: Tensor):
    """Sequential WKV. r/k/v/decay: (B,S,H,Dh); u: (H,Dh); state: (B,H,Dh,Dh).

    out_t = r_t . (S_{t-1} + u*k_t (x) v_t);  S_t = diag(decay_t) S_{t-1} + k_t (x) v_t
    Returns (out (B,S,H,Dh) f32, final_state).  The same recurrence as the
    WKV6 kernel's plain version, from any state.
    """
    return wkv6_ref(r, k, v, decay, u, state)


def wkv_chunked(r: Tensor, k: Tensor, v: Tensor, decay: Tensor, u: Tensor,
                state: Tensor, chunk: int = 16):
    """Chunk-parallel WKV in plain PyTorch, the reference's formulation.

    Within a chunk (log-space cumulative decay logP; every exponent is <= 0
    except k_j * exp(-logP_j), which the short chunk bounds):

      out_t = r_t.(P_{t-1} o S0)  +  sum_{j<t} (r_t o P_{t-1}).(k_j / P_j) v_j
              + r_t.(u o k_t) v_t
      S_end = P_C o S0 + sum_j (P_C / P_j o k_j) (x) v_j

    r/k/v/decay: (B,S,H,Dh); u: (H,Dh); state: (B,H,Dh,Dh).  Returns (out
    (B,S,H,Dh) f32, final state f32).  Differentiable, from any state."""
    b, s, h, d = r.shape
    pad = (-s) % chunk
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        decay = 1.0 - F.pad(1.0 - decay, (0, 0, 0, 0, 0, pad))   # pad decay with ones
    nc = (s + pad) // chunk

    def to_chunks(a):   # (B,T,H,D) -> (B, nc, C, H, D)
        return a.reshape(b, nc, chunk, h, d).float()

    rc, kc, vc, wc = map(to_chunks, (r, k, v, decay))
    logw = torch.log(torch.clamp_min(wc, 1e-38))                  # <= 0
    tri_lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                      device=r.device), -1)        # j < t
    eye = torch.eye(chunk, dtype=torch.float32, device=r.device)
    uf = u.float()[None, None]
    s0 = state.float()
    outs = []
    for i in range(nc):
        rr, kk, vv, lw = rc[:, i], kc[:, i], vc[:, i], logw[:, i]   # (B,C,H,D)
        lp = torch.cumsum(lw, dim=1)                   # logP_t (inclusive)
        lp_prev = lp - lw                              # logP_{t-1}
        a = rr * torch.exp(lp_prev)                    # stable
        bb = kk * torch.exp(-lp)                       # bounded by the short chunk
        # intra-chunk scores A[t,j] = (a_t . b_j) for j<t, + u-diag for j=t
        scores = torch.einsum("bthd,bjhd->bhtj", a, bb) * tri_lower
        diag = torch.einsum("bthd,bthd->bht", rr * uf, kk)
        scores = scores + diag[..., :, None] * eye
        intra = torch.einsum("bhtj,bjhd->bthd", scores, vv)
        # inter-chunk: r_t . (P_{t-1} o S0)
        inter = torch.einsum("bthd,bhdv->bthv", a, s0)
        # state update: S_end = P_C o S0 + sum_j (P_C/P_j o k_j) (x) v_j
        pc = lp[:, -1]                                 # (B,H,D)
        kfac = kk * torch.exp(pc[:, None] - lp)        # exponents <= 0
        s0 = torch.exp(pc)[..., None] * s0 + torch.einsum("bjhd,bjhv->bhdv", kfac, vv)
        outs.append(intra + inter)
    out = torch.stack(outs, dim=1).reshape(b, s + pad, h, d)
    return out[:, :s], s0


# how the WKV recurrence of a whole sequence executes (ModelConfig.wkv_impl):
#   scan    — one step after the other in plain PyTorch (the reference's default);
#   chunked — chunk-parallel: the hand-written WKV6 kernel (kernels/wkv6.py,
#             whose wrapper takes the plain version for CPU tensors) where
#             its domain allows, else the reference's plain chunked form
#             (:func:`wkv_chunked`).
WKV_IMPLS = ("scan", "chunked")


def wkv_apply(cfg: ModelConfig, r, k, v, decay, u, state: Optional[Tensor] = None):
    """WKV over a sequence from ``state`` (None: zeros).  ``chunked`` runs the
    kernel inside its domain, decided before any launch: a zero initial
    state (``state=None``) and no gradient asked for (the kernel is
    forward-only, as the reference's has no VJP); the kernel tiles time
    itself.  Otherwise :func:`wkv_chunked` runs over ``wkv_chunk`` steps."""
    if cfg.wkv_impl not in WKV_IMPLS:
        raise KeyError(f"unknown wkv impl {cfg.wkv_impl!r}; choose from {WKV_IMPLS}")
    if cfg.wkv_impl == "chunked" and state is None and not L.needs_grad(r, k, v, decay, u):
        from repro_torch.kernels.ops import wkv6_apply
        return wkv6_apply(r, k, v, decay, u)
    if state is None:
        b, _, h, dh = r.shape
        state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    if cfg.wkv_impl == "chunked":
        return wkv_chunked(r, k, v, decay, u, state, chunk=cfg.wkv_chunk)
    return wkv_scan(r, k, v, decay, u, state)


def _tm_out(cfg: ModelConfig, p: dict, lora, wkv_out: Tensor, g: Tensor):
    scale = cfg.lora.alpha / cfg.lora.rank
    b, s, h, dh = wkv_out.shape
    o = L.group_norm(wkv_out.reshape(b, s, h * dh).to(g.dtype),
                     p["ln_x_scale"], p["ln_x_bias"], n_groups=h)
    return L.lora_apply(o * g, p["wo"], (lora or {}).get("wo"), scale,
                        impl=cfg.lora.impl)


def _shift(x: Tensor, x_last: Optional[Tensor] = None):
    """Token shift: x_prev[t] = x[t-1]; first position uses x_last (or 0)."""
    pad = torch.zeros_like(x[:, :1]) if x_last is None else x_last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _cm_apply(cfg: ModelConfig, p: dict, lora, x: Tensor, x_prev: Tensor):
    scale = cfg.lora.alpha / cfg.lora.rank
    impl = cfg.lora.impl
    lget = (lora or {}).get
    xx = x_prev - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    kk = F.relu(L.lora_apply(xk, p["wk"], lget("wk"), scale, impl=impl)).square()
    vv = L.lora_apply(kk, p["wv"], lget("wv"), scale, impl=impl)
    return torch.sigmoid(L.lora_apply(xr, p["wr"], lget("wr"), scale, impl=impl)) * vv


def rwkv_prefill(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    tm, cm = p["tm"], p["cm"]
    ltm, lcm = (lora or {}).get("tm"), (lora or {}).get("cm")
    hx = L.apply_norm(cfg, tm["ln"], x)
    shift_tm = hx[:, -1]
    r, k, v, decay, g = _tm_projections(cfg, tm, ltm, hx, _shift(hx))
    out, state = wkv_apply(cfg, r, k, v, decay, tm["u"])
    x = x + _tm_out(cfg, tm, ltm, out.to(x.dtype), g)
    hx = L.apply_norm(cfg, cm["ln"], x)
    shift_cm = hx[:, -1]
    x = x + _cm_apply(cfg, cm, lcm, hx, _shift(hx))
    dt = L.torch_dtype(cfg.dtype)
    cache = {"shift_tm": shift_tm.to(dt), "shift_cm": shift_cm.to(dt), "s": state}
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def rwkv_train(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    x, _, aux = rwkv_prefill(cfg, p, lora, x, ctx)
    return x, aux


def rwkv_init_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> dict:
    h, dh = _rwkv_dims(cfg)
    d = cfg.d_model
    dt = L.torch_dtype(cfg.dtype)
    return {"shift_tm": torch.zeros((batch, d), dtype=dt, device=device),
            "shift_cm": torch.zeros((batch, d), dtype=dt, device=device),
            "s": torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device)}


def rwkv_decode(cfg: ModelConfig, p: dict, lora, x: Tensor, cache: dict,
                pos: int, ctx: dict):
    """One step from the cached shifts and state, through ``wkv_scan`` as in
    the reference (the kernel starts from a zero state)."""
    tm, cm = p["tm"], p["cm"]
    ltm, lcm = (lora or {}).get("tm"), (lora or {}).get("cm")
    hx = L.apply_norm(cfg, tm["ln"], x)                # (B,1,d)
    new_shift_tm = hx[:, -1]
    r, k, v, decay, g = _tm_projections(cfg, tm, ltm, hx, cache["shift_tm"][:, None])
    out, state = wkv_scan(r, k, v, decay, tm["u"], cache["s"])
    x = x + _tm_out(cfg, tm, ltm, out.to(x.dtype), g)
    hx = L.apply_norm(cfg, cm["ln"], x)
    new_shift_cm = hx[:, -1]
    x = x + _cm_apply(cfg, cm, lcm, hx, cache["shift_cm"][:, None])
    cache["shift_tm"].copy_(new_shift_tm)
    cache["shift_cm"].copy_(new_shift_cm)
    cache["s"].copy_(state)
    return x, cache


RWKV = {"init": rwkv_init, "train": rwkv_train, "prefill": rwkv_prefill,
        "decode": rwkv_decode, "init_cache": rwkv_init_cache}

# ===========================================================================
# Mamba2 (SSD) block — zamba2 backbone
# ===========================================================================

def _mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.d_state
    return d_in, nh, conv_ch


def mamba_mixer_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """The Mamba2 mixer: in/out projections in the model's type; the conv,
    decay, skip and dt-bias leaves in f32, as in the reference."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh, conv_ch = _mamba_dims(cfg)
    dt = L.torch_dtype(cfg.dtype)
    f32 = torch.float32
    return {
        "in_proj": L.dense_init(gen, d, 2 * d_in + 2 * s.d_state + nh, dt, device),
        "conv_w": L._normal(gen, (s.d_conv, conv_ch), device) / math.sqrt(s.d_conv),
        "conv_b": torch.zeros((conv_ch,), dtype=f32, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=device)),
        "d_skip": torch.ones((nh,), dtype=f32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=device),
        "norm": L.init_norm(cfg, device, d_in),
        "out_proj": L.dense_init(gen, d_in, d, dt, device),
    }


def mamba_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """The Mamba2 layer: its norm and the mixer."""
    return {"ln": L.init_norm(cfg, device), **mamba_mixer_init(gen, cfg, device)}


def _mamba_split(cfg: ModelConfig, p: dict, lora, x: Tensor):
    scale = cfg.lora.alpha / cfg.lora.rank
    s = cfg.ssm
    d_in, nh, _ = _mamba_dims(cfg)
    proj = L.lora_apply(x, p["in_proj"], (lora or {}).get("in_proj"), scale,
                        impl=cfg.lora.impl)
    return torch.split(proj, [d_in, d_in, s.d_state, s.d_state, nh], dim=-1)


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, x_hist: Optional[Tensor] = None):
    """Depthwise causal conv1d. x: (B,S,C); w: (K,C); x_hist: (B,K-1,C).

    The history (zeros in x's type, or the f32 cache) and x are joined in
    f32, as the reference's concatenation promotes them; returns (the
    output in x's type, the last K-1 inputs in f32: the next history)."""
    kk = w.shape[0]
    pad = torch.zeros_like(x[:, : kk - 1]) if x_hist is None else x_hist
    xp = torch.cat([pad.float(), x.float()], dim=1)
    out = xp[:, 0: x.shape[1]] * w[0]
    for i in range(1, kk):
        out = out + xp[:, i: i + x.shape[1]] * w[i]
    return F.silu(out + b).to(x.dtype), xp[:, -(kk - 1):]


def _softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    switch to the identity at large x (``F.softplus`` has one at 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_scan(xh: Tensor, bmat: Tensor, cmat: Tensor, dt: Tensor, a_log: Tensor,
             d_skip: Tensor, state: Tensor):
    """Mamba2 SSD recurrence, one step after the other, in f32.
    xh: (B,S,H,P); bmat/cmat: (B,S,N); dt: (B,S,H); state: (B,H,P,N).
    Returns (y (B,S,H,P) f32, final state f32)."""
    a = -torch.exp(a_log)                              # (H,)
    xh, bmat, cmat, dt = xh.float(), bmat.float(), cmat.float(), dt.float()
    s = state.float()
    ys = []
    for t in range(xh.shape[1]):
        xt, bt, ct, dtt = xh[:, t], bmat[:, t], cmat[:, t], dt[:, t]
        da = torch.exp(dtt * a)                        # (B,H)
        upd = torch.einsum("bhp,bn->bhpn", xt * dtt[..., None], bt)
        s = da[..., None, None] * s + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, ct) + d_skip[None, :, None] * xt)
    return torch.stack(ys, dim=1), s


def ssd_chunked(xh: Tensor, bmat: Tensor, cmat: Tensor, dt: Tensor, a_log: Tensor,
                d_skip: Tensor, state: Tensor, chunk: int = 16):
    """Chunk-parallel SSD in plain PyTorch: the reference's block
    1-semiseparable form (per-head log-decay differences, all <= 0)

      y_t = exp(lp_t)(S0.C_t) + sum_{j<=t} exp(lp_t-lp_j) (C_t.B_j) dt_j x_j + D x_t
      S_C = exp(lp_C) S0 + sum_j exp(lp_C-lp_j) dt_j x_j (x) B_j

    with every chunk's intra-chunk output and state contribution formed at
    once over a chunk axis, and only the (B,H,P,N) state carried from chunk
    to chunk in a loop.  S is padded to a multiple of ``chunk`` with zero
    steps (dt 0: no decay, no input).  Returns (y (B,S,H,P) f32, final
    state f32)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    a = -torch.exp(a_log)                              # (H,)
    pad = (-s) % chunk
    if pad:
        xh, bmat, cmat, dt = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                              for t in (xh, bmat, cmat, dt))
    nc = (s + pad) // chunk

    def chunks(t):   # (B,T,...) -> (B,nc,C,...)
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:])).float()

    xc, bc, cc, dtc = map(chunks, (xh, bmat, cmat, dt))
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=xh.device))
    lp = torch.cumsum(dtc * a, dim=2)                  # log decay, (B,nc,C,H)
    # A[t,j] = exp(lp_t - lp_j), j <= t: exponents <= 0, stable
    amat = torch.exp(torch.clamp_max(lp[:, :, :, None] - lp[:, :, None, :], 0.0)) \
        * tril[None, None, :, :, None]                 # (B,nc,C,C,H)
    g = torch.einsum("bctn,bcjn->bctj", cc, bc)        # (B,nc,C,C), heads shared
    y = torch.einsum("bctjh,bcjhp->bcthp", amat * g[..., None] * dtc[:, :, None], xc)
    # each chunk's own state contribution, sum_j exp(lp_C - lp_j) dt_j x_j (x) B_j
    kdec = torch.exp(lp[:, :, -1:] - lp)               # (B,nc,C,H), <= 1
    contrib = torch.einsum("bcjhp,bcjn->bchpn", (kdec * dtc)[..., None] * xc, bc)
    chunk_decay = torch.exp(lp[:, :, -1])[..., None, None]   # (B,nc,H,1,1)
    s0 = state.float()
    starts = []
    for c in range(nc):
        starts.append(s0)
        s0 = chunk_decay[:, c] * s0 + contrib[:, c]
    y_inter = torch.einsum("bchpn,bctn->bcthp", torch.stack(starts, dim=1), cc) \
        * torch.exp(lp)[..., None]
    y = y + y_inter + d_skip[None, None, None, :, None] * xc
    return y.reshape(b, s + pad, h, p)[:, :s], s0


def ssd_apply(cfg: ModelConfig, xh, bmat, cmat, dt, a_log, d_skip, state):
    """The SSD over a sequence: ``wkv_impl`` governs both recurrent
    families.  Plain PyTorch either way; the reference's SSD is plain JAX
    too (no TPU kernel).  Where any input asks for a gradient, the SSD is
    recomputed in the backward from its inputs, which are all autograd
    keeps of it (``torch.utils.checkpoint``): the per-chunk tensors of a
    layer, several GB at a server step's size, are never held across the
    step.  The recompute runs the same operations again, so outputs and
    gradients are those of the plain form, bit for bit."""
    if cfg.wkv_impl not in WKV_IMPLS:
        raise KeyError(f"unknown wkv impl {cfg.wkv_impl!r}; choose from {WKV_IMPLS}")
    fn = (functools.partial(ssd_chunked, chunk=cfg.wkv_chunk) if cfg.wkv_impl == "chunked"
          else ssd_scan)
    args = (xh, bmat, cmat, dt, a_log, d_skip, state)
    if L.needs_grad(*args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _mamba_core(cfg: ModelConfig, p: dict, lora, x: Tensor,
                conv_hist: Optional[Tensor] = None, state: Optional[Tensor] = None):
    """in_proj, the causal conv over (x, B, C), the SSD from ``state``
    (None: zeros), the gated RMSNorm (``norm``'s scale, in the model's
    type) and out_proj.  Returns (out, the conv history f32, the state).
    Records the ``mamba`` span, and inside it the ``ssd`` span (from the
    conv's output to the SSD's)."""
    s = cfg.ssm
    d_in, nh, _ = _mamba_dims(cfg)
    b, sq, _ = x.shape
    with wall.span("mamba") as sp_mixer:
        z, xc, bmat, cmat, dt_raw = _mamba_split(cfg, p, lora, sp_mixer.input(x))
        conv_in = torch.cat([xc, bmat, cmat], dim=-1)
        conv_out, new_hist = _causal_conv(conv_in, p["conv_w"], p["conv_b"], conv_hist)
        dt = _softplus(dt_raw.float() + p["dt_bias"])
        if state is None:
            state = torch.zeros((b, nh, s.head_dim, s.d_state), dtype=torch.float32,
                                device=x.device)
        with wall.span("ssd") as sp:
            xc, bmat, cmat = torch.split(sp.input(conv_out), [d_in, s.d_state, s.d_state],
                                         dim=-1)
            xh = xc.reshape(b, sq, nh, s.head_dim)
            y, state = ssd_apply(cfg, xh, bmat, cmat, dt, p["a_log"], p["d_skip"], state)
            y = sp.output(y)
        y = y.reshape(b, sq, d_in).to(x.dtype)
        y = L.rms_norm(y * F.silu(z), p["norm"]["scale"])
        scale = cfg.lora.alpha / cfg.lora.rank
        out = sp_mixer.output(L.lora_apply(y, p["out_proj"], (lora or {}).get("out_proj"),
                                           scale, impl=cfg.lora.impl))
    return out, new_hist, state


def mamba_train(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    with wall.span("norm") as sp:
        h = sp.output(L.apply_norm(cfg, p["ln"], sp.input(x)))
    out, _, _ = _mamba_core(cfg, p, lora, h)
    return x + out, torch.zeros((), dtype=torch.float32, device=x.device)


def mamba_init_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> dict:
    s = cfg.ssm
    _, nh, conv_ch = _mamba_dims(cfg)
    return {"conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=torch.float32,
                                device=device),
            "s": torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=torch.float32,
                             device=device)}


def mamba_prefill(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    h = L.apply_norm(cfg, p["ln"], x)
    out, hist, state = _mamba_core(cfg, p, lora, h)
    return (x + out, {"conv": hist, "s": state},
            torch.zeros((), dtype=torch.float32, device=x.device))


def mamba_decode(cfg: ModelConfig, p: dict, lora, x: Tensor, cache: dict,
                 pos: int, ctx: dict):
    """One step from the cached conv history and state (through
    ``ssd_apply``, as the reference's decode), both written back in place."""
    h = L.apply_norm(cfg, p["ln"], x)
    out, hist, state = _mamba_core(cfg, p, lora, h, conv_hist=cache["conv"],
                                   state=cache["s"])
    cache["conv"].copy_(hist)
    cache["s"].copy_(state)
    return x + out, cache


MAMBA = {"init": mamba_init, "train": mamba_train, "prefill": mamba_prefill,
         "decode": mamba_decode, "init_cache": mamba_init_cache}

# ===========================================================================
# the per-layer hybrid's layer (granite-4.0-h): norm -> mixer (Mamba2 or
# attention) -> residual, norm -> MLP -> residual, each branch times
# ``residual_multiplier``
# ===========================================================================


def hybrid_layer_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """What every layer has: its two norms and its MLP.  The mixers are
    stacked by kind beside the layers (``models/decoder.py``)."""
    return {"ln1": L.init_norm(cfg, device), "ln2": L.init_norm(cfg, device),
            "mlp": L.mlp_init(gen, cfg, device)}


def hybrid_layer_train(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    """One layer: ``p`` holds its norms and MLP and its mixer's weights
    under ``"mamba"`` or ``"attn"``; ``lora`` its mixer's adapters under the
    same key."""
    if "mamba" in p:
        with wall.span("norm") as sp:
            h = sp.output(L.apply_norm(cfg, p["ln1"], sp.input(x)))
        o, _, _ = _mamba_core(cfg, p["mamba"], (lora or {}).get("mamba"), h)
    else:
        o, _, _ = _attention_branch(cfg, p, lora, x, ctx)
    x = _residual(cfg, x, o)
    del o
    return (_mlp_residual(cfg, p, lora, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


HYBRID_LAYER = {"init": hybrid_layer_init, "train": hybrid_layer_train}

BLOCKS = {"dense": DENSE, "moe": MOE, "ssm": RWKV, "hybrid": MAMBA,
          "vlm": DENSE, "encoder": DENSE, "encdec": DENSE}


def get_block(cfg: ModelConfig) -> dict:
    return HYBRID_LAYER if cfg.layer_types else BLOCKS[cfg.family]
