"""Per-family residual blocks: the dense attention block (encoder and
decoder LM) and the RWKV6 "Finch" block.  Port of
``src/repro/models/blocks.py``; the MoE and Mamba2 blocks come with their
slices (ROADMAP Queue A, item 10).

    init(gen, cfg, device)                   -> params for ONE layer (unstacked)
    train(cfg, p, lora, x, ctx)              -> (x, aux_loss)
    prefill(cfg, p, lora, x, ctx)            -> (x, cache, aux_loss)
    init_cache(cfg, batch, cache_len, device) -> cache for one layer
    decode(cfg, p, lora, x, cache, pos, ctx) -> (x, cache)

``ctx`` is a plain dict: positions, causal, window, and ``arange`` (the
positions are 0..S-1, built so by the model).  ``decode`` writes the
new token's state into ``cache`` in place (a per-layer view of the
model's stacked cache) and returns it: the reference returns an updated
copy, which the caller then uses in place of the old one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.models import layers as L

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


def dense_prefill(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    """The training forward; also returns the roped K/V as the cache contents."""
    pos = ctx["positions"]
    h = L.apply_norm(cfg, p["ln1"], x)
    q, k, v = L.qkv_project(cfg, p["attn"], _attn_lora(lora), h, pos)
    a = L.attention_full(q, k, v, causal=ctx["causal"], window=ctx.get("window"),
                         q_pos=pos, k_pos=pos, impl=cfg.attn_impl,
                         arange=ctx.get("arange", False), chunk=cfg.attn_chunk)
    x = x + L.attn_out(cfg, p["attn"], _attn_lora(lora), a)
    h = L.apply_norm(cfg, p["ln2"], x)
    x = x + L.mlp_apply(cfg, p["mlp"], (lora or {}).get("mlp"), h)
    return x, {"k": k, "v": v}, torch.zeros((), dtype=torch.float32, device=x.device)


def dense_train(cfg: ModelConfig, p: dict, lora, x: Tensor, ctx: dict):
    x, _, aux = dense_prefill(cfg, p, lora, x, ctx)
    return x, aux


def dense_init_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> dict:
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("the int8 KV cache comes with a later slice "
                                  "of the port (ROADMAP Queue A, item 10)")
    shp = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    dt = L.torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shp, dtype=dt, device=device),
            "v": torch.zeros(shp, dtype=dt, device=device)}


def _decode_attn(cfg: ModelConfig, p: dict, lora, h: Tensor, cache: dict,
                 pos: int, ctx: dict):
    """Write this token's K/V into the cache, attend, return the context.

    Under a window the slot is ``pos % cache_len``; without one it is
    ``pos``, clamped to the last slot as ``jax.lax.dynamic_update_slice``
    clamps an out-of-range start (there every slot is then valid)."""
    window = ctx.get("window")
    cache_len = cache["k"].shape[1]
    q, k, v = L.qkv_project(cfg, p, lora, h, ctx["positions"])
    slot = pos % cache_len if window is not None else min(pos, cache_len - 1)
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    idx = torch.arange(cache_len, device=h.device)
    valid = idx < min(pos + 1, cache_len) if window is not None else idx <= pos
    return L.attention_decode(q, cache["k"], cache["v"], valid), cache


def dense_decode(cfg: ModelConfig, p: dict, lora, x: Tensor, cache: dict,
                 pos: int, ctx: dict):
    h = L.apply_norm(cfg, p["ln1"], x)
    a, cache = _decode_attn(cfg, p["attn"], _attn_lora(lora), h, cache, pos, ctx)
    x = x + L.attn_out(cfg, p["attn"], _attn_lora(lora), a)
    h = L.apply_norm(cfg, p["ln2"], x)
    x = x + L.mlp_apply(cfg, p["mlp"], (lora or {}).get("mlp"), h)
    return x, cache


DENSE = {"init": dense_init, "train": dense_train, "prefill": dense_prefill,
         "decode": dense_decode, "init_cache": dense_init_cache}


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

BLOCKS = {"encoder": DENSE, "dense": DENSE, "ssm": RWKV}


def get_block(cfg: ModelConfig) -> dict:
    if cfg.family not in BLOCKS:
        raise NotImplementedError(
            f"family {cfg.family!r} comes with a later slice of the port "
            "(ROADMAP Queue A, item 10)")
    return BLOCKS[cfg.family]
