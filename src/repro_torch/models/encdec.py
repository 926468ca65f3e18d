"""Whisper-style encoder-decoder backbone.  Port of
``src/repro/models/encdec.py``.

The mel-spectrogram and conv frontend is the reference's stub: batches
carry precomputed frame embeddings ``frames: (B, encoder_seq, d_model)``.
The transformer encoder (non-causal dense blocks over learned positions),
the causal decoder with cross-attention, LoRA everywhere, the split
execution (cut = encoder layers held by the client) and KV-cache serving.

The encoder runs each layer of its stored stack masked at the cut, as the
reference's masked scan does: at a Python int cut an owned layer runs and
a layer that is not owned is skipped, at a tensor cut its output is kept
where owned (``torch.where``).  The decoder's self- and cross-attention
are plain (``attention_full`` without ``impl``), as in the reference; the
encoder's attention follows ``attn_impl`` (the flash kernel under
"chunked").  ``serve_step`` writes the step's self-attention K/V into the
cache it is given.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import stack_trees
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.decoder import (_run_mask, _where, build_lora_tree,
                                        init_stacked, model_device)
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def dec_block_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    return {
        "ln1": L.init_norm(cfg, device),
        "attn": L.attn_init(gen, cfg, device),     # causal self-attention
        "lnx": L.init_norm(cfg, device),
        "xattn": L.attn_init(gen, cfg, device),    # cross-attention
        "ln2": L.init_norm(cfg, device),
        "mlp": L.mlp_init(gen, cfg, device),
    }


def _cross_attend(cfg: ModelConfig, p: dict, lora, x: torch.Tensor,
                  xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """x: (B,S,d); xk/xv: (B,T,K,Dh) precomputed from the encoder output."""
    scale = cfg.lora.alpha / cfg.lora.rank
    lget = (lora or {}).get
    b, s, _ = x.shape
    q = L.lora_apply(x, p["wq"], lget("wq"), scale, p.get("bq"), impl=cfg.lora.impl)
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    t = xk.shape[1]
    out = L.attention_full(q, xk, xv, causal=False, window=None,
                           q_pos=torch.arange(s, device=x.device),
                           k_pos=torch.arange(t, device=x.device))
    return L.lora_apply(out, p["wo"], lget("wo"), scale, impl=cfg.lora.impl)


def _cross_kv(cfg: ModelConfig, p: dict, lora, enc: torch.Tensor):
    scale = cfg.lora.alpha / cfg.lora.rank
    lget = (lora or {}).get
    b, t, _ = enc.shape
    k = L.lora_apply(enc, p["wk"], lget("wk"), scale, p.get("bk"), impl=cfg.lora.impl)
    v = L.lora_apply(enc, p["wv"], lget("wv"), scale, p.get("bv"), impl=cfg.lora.impl)
    return (k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim))


class EncDecModel:
    """Functional model namespace, as :class:`DecoderModel`: pure methods
    except ``serve_step``, which writes into the cache it is given;
    ``device`` is where init places the parameters (the card, the CPU, or
    ``meta`` for shapes and dtypes alone)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family != "encdec":
            raise ValueError(f"EncDecModel does not handle family {cfg.family}")
        self.cfg = cfg
        self.device = model_device(device)

    # -- init -----------------------------------------------------------------
    def init_params(self, gen: torch.Generator) -> PyTree:
        cfg, dev = self.cfg, self.device
        dt = L.torch_dtype(cfg.dtype)
        enc_cfg = cfg.with_(causal=False)
        return {
            "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, dev),
            "pos_embed": L.embed_init(gen, cfg.max_position, cfg.d_model, dt, dev),
            "enc_pos": L.embed_init(gen, cfg.encoder_seq, cfg.d_model, dt, dev),
            "enc_layers": init_stacked(lambda: B.dense_init(gen, enc_cfg, dev),
                                       cfg.n_encoder_layers),
            "enc_norm": L.init_norm(cfg, dev),
            "dec_layers": init_stacked(lambda: dec_block_init(gen, cfg, dev), cfg.n_layers),
            "final_norm": L.init_norm(cfg, dev),
        }

    def init_lora(self, gen: torch.Generator) -> PyTree:
        cfg = self.cfg
        targets, rank = cfg.lora.targets, cfg.lora.rank
        enc_one = B.dense_init(None, cfg, "meta")
        dec_one = dec_block_init(None, cfg, "meta")
        enc = [build_lora_tree(gen, enc_one, targets, rank, self.device)
               for _ in range(cfg.n_encoder_layers)]
        dec = [build_lora_tree(gen, dec_one, targets, rank, self.device)
               for _ in range(cfg.n_layers)]
        return {"enc_layers": stack_trees(enc), "dec_layers": stack_trees(dec)}

    def params_spec(self) -> PyTree:
        """Shapes and dtypes as a ``meta``-device tree (the port's stand-in
        for the reference's ``ShapeDtypeStruct``s)."""
        return EncDecModel(self.cfg, "meta").init_params(None)

    def lora_spec(self) -> PyTree:
        return EncDecModel(self.cfg, "meta").init_lora(None)

    # -- encoder ----------------------------------------------------------------
    def _enc_layer(self, p_l, lo_l, h, ctx, run):
        y, _ = B.dense_train(self.cfg.with_(causal=False), p_l, lo_l, h, ctx)
        return y if run is True else _where(run, y, h)

    def encode(self, params, lora, frames: Optional[torch.Tensor] = None, *, cut=0,
               side: str = "full", remat: bool = False,
               x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The encoder over ``frames`` plus learned positions, or from the
        cut activations ``x0``.  Side "client" returns the activations
        before ``enc_norm`` (the server applies it); the other sides return
        them normed.  ``params['enc_layers']`` may hold a client's
        truncated stack."""
        cfg = self.cfg
        if x0 is not None:       # resume from cut activations (no re-embedding)
            x = x0
        else:
            t = frames.shape[1]
            x = frames.to(L.torch_dtype(cfg.dtype)) + params["enc_pos"][:t][None]
        t = x.shape[1]
        ctx = {"positions": torch.arange(t, dtype=torch.int32, device=x.device),
               "causal": False, "window": None, "arange": True, "moe_groups": 1,
               "moe_dense_fallback": False}
        lora_enc = (lora or {}).get("enc_layers", {})
        for i in range(tree_leaves(params["enc_layers"])[0].shape[0]):
            run = _run_mask(side, i, cut)
            if run is False:
                continue
            p_l = tree_map(lambda a: a[i], params["enc_layers"])
            lo_l = tree_map(lambda a: a[i], lora_enc)
            x = (checkpoint(self._enc_layer, p_l, lo_l, x, ctx, run, use_reentrant=False)
                 if remat else self._enc_layer(p_l, lo_l, x, ctx, run))
        if side == "client":
            return x
        return L.apply_norm(cfg, params["enc_norm"], x)

    # -- decoder ----------------------------------------------------------------
    def _dec_ctx(self, s: int, device, positions: Optional[torch.Tensor] = None) -> dict:
        arange = positions is None
        if arange:
            positions = torch.arange(s, dtype=torch.int32, device=device)
        return {"positions": positions, "causal": True, "window": None, "arange": arange,
                "moe_groups": 1, "moe_dense_fallback": False}

    def _dec_layer(self, p_l, lo_l, h, enc, ctx):
        """One decoder layer over the whole sequence: (h, its self- and
        cross-attention K/V, the cache contents)."""
        cfg = self.cfg
        lo_l = lo_l or {}
        pos = ctx["positions"]
        hh = L.apply_norm(cfg, p_l["ln1"], h)
        q, k, v = L.qkv_project(cfg, p_l["attn"], lo_l.get("attn"), hh, pos)
        a = L.attention_full(q, k, v, causal=True, window=None, q_pos=pos, k_pos=pos)
        h = h + L.attn_out(cfg, p_l["attn"], lo_l.get("attn"), a)
        hh = L.apply_norm(cfg, p_l["lnx"], h)
        xk, xv = _cross_kv(cfg, p_l["xattn"], lo_l.get("xattn"), enc)
        h = h + _cross_attend(cfg, p_l["xattn"], lo_l.get("xattn"), hh, xk, xv)
        hh = L.apply_norm(cfg, p_l["ln2"], h)
        h = h + L.mlp_apply(cfg, p_l["mlp"], lo_l.get("mlp"), hh)
        return h, {"k": k, "v": v, "xk": xk, "xv": xv}

    def _dec_embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        s = tokens.shape[1]
        return params["embed"][tokens.long()] + params["pos_embed"][:s][None]

    def _unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        x = L.apply_norm(self.cfg, params["final_norm"], x)
        return x @ params["embed"].t().to(x.dtype)

    def decode_train(self, params, lora, tokens: torch.Tensor, enc: torch.Tensor, *,
                     remat: bool = False) -> torch.Tensor:
        """The teacher-forced decoder over ``tokens`` against the encoder
        output ``enc``: logits (B, S, V).  ``remat`` recomputes each layer
        in the backward."""
        x = self._dec_embed(params, tokens)
        ctx = self._dec_ctx(tokens.shape[1], x.device)
        lora_dec = (lora or {}).get("dec_layers", {})

        def layer(p_l, lo_l, h):
            return self._dec_layer(p_l, lo_l, h, enc, ctx)[0]

        for i in range(self.cfg.n_layers):
            p_l = tree_map(lambda a: a[i], params["dec_layers"])
            lo_l = tree_map(lambda a: a[i], lora_dec)
            x = (checkpoint(layer, p_l, lo_l, x, use_reentrant=False) if remat
                 else layer(p_l, lo_l, x))
        return self._unembed(params, x)

    # -- public API mirroring DecoderModel ---------------------------------------
    def loss(self, params, lora, batch, *, cut=0, side: str = "full", ctx=None,
             remat: bool = False, path: str = "sliced", x0=None):
        """The decoder's cross-entropy against ``batch['targets']``, from the
        frames (side "full", or "server" re-running the encoder's server
        layers) or from the cut activations ``x0``.  ``ctx`` and ``path``
        are taken for the decoder models' signature and not read."""
        if side == "client":
            raise ValueError("use forward_hidden for the client side")
        if x0 is None:
            enc = self.encode(params, lora, batch["frames"], cut=cut, side=side, remat=remat)
        else:
            enc = self.encode(params, lora, cut=cut, side="server", remat=remat, x0=x0)
        logits = self.decode_train(params, lora, batch["tokens"], enc, remat=remat)
        return L.softmax_xent(logits, batch["targets"]), logits

    def forward_hidden(self, params, lora, batch, *, cut=0, side: str = "client",
                       ctx=None, remat: bool = False, path: str = "sliced", x0=None):
        """The encoder's activations at the cut (side "client") or normed;
        returns (h, aux 0)."""
        h = self.encode(params, lora, batch["frames"], cut=cut, side=side, remat=remat)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    # -- serving ------------------------------------------------------------------
    def init_cache(self, batch_size: int, cache_len: int) -> PyTree:
        """Zero self-attention K/V of ``cache_len`` slots and cross-attention
        K/V of ``encoder_seq`` frames, every decoder layer stacked on a
        leading (L,) axis, in the model's type."""
        cfg = self.cfg
        shp = (cfg.n_layers, batch_size, cache_len, cfg.n_kv_heads, cfg.head_dim)
        xshp = (cfg.n_layers, batch_size, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        dt = L.torch_dtype(cfg.dtype)
        return {key: torch.zeros(shape, dtype=dt, device=self.device)
                for key, shape in (("k", shp), ("v", shp), ("xk", xshp), ("xv", xshp))}

    def cache_spec(self, batch_size: int, cache_len: int) -> PyTree:
        return EncDecModel(self.cfg, "meta").init_cache(batch_size, cache_len)

    def prefill(self, params, lora, batch, *, ctx=None):
        """Encode the frames and consume the prompt tokens: (logits of the
        last position (B,1,V), the stacked self- and cross-attention
        caches, of the prompt's length)."""
        enc = self.encode(params, lora, batch["frames"])
        tokens = batch["tokens"]
        x = self._dec_embed(params, tokens)
        ctxd = self._dec_ctx(tokens.shape[1], x.device)
        lora_dec = (lora or {}).get("dec_layers", {})
        caches = []
        for i in range(self.cfg.n_layers):
            p_l = tree_map(lambda a: a[i], params["dec_layers"])
            lo_l = tree_map(lambda a: a[i], lora_dec)
            x, c_l = self._dec_layer(p_l, lo_l, x, enc, ctxd)
            caches.append(c_l)
        return self._unembed(params, x[:, -1:, :]), stack_trees(caches)

    def serve_step(self, params, lora, cache, token, pos, *, ctx=None,
                   window: Optional[int] = None):
        """One decode step: token (B,1), pos an int (or a 0-d tensor, read
        on the host); the cross-attention reads the cache's ``xk``/``xv``.
        Writes the step's K/V into ``cache``; returns (logits (B,1,V),
        cache)."""
        cfg = self.cfg
        pos = int(pos)
        x = params["embed"][token.long()] + params["pos_embed"][pos][None, None, :]
        ctxd = self._dec_ctx(1, x.device, positions=torch.full(
            (1,), pos, dtype=torch.int32, device=x.device))
        ctxd["window"] = window
        lora_dec = (lora or {}).get("dec_layers", {})
        for i in range(cfg.n_layers):
            p_l = tree_map(lambda a: a[i], params["dec_layers"])
            lo_l = tree_map(lambda a: a[i], lora_dec)
            x = self._dec_step(p_l, lo_l, x, tree_map(lambda a: a[i], cache), pos, ctxd)
        return self._unembed(params, x), cache

    def _dec_step(self, p_l, lo_l, h, c_l, pos: int, ctx: dict) -> torch.Tensor:
        """One decoder layer on one token: the self-attention K/V written
        into the layer's cache ``c_l`` at ``pos``, the cross-attention over
        its ``xk``/``xv``."""
        cfg = self.cfg
        lo_l = lo_l or {}
        hh = L.apply_norm(cfg, p_l["ln1"], h)
        a, _ = B._decode_attn(cfg, p_l["attn"], lo_l.get("attn"), hh, c_l, pos, ctx)
        h = h + L.attn_out(cfg, p_l["attn"], lo_l.get("attn"), a)
        hh = L.apply_norm(cfg, p_l["lnx"], h)
        h = h + _cross_attend(cfg, p_l["xattn"], lo_l.get("xattn"), hh, c_l["xk"], c_l["xv"])
        hh = L.apply_norm(cfg, p_l["ln2"], h)
        return h + L.mlp_apply(cfg, p_l["mlp"], lo_l.get("mlp"), hh)
