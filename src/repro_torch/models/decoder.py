"""Single-stack model with the paper's split execution built in — the
encoder family (BERT), the dense decoder LMs (gemma, granite, qwen1.5),
the MoE LMs (qwen3-moe, grok-1), the VLM (internvl2: a projector from
precomputed vision embeddings into the dense LM), the RWKV6 LM, the
hybrid (zamba2: a Mamba2 stack with one shared attention block applied
after each segment of ``shared_attn_every`` layers) and the per-layer
hybrid (granite-4.0-h: each layer a Mamba2 or an attention mixer, as
``cfg.layer_types`` lists, and its own MLP).  Port of
``src/repro/models/decoder.py``; the per-layer hybrid is the port's own.

``side="full" | "client" | "server"`` with a ``cut`` selects which layers
run, by one of the reference's two paths (identical semantics, tested
against each other):

* ``path="sliced"``: a static cut and a Python loop over exactly the owned
  layers — what the federated simulator runs;
* ``path="scan"``: the masked loop — every layer of the stack runs, and
  its output is kept only where the layer is owned (``torch.where``), as
  the reference's masked ``lax.scan`` does.  The cut may be a Python int,
  a 0-d tensor, or one cut per batch row: the port's form of a vmapped
  per-lane cut (one lane's cut repeated over its rows), so that one
  batch of concatenated lanes runs each lane at its own cut.

Prefill and decode run the same loop over all layers (side "full": the
scan's prefill and decode modes with every layer owned).

The hybrid's shared block runs after layer ``s1 - 1`` of each segment
``[s0, s1)`` (:meth:`DecoderModel._segments`), on a side only where that
side owns the segment's last layer: both paths apply this one rule.

Params layout (as in the reference, layers stacked on a leading axis):
    {"embed": (V,d), ["pos_embed": (P,d)], "layers": <stacked (L,...)>,
     ["shared": <dense block>] (hybrid), ["proj": (Dv,d)] (vlm),
     "final_norm": {...}, ["head": (d,V) | "cls_head": (d,n_classes)]}
Caches stack the per-layer caches on a leading (L,) axis, as the
reference's scan does (the hybrid's: {"mamba": (L,...), "attn": (n_seg,
...)}); ``serve_step`` updates them in place.

The per-layer hybrid's two kinds of layer differ in their weights, so
its mixers are stacked by kind, beside the layers:
    "layers": {"ln1", "ln2", "mlp"} of every layer, stacked (L,...);
    "mamba":  the Mamba2 mixers, stacked (n_mamba,...) in layer order
              (``blocks.mamba_mixer_init``: in_proj, conv, a_log, d_skip,
              dt_bias, the gate's norm, out_proj);
    "attn":   the attention mixers (wq, wk, wv, wo), stacked (n_attn,...).
Layer i takes the next mixer of its kind (``self.mixers[i]``).  Its
adapters stay stacked on the layer axis, so that a cut splits them as it
splits every other family's (Eq. 9): ``lora["layers"]`` holds
{"mamba": {"in_proj", "out_proj"}, "attn": {"wq", "wk", "wv", "wo"}} for
every layer, and a layer reads those of its own mixer (the others' rows
are never read, and their gradients are zeros).  A client's truncated
``"layers"`` stack indexes the same mixers.  Prefill and decode, which
would keep a Mamba2 state and a K/V cache side by side, are not built
(ROADMAP F.5).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import stack_trees
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.obs import wall
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

FAMILIES = ("encoder", "dense", "moe", "vlm", "ssm", "hybrid")
# the per-layer hybrid's mixer stacks, by ModelConfig.layer_types entry
MIXER_KEYS = {"mamba": "mamba", "attention": "attn"}
NO_CACHE = ("the per-layer hybrid ({}) has no prefill or decode: a Mamba2 state and a K/V "
            "cache side by side are ROADMAP F.5")


def build_lora_tree(gen: torch.Generator, params_one_layer: PyTree, targets,
                    rank: int, device) -> PyTree:
    """Mirror 2-D (in,out) leaves whose key is in ``targets`` with {a,b} pairs."""
    out: dict = {}
    for key, val in params_one_layer.items():
        if isinstance(val, dict):
            child = build_lora_tree(gen, val, targets, rank, device)
            if child:
                out[key] = child
        elif key in targets and val.dim() == 2:
            out[key] = L.lora_init(gen, val.shape[0], val.shape[1], rank, device)
    return out


def _run_mask(side: str, idx: int, cut):
    """Whether layer ``idx`` runs on this side of the cut: a Python bool for
    an int cut or side "full", a bool tensor for a 0-d or per-row cut."""
    if side == "full":
        return True
    if side not in ("client", "server"):
        raise ValueError(side)
    run = idx < cut if side == "client" else idx >= cut
    return run if torch.is_tensor(run) else bool(run)


def init_stacked(init_one, n: int) -> PyTree:
    """``n`` layers' parameters, stacked on a leading (n,) axis and filled
    layer by layer from ``init_one()``: one layer's tree is alive beside the
    stack, never a list of them (the stack of a 30 B-parameter MoE would
    not fit twice on one card).  The layers draw in order, as a list of
    per-layer inits stacked afterwards would."""
    layer = init_one()
    stacked = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), layer)
    for i in range(n):
        if i:
            layer = init_one()
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, layer)
        del layer
    return stacked


def model_device(device) -> torch.device:
    """Where a model's init places its tensors: ``meta`` as asked, else the
    card or the CPU (``resolve_device``)."""
    return (torch.device("meta") if torch.device(device).type == "meta"
            else resolve_device(device))


def _where(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` over a 0-d mask or one entry per leading (row) index
    of ``a``."""
    if pred.dim() == 1:
        pred = pred.reshape(pred.shape + (1,) * (a.dim() - 1))
    return torch.where(pred, a, b)


class DecoderModel:
    """Functional model namespace; every method is a pure function of its
    arguments, except that ``serve_step`` writes into the cache it is
    given.  ``device`` is where init places the parameters: the CUDA card,
    the CPU, or ``meta`` for shapes and dtypes alone (the memory model
    counts bytes there; nothing runs on it)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family not in FAMILIES:
            raise ValueError(f"DecoderModel does not handle family {cfg.family}")
        self.cfg = cfg
        self.device = model_device(device)
        self.block = B.get_block(cfg)
        # per-layer hybrid: layer i's (mixer stack key, index in that stack)
        self.mixers = [(MIXER_KEYS[t], cfg.layer_types[:i].count(t))
                       for i, t in enumerate(cfg.layer_types)]

    # -- init ---------------------------------------------------------------
    def init_params(self, gen: torch.Generator) -> PyTree:
        cfg, dev = self.cfg, self.device
        dt = L.torch_dtype(cfg.dtype)
        p: dict = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, dev)}
        if cfg.positional == "learned":
            p["pos_embed"] = L.embed_init(gen, cfg.max_position, cfg.d_model, dt, dev)
        p["layers"] = init_stacked(lambda: self.block["init"](gen, cfg, dev), cfg.n_layers)
        if cfg.layer_types:
            p["mamba"] = init_stacked(lambda: B.mamba_mixer_init(gen, cfg, dev),
                                      cfg.layer_types.count("mamba"))
            p["attn"] = init_stacked(lambda: L.attn_init(gen, cfg, dev),
                                     cfg.layer_types.count("attention"))
        if cfg.shared_attn_every:
            p["shared"] = B.dense_init(gen, cfg, dev)
        if cfg.family == "vlm":
            p["proj"] = L.dense_init(gen, cfg.vision_embed_dim, cfg.d_model, dt, dev)
        p["final_norm"] = L.init_norm(cfg, dev)
        if cfg.n_classes:
            p["cls_head"] = L.dense_init(gen, cfg.d_model, cfg.n_classes,
                                         torch.float32, dev)
        elif not cfg.tie_embeddings:
            p["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt, dev)
        return p

    def init_lora(self, gen: torch.Generator) -> PyTree:
        cfg = self.cfg
        # a single-layer skeleton on the meta device gives the shapes; the
        # per-layer hybrid's layers carry both mixers' adapters
        one = self.block["init"](None, cfg, "meta")
        if cfg.layer_types:
            one = {"mamba": B.mamba_mixer_init(None, cfg, "meta"),
                   "attn": L.attn_init(None, cfg, "meta")}
        per_layer = [build_lora_tree(gen, one, cfg.lora.targets, cfg.lora.rank,
                                     self.device)
                     for _ in range(cfg.n_layers)]
        lora = {"layers": stack_trees(per_layer)}
        if cfg.shared_attn_every:
            lora["shared"] = build_lora_tree(gen, B.dense_init(None, cfg, "meta"),
                                             cfg.lora.targets, cfg.lora.rank, self.device)
        return lora

    def params_spec(self) -> PyTree:
        """The parameters' shapes and dtypes: a ``meta``-device tree (the
        port's stand-in for the reference's ``ShapeDtypeStruct``s)."""
        return DecoderModel(self.cfg, "meta").init_params(None)

    def lora_spec(self) -> PyTree:
        return DecoderModel(self.cfg, "meta").init_lora(None)

    # -- embedding / head -----------------------------------------------------
    def embed(self, params: PyTree, batch: dict) -> torch.Tensor:
        """Token embeddings (a gather, or with ``embed_impl="onehot"`` the
        one-hot product of the reference), preceded for the VLM by the
        projected ``vision_embeds`` (B, Nv, Dv) when the batch has them;
        learned positions over the whole sequence."""
        cfg = self.cfg
        tokens = batch["tokens"].long()
        if cfg.embed_impl == "onehot":
            oh = torch.nn.functional.one_hot(tokens, cfg.vocab_size).to(params["embed"].dtype)
            x = oh @ params["embed"]
        else:
            x = params["embed"][tokens]
        if cfg.embedding_multiplier != 1.0:
            x = x * cfg.embedding_multiplier
        if cfg.family == "vlm" and "vision_embeds" in batch:
            vis = batch["vision_embeds"].to(x.dtype) @ params["proj"].to(x.dtype)
            x = torch.cat([vis, x], dim=1)
        if cfg.positional == "learned":
            x = x + params["pos_embed"][torch.arange(x.shape[1], device=x.device)]
        return x

    def unembed(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = L.apply_norm(cfg, params["final_norm"], x)
        if cfg.n_classes:
            return x[:, 0, :].float() @ params["cls_head"]   # CLS pool
        w = params["embed"].t() if cfg.tie_embeddings else params["head"]
        logits = x @ w.to(x.dtype)
        return logits if cfg.logits_scaling == 1.0 else logits / cfg.logits_scaling

    def make_ctx(self, seq_len: int, device, *, window: Optional[int] = None,
                 positions: Optional[torch.Tensor] = None, moe_groups: int = 1,
                 moe_mesh=None) -> dict:
        """The blocks' context (``blocks`` module docstring); ``moe_groups``
        splits the MoE dispatch into that many equal groups of tokens;
        ``moe_mesh`` (a one-card ``launch.mesh.Mesh``) routes the MoE block
        to ``blocks.moe_mlp_sharded``."""
        cfg = self.cfg
        arange = positions is None
        if arange:
            positions = torch.arange(seq_len, dtype=torch.int32, device=device)
        return {"positions": positions, "causal": cfg.causal,
                "window": window if window is not None else cfg.sliding_window,
                "arange": arange, "moe_groups": moe_groups or 1,
                "moe_dense_fallback": False, "moe_mesh": moe_mesh}

    # -- the hybrid's segments ----------------------------------------------------
    def _segments(self) -> list:
        """[(s0, s1)]: consecutive runs of ``shared_attn_every`` layers (the
        last may be shorter); the shared block runs after each."""
        cfg = self.cfg
        every = cfg.shared_attn_every
        segs, start = [], 0
        while start < cfg.n_layers:
            end = min(start + every, cfg.n_layers)
            segs.append((start, end))
            start = end
        return segs

    def _segment_ends(self) -> dict:
        """{last layer of a segment: segment index}; empty without a shared
        block."""
        if not self.cfg.shared_attn_every:
            return {}
        return {s1 - 1: si for si, (_, s1) in enumerate(self._segments())}

    def _layer(self, params, lora_layers, i: int):
        """Layer i's weights and adapters: slices of the stacks; in the
        per-layer hybrid its norms and MLP with its mixer from the stack of
        its kind, and that mixer's adapters."""
        p_l = tree_map(lambda a: a[i], params["layers"])
        if not self.mixers:
            return p_l, tree_map(lambda a: a[i], lora_layers)
        key, j = self.mixers[i]
        p_l[key] = tree_map(lambda a: a[j], params[key])
        lo = lora_layers.get(key)
        return p_l, ({key: tree_map(lambda a: a[i], lo)} if lo else {})

    # -- backbone: sliced (static-cut) path -------------------------------------
    def sliced_forward(self, params, lora, x, ctx, layer_range) -> torch.Tensor:
        """Python loop over exactly layers [lo, hi), each segment's last
        layer followed by the shared block (hybrid).  ``params['layers']``
        may hold the full stack or a client's truncated stack; indices are
        relative to the stored stack."""
        lora_layers = (lora or {}).get("layers", {})
        ends = self._segment_ends()
        lo, hi = layer_range
        for i in range(lo, hi):
            p_l, lo_l = self._layer(params, lora_layers, i)
            x, _ = self.block["train"](self.cfg, p_l, lo_l, x, ctx)
            if i in ends:   # segment boundary -> shared attention
                x, _ = B.dense_train(self.cfg, params["shared"],
                                     (lora or {}).get("shared"), x, ctx)
        return x

    # -- backbone: masked (scan) path --------------------------------------------
    def _masked_layer(self, p_l, lo_l, h, aux, ctx, run):
        y, a = self.block["train"](self.cfg, p_l, lo_l, h, ctx)
        if run is True:
            return y, aux + a
        return _where(run, y, h), aux + _where(run, a, torch.zeros_like(a))

    def _masked_shared(self, p_sh, lo_sh, h, ctx, run):
        """The hybrid's shared block, kept where ``run`` (its aux, zero, is
        not added: the reference drops it)."""
        y, _ = B.dense_train(self.cfg, p_sh, lo_sh, h, ctx)
        return y if run is True else _where(run, y, h)

    def scan_forward(self, params, lora, x, ctx, cut, side, *, remat=False):
        """Every layer of the stack runs; layer i's output is kept where it
        is owned on ``side`` of ``cut`` and its aux loss added there (the
        reference's masked scan in train mode).  A per-row ``cut`` masks
        each row at its own cut, so the aux loss comes back per row, and
        the blocks are asked for theirs per row (``moe_aux_rows``): the MoE
        block's router loss is one per dispatch group, so a caller that
        concatenates lanes (the vmap cohort step) also sets ``moe_groups``
        to the number of lanes, and each lane gets its own capacity, drops
        and aux, masked by its own cut, as under the reference's
        ``jax.vmap``.  With a Python int cut the mask of each
        layer is known here: an owned layer runs as on the sliced path,
        with no ``torch.where``, and a layer that is not owned is skipped
        (its output would be dropped, its gradients are zeros), so the
        outputs equal the sliced path's bit for bit (only this path also
        returns the owned layers' aux loss).  ``remat`` recomputes each layer
        in the backward instead of keeping its activations
        (``jax.checkpoint`` of the scan body).  The hybrid's shared block
        runs after each segment's last layer, kept where the side owns that
        layer, and under ``remat`` is recomputed on its own, as the
        reference checkpoints it."""
        lora_layers = (lora or {}).get("layers", {})
        ends = self._segment_ends()
        if torch.is_tensor(cut) and cut.dim() == 1:
            ctx = dict(ctx, moe_aux_rows=True)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(tree_leaves(params["layers"])[0].shape[0]):
            run = _run_mask(side, i, cut)
            if run is False:
                continue
            p_l, lo_l = self._layer(params, lora_layers, i)
            if remat:
                x, aux = checkpoint(self._masked_layer, p_l, lo_l, x, aux, ctx, run,
                                    use_reentrant=False)
            else:
                x, aux = self._masked_layer(p_l, lo_l, x, aux, ctx, run)
            if i in ends:
                args = (params["shared"], (lora or {}).get("shared"), x, ctx, run)
                x = (checkpoint(self._masked_shared, *args, use_reentrant=False)
                     if remat else self._masked_shared(*args))
        return x, aux

    # -- public API ----------------------------------------------------------
    def forward_hidden(self, params, lora, batch, *, cut=0, side: str = "full",
                       remat: bool = False, path: str = "sliced", x0=None,
                       ctx: Optional[dict] = None):
        """Embedding (client/full only) + the owned layers; returns (h, aux).
        ``path="sliced"`` (the default here, and what the simulator and the
        split steps run) loops over exactly the owned layers at an int cut
        and reports no aux loss, as the reference's sliced path does;
        ``path="scan"`` is the masked loop of :meth:`scan_forward`.
        ``ctx`` defaults to :meth:`make_ctx` over the sequence."""
        x = self.embed(params, batch) if x0 is None else x0
        if ctx is None:
            ctx = self.make_ctx(x.shape[1], x.device)
        if path == "scan":
            return self.scan_forward(params, lora, x, ctx, cut, side, remat=remat)
        if path != "sliced":
            raise KeyError(f"unknown path {path!r}; choose 'sliced' or 'scan'")
        nl = tree_leaves(params["layers"])[0].shape[0]
        rng = {"full": (0, nl), "client": (0, int(cut)),
               "server": (int(cut), nl)}[side]
        h = self.sliced_forward(params, lora, x, ctx, rng)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    def lm_logits(self, params, h: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """The LM head's logits over the positions that have targets: all of
        them, or for the VLM the text tokens after the vision prefix."""
        logits = self.unembed(params, h)
        if self.cfg.family == "vlm":
            logits = logits[:, -targets.shape[1]:, :]
        return logits

    def loss(self, params, lora, batch, *, cut=0, side: str = "full",
             remat: bool = False, path: str = "sliced", x0=None,
             ctx: Optional[dict] = None):
        """Full loss (side='full') or server-side loss from activations x0:
        the CLS head's cross-entropy, or the LM's teacher-forced one
        against ``batch['targets']``, plus the aux loss (its mean over the
        rows where the cut is per row)."""
        h, aux = self.forward_hidden(params, lora, batch, cut=cut, side=side,
                                     remat=remat, path=path, x0=x0, ctx=ctx)
        with wall.span("cls_head" if self.cfg.n_classes else "lm_head") as sp:
            h = sp.input(h)
            if self.cfg.n_classes:
                logits = self.unembed(params, h)
                loss = L.softmax_xent(logits[:, None, :], batch["label"][:, None])
            else:
                logits = self.lm_logits(params, h, batch["targets"])
                loss = L.softmax_xent(logits, batch["targets"])
            loss = sp.output(loss)
        return loss + (aux if aux.dim() == 0 else aux.mean()), logits

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch_size: int, cache_len: int) -> PyTree:
        """Zero caches of every layer, stacked on a leading (L,) axis; the
        hybrid's are {"mamba": (L,...), "attn": the shared block's, one a
        segment (n_seg,...)}."""
        def stacked(one, n):
            return tree_map(lambda a: a[None].repeat(n, *([1] * a.dim())), one)

        cfg = self.cfg
        if cfg.layer_types:
            raise NotImplementedError(NO_CACHE.format(cfg.name))
        layers = stacked(self.block["init_cache"](cfg, batch_size, cache_len, self.device),
                         cfg.n_layers)
        if not cfg.shared_attn_every:
            return layers
        attn = B.dense_init_cache(cfg, batch_size, cache_len, self.device)
        return {"mamba": layers, "attn": stacked(attn, len(self._segments()))}

    def cache_spec(self, batch_size: int, cache_len: int) -> PyTree:
        """The cache's shapes and dtypes as a ``meta``-device tree."""
        return DecoderModel(self.cfg, "meta").init_cache(batch_size, cache_len)

    def prefill(self, params, lora, batch, *, ctx=None):
        """Run the prompt through every layer; returns (logits of the last
        position (B,1,V), the stacked caches)."""
        if self.cfg.layer_types:
            raise NotImplementedError(NO_CACHE.format(self.cfg.name))
        x = self.embed(params, batch)
        if ctx is None:
            ctx = self.make_ctx(x.shape[1], x.device)
        lora_layers = (lora or {}).get("layers", {})
        ends = self._segment_ends()
        caches, attn = [], []
        for i in range(self.cfg.n_layers):
            p_l = tree_map(lambda a: a[i], params["layers"])
            lo_l = tree_map(lambda a: a[i], lora_layers)
            x, c_l, _ = self.block["prefill"](self.cfg, p_l, lo_l, x, ctx)
            caches.append(c_l)
            if i in ends:
                x, c_a, _ = B.dense_prefill(self.cfg, params["shared"],
                                            (lora or {}).get("shared"), x, ctx)
                attn.append(c_a)
        logits = self.unembed(params, x[:, -1:, :])
        if ends:
            return logits, {"mamba": stack_trees(caches), "attn": stack_trees(attn)}
        return logits, stack_trees(caches)

    def serve_step(self, params, lora, cache, token, pos, *, ctx=None,
                   window: Optional[int] = None):
        """One decode step: token (B,1) int, pos an int (or a 0-d tensor,
        read on the host) shared by the batch.  Writes the step into
        ``cache`` and returns (logits (B,1,V), cache)."""
        if self.cfg.layer_types:
            raise NotImplementedError(NO_CACHE.format(self.cfg.name))
        pos = int(pos)
        x = params["embed"][token.long()]
        if self.cfg.positional == "learned":
            x = x + params["pos_embed"][pos][None, None, :]
        if ctx is None:
            positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
            ctx = self.make_ctx(1, x.device, window=window, positions=positions)
        lora_layers = (lora or {}).get("layers", {})
        ends = self._segment_ends()
        layer_cache = cache["mamba"] if ends else cache
        for i in range(self.cfg.n_layers):
            p_l = tree_map(lambda a: a[i], params["layers"])
            lo_l = tree_map(lambda a: a[i], lora_layers)
            c_l = tree_map(lambda a: a[i], layer_cache)
            x, _ = self.block["decode"](self.cfg, p_l, lo_l, x, c_l, pos, ctx)
            if i in ends:
                c_a = tree_map(lambda a: a[ends[i]], cache["attn"])
                x, _ = B.dense_decode(self.cfg, params["shared"],
                                      (lora or {}).get("shared"), x, c_a, pos, ctx)
        return self.unembed(params, x), cache
