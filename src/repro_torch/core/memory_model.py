"""Analytical memory accounting (server side, paper Table I).  Port of
``src/repro/core/memory_model.py``.

Exact parameter/adapter byte counts come from the real model definitions,
built on PyTorch's ``meta`` device (shapes and dtypes, no storage), where
the reference traces them with ``jax.eval_shape``; activation footprints
use the standard stored-tensors estimate for LoRA fine-tuning
(intermediate activations must be kept to backprop into the adapters — the
>70% of full-FT memory the paper cites [13]).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch import models  # a module: models imports core, which imports this
from repro_torch.tree import tree_leaves

PyTree = Any

# stored activations per block per token, in units of d_model elements,
# for LoRA backprop through a transformer block (inputs of the adapted
# matmuls + residuals + norms + GELU buffers; attention probs counted
# separately). 12 matches torch-style eager training (calibrated so all
# three Table I rows land within ~3% of the paper's measurements).
ACT_FACTOR_BLOCK = 12.0
OPTIMIZER_STATES = 2   # AdamW m and v


def tree_bytes(tree: PyTree) -> int:
    return sum(int(leaf.numel()) * leaf.element_size() for leaf in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class ModelBytes:
    embed: int
    per_layer: int          # one block, params only
    head: int               # untied head / classifier + final norm
    lora_per_layer: int     # adapters for one block
    lora_extra: int         # server-only adapters (shared/dec)
    n_layers: int

    def params(self, n_layers: int | None = None) -> int:
        n = self.n_layers if n_layers is None else n_layers
        return self.embed + self.layers(self.n_layers - n, self.n_layers) + self.head

    def layers(self, lo: int, hi: int) -> int:
        """The parameters of layers [lo, hi)."""
        return (hi - lo) * self.per_layer

    def lora(self, n_layers: int | None = None) -> int:
        n = self.n_layers if n_layers is None else n_layers
        return self.lora_layers(self.n_layers - n, self.n_layers) + self.lora_extra

    def lora_layers(self, lo: int, hi: int) -> int:
        """The adapters of layers [lo, hi)."""
        return (hi - lo) * self.lora_per_layer


@dataclasses.dataclass(frozen=True)
class LayeredModelBytes(ModelBytes):
    """The per-layer hybrid's bytes: its layers differ by mixer, so each
    layer's weights and adapters are counted by its own kind
    (``per_layer`` and ``lora_per_layer`` are their means, rounded down).
    A subclass, so that ``ModelBytes``'s fields stay the reference's.  The
    adapters counted are a layer's own mixer's targets; the program's
    stacks hold both mixers' on every layer (``models/decoder.py``), rows
    the model leaves out."""
    layer_bytes: Tuple[int, ...] = ()
    lora_bytes: Tuple[int, ...] = ()

    def layers(self, lo: int, hi: int) -> int:
        return sum(self.layer_bytes[lo:hi])

    def lora_layers(self, lo: int, hi: int) -> int:
        return sum(self.lora_bytes[lo:hi])


@functools.lru_cache(maxsize=32)
def model_bytes(cfg: ModelConfig) -> ModelBytes:
    """Byte counts of one model's parameters and adapters, from its init on
    the ``meta`` device: a CPU generator drives the meta draws, and no init
    code reads a value, so nothing is allocated or computed.  Cached per
    (frozen, hashable) config: the partition solver probes it once per
    candidate cut and the sl round time once per round."""
    model = models.build_model(cfg, device="meta")
    gen = torch.Generator()
    pspec = model.init_params(gen)
    lspec = model.init_lora(gen)

    stacked_keys = [k for k in ("layers", "enc_layers", "dec_layers") if k in pspec]
    layer_b = sum(tree_bytes(pspec[k]) for k in stacked_keys)
    n_total = cfg.n_layers + (cfg.n_encoder_layers if cfg.family == "encdec" else 0)
    embed_b = tree_bytes({k: v for k, v in pspec.items()
                          if k in ("embed", "pos_embed", "enc_pos", "proj")})
    head_b = tree_bytes({k: v for k, v in pspec.items()
                         if k in ("head", "cls_head", "final_norm", "enc_norm", "shared")})

    lora_stacked = [k for k in ("layers", "enc_layers") if k in lspec]
    lora_layer_b = sum(tree_bytes(lspec[k]) for k in lora_stacked)
    lora_extra_b = tree_bytes({k: v for k, v in lspec.items()
                               if k not in lora_stacked})
    n_lora_stack = cfg.n_layers if "layers" in lspec else cfg.n_encoder_layers
    if cfg.layer_types:     # each layer's norms and MLP, its mixer and its adapters by kind
        common = layer_b // cfg.n_layers
        keys = [models.decoder.MIXER_KEYS[t] for t in cfg.layer_types]
        mixer = {k: tree_bytes(pspec[k]) // keys.count(k) for k in set(keys)}
        ada = {k: tree_bytes(lspec["layers"][k]) // cfg.n_layers for k in set(keys)}
        per = tuple(common + mixer[k] for k in keys)
        per_lora = tuple(ada[k] for k in keys)
        return LayeredModelBytes(
            embed=embed_b, per_layer=sum(per) // cfg.n_layers, head=head_b,
            lora_per_layer=sum(per_lora) // cfg.n_layers, lora_extra=lora_extra_b,
            n_layers=cfg.n_layers, layer_bytes=per, lora_bytes=per_lora)
    return ModelBytes(
        embed=embed_b,
        per_layer=layer_b // max(n_total, 1),
        head=head_b,
        lora_per_layer=lora_layer_b // max(n_lora_stack, 1),
        lora_extra=lora_extra_b,
        n_layers=n_total,
    )


def activation_bytes_training(cfg: ModelConfig, n_layers: int, batch: int,
                              seq_len: int, dtype_bytes: int = 4) -> float:
    """Stored activations for LoRA backprop over n_layers blocks."""
    tok = float(batch) * seq_len
    act = n_layers * tok * cfg.d_model * ACT_FACTOR_BLOCK * dtype_bytes
    if cfg.n_heads:  # attention probabilities (B, H, S, S) per attention layer
        n_attn = n_layers
        if cfg.layer_types:     # the per-layer hybrid: its share of attention layers
            n_attn = n_layers * cfg.layer_types.count("attention") / cfg.n_layers
        act += n_attn * float(batch) * cfg.n_heads * seq_len * seq_len * dtype_bytes
    # logits + final norm buffer
    out_dim = cfg.n_classes if cfg.n_classes else cfg.vocab_size
    act += float(batch) * (seq_len if not cfg.n_classes else 1) * out_dim * dtype_bytes
    return act


def optimizer_bytes(lora_bytes: int) -> int:
    return OPTIMIZER_STATES * lora_bytes


@dataclasses.dataclass(frozen=True)
class ServerMemoryReport:
    scheme: str
    params: float
    activations: float
    adapters_and_opt: float

    @property
    def total(self) -> float:
        return self.params + self.activations + self.adapters_and_opt

    @property
    def total_mb(self) -> float:
        return self.total / (1024 ** 2)


def server_memory(cfg: ModelConfig, scheme: str, cuts: Sequence[int],
                  batch: int, seq_len: int, dtype_bytes: int = 4) -> ServerMemoryReport:
    """Server-side memory for the three §V schemes.

    ours : ONE full model resident; clients served sequentially -> one
           in-flight activation set (the deepest server stack among clients)
           + one adapter/optimizer set at a time (per-client sets are tiny
           and stored, but only one is in training state).
    sfl  : U server-side submodels resident AND training in parallel.
    sl   : one submodel at a time (largest), sequential clients.
    """
    mb = model_bytes(cfg)
    n_total = mb.n_layers
    server_layers = [n_total - c for c in cuts]
    u = len(cuts)

    lora_full = mb.lora() + mb.lora_extra

    if scheme == "ours":
        params = mb.params()                       # the single full LLM
        acts = max(activation_bytes_training(cfg, nl, batch, seq_len, dtype_bytes)
                   for nl in server_layers)
        ada = u * lora_full + optimizer_bytes(lora_full)   # U stored, 1 training
    elif scheme == "sfl":
        params = sum(mb.layers(c, n_total) + mb.head for c in cuts)
        acts = sum(activation_bytes_training(cfg, nl, batch, seq_len, dtype_bytes)
                   for nl in server_layers)
        ada = u * (lora_full + optimizer_bytes(lora_full))
    elif scheme == "sl":
        nl = max(server_layers)
        params = mb.layers(n_total - nl, n_total) + mb.head
        acts = activation_bytes_training(cfg, nl, batch, seq_len, dtype_bytes)
        ada = lora_full + optimizer_bytes(lora_full)
    else:
        raise KeyError(scheme)
    return ServerMemoryReport(scheme, float(params), float(acts), float(ada))


def client_memory(cfg: ModelConfig, cut: int, batch: int, seq_len: int,
                  dtype_bytes: int = 4, mb: ModelBytes | None = None) -> float:
    """Client-side bytes: embed + its blocks + adapters + opt + activations.

    ``mb`` takes a precomputed :func:`model_bytes` — callers that probe many
    (cut, batch) candidates (the partition solver) pass it once instead of
    rebuilding the model shapes per query."""
    if mb is None:
        mb = model_bytes(cfg)
    params = mb.embed + mb.layers(0, cut)
    lora_b = mb.lora_layers(0, cut)
    acts = activation_bytes_training(cfg, cut, batch, seq_len, dtype_bytes)
    # remove the head/logits term (client has no head)
    out_dim = cfg.n_classes if cfg.n_classes else cfg.vocab_size
    acts -= float(batch) * (seq_len if not cfg.n_classes else 1) * out_dim * dtype_bytes
    return params + lora_b + optimizer_bytes(lora_b) + acts
