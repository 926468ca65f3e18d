"""Model configuration dataclasses shared by every architecture family."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # number of shared (always-on) experts, qwen-style; 0 for grok
    num_shared_experts: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD block parameters."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    # rwkv uses d_model//head_dim heads with (head_dim x head_dim) wkv state
    ddlerp_rank: int = 32   # rwkv6 data-dependent lerp low-rank
    decay_rank: int = 64    # rwkv6 decay low-rank


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    # which projections carry adapters; names are matched against param paths
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")
    dropout: float = 0.0
    # how adapted projections execute: "einsum" (pure-jnp oracle) or
    # "fused" (Pallas kernels — fused per-client, grouped for ragged
    # cohorts; see models/layers.lora_apply)
    impl: str = "einsum"


# the mixers of the per-layer hybrid (ModelConfig.layer_types)
LAYER_TYPES = ("mamba", "attention")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm | encoder
    n_layers: int
    d_model: int
    n_heads: int             # 0 for attention-free families
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0        # 0 -> d_model // n_heads
    activation: str = "silu"     # silu | geglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    positional: str = "rope"     # rope | learned | none
    max_position: int = 1 << 20  # learned-position table size cap
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a single shared attention+MLP block applied every k blocks
    shared_attn_every: int = 0
    # encoder-decoder (whisper): encoder depth + fixed frame count
    n_encoder_layers: int = 0
    encoder_seq: int = 0
    # vlm (internvl): vision token prefix produced by a stubbed ViT
    n_vision_tokens: int = 0
    vision_embed_dim: int = 0
    # long-context variant: sliding-window attention (None = full attention)
    sliding_window: Optional[int] = None
    # classification head (bert / the paper's CARER task); 0 = LM head
    n_classes: int = 0
    causal: bool = True
    lora: LoRAConfig = dataclasses.field(default_factory=LoRAConfig)
    dtype: str = "bfloat16"
    # execution variants (§Perf knobs; defaults = paper-faithful baseline)
    attn_impl: str = "naive"     # naive (materialized probs) | chunked (online softmax)
    attn_chunk: int = 1024
    wkv_impl: str = "scan"       # scan (per-step state IO) | chunked (per-chunk)
    wkv_chunk: int = 16
    moe_token_chunks: int = 1    # >1: scan expert dispatch over token blocks
                                 # (smaller live capacity buffers; §Perf)
    embed_impl: str = "gather"   # gather | onehot (sharding-friendly matmul)
    kv_cache_dtype: str = "model"  # model | int8 (quantized decode cache)
    # MoE dispatch groups (0 -> one group per data shard, set at lowering time)
    moe_groups: int = 0
    source: str = ""         # citation for the assigned config
    # the per-layer hybrid (granite-4.0-h): each layer's mixer, one of
    # LAYER_TYPES, in order; () for every other config (one block kind)
    layer_types: Tuple[str, ...] = ()
    # Granite's multipliers: the token embeddings times
    # ``embedding_multiplier``, each residual branch times
    # ``residual_multiplier``, the LM head's logits over ``logits_scaling``,
    # and ``attention_multiplier`` as the softmax scale (None: 1/sqrt(head_dim)).
    # At these defaults nothing is multiplied.
    embedding_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    def __post_init__(self):
        if self.n_heads:
            hd = self.head_dim or self.d_model // self.n_heads
            object.__setattr__(self, "head_dim", hd)
            if self.n_heads % max(self.n_kv_heads, 1):
                raise ValueError(f"{self.name}: n_heads={self.n_heads} not divisible by n_kv_heads={self.n_kv_heads}")
        if self.layer_types:
            object.__setattr__(self, "layer_types", tuple(self.layer_types))
            bad = set(self.layer_types) - set(LAYER_TYPES)
            if self.family != "hybrid" or len(self.layer_types) != self.n_layers or bad:
                raise ValueError(
                    f"{self.name}: layer_types needs the hybrid family and one entry of "
                    f"{LAYER_TYPES} a layer ({self.n_layers}), got {len(self.layer_types)}"
                    f"{f' with {sorted(bad)}' if bad else ''}")

    # ---- derived quantities -------------------------------------------------
    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytical parameter count (embeddings + blocks + head)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        n = V * d  # embedding
        if not self.tie_embeddings and self.n_classes == 0:
            n += V * d
        if self.n_classes:
            n += d * self.n_classes
        if self.positional == "learned":
            n += self.max_position * d

        def attn_block(heads=True):
            a = d * self.attn_dim + 2 * d * self.kv_dim + self.attn_dim * d
            if self.qkv_bias:
                a += self.attn_dim + 2 * self.kv_dim
            return a

        def mlp_block(ffx):
            gated = self.activation in ("silu", "geglu")
            return (3 if gated else 2) * d * ffx

        if self.family in ("dense", "vlm", "encoder"):
            n += L * (attn_block() + mlp_block(ff) + 2 * d)
            if self.family == "vlm":
                n += self.vision_embed_dim * d  # projector
        elif self.family == "moe":
            m = self.moe
            expert = mlp_block(m.d_ff_expert)
            n += L * (attn_block() + d * m.num_experts + m.num_experts * expert
                      + m.num_shared_experts * mlp_block(ff) + 2 * d)
        elif self.family == "ssm":  # rwkv6
            # time-mix: r,k,v,g,o (5 d*d) + ddlerp + decay low-rank + channel mix (~3.5 d*d)
            s = self.ssm
            n += L * (5 * d * d + 5 * s.ddlerp_rank * 2 * d + 2 * s.decay_rank * d
                      + 2 * d * int(3.5 * d) + 4 * d)
        elif self.layer_types:      # the per-layer hybrid: each layer by its mixer
            s = self.ssm
            d_in = s.expand * d
            nh, conv_ch = d_in // s.head_dim, d_in + 2 * s.d_state
            mamba = (d * (2 * d_in + 2 * s.d_state + nh) + s.d_conv * conv_ch + conv_ch
                     + 3 * nh + d_in + d_in * d)
            n_mamba = self.layer_types.count("mamba")
            n += n_mamba * mamba + (L - n_mamba) * attn_block()
            n += L * (mlp_block(ff) + 2 * d) + d     # every layer's MLP and norms, final norm
        elif self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            mamba = d * (2 * d_in + 2 * s.d_state * (d_in // s.head_dim) * 0 + 2) \
                + d * d_in + d_in * d  # in/out proj approx
            n += L * (mamba + 2 * d)
            n += attn_block() + mlp_block(ff) + 2 * d  # one shared block
        elif self.family == "encdec":
            enc = attn_block() + mlp_block(ff) + 2 * d
            dec = 2 * attn_block() + mlp_block(ff) + 3 * d
            n += self.n_encoder_layers * enc + L * dec
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model
        gated = self.activation in ("silu", "geglu")
        per_expert = (3 if gated else 2) * d * m.d_ff_expert
        dense_part = self.param_count() - self.n_layers * m.num_experts * per_expert
        return dense_part + self.n_layers * m.top_k * per_expert


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            seq_cap: int = 128) -> ModelConfig:
    """Smoke-test variant: same family/topology, tiny dims (<=512 d_model, <=4 experts)."""
    assert d_model <= 512
    if cfg.n_heads:
        n_kv = min(cfg.n_kv_heads, 4)
        n_heads = max(4, n_kv)
        head_dim = d_model // n_heads
    else:
        n_kv = n_heads = 0
        head_dim = 0
    kw = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=head_dim, d_ff=d_model * 4, vocab_size=min(cfg.vocab_size, 512),
        max_position=4096, dtype="float32",
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=d_model)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32, ddlerp_rank=8, decay_rank=16)
    if cfg.shared_attn_every:
        kw["shared_attn_every"] = 2
    if cfg.layer_types:     # both mixers: attention in the middle layer, Mamba2 elsewhere
        kw["layer_types"] = tuple("attention" if i == n_layers // 2 else "mamba"
                                  for i in range(n_layers))
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = n_layers
        kw["encoder_seq"] = 16
    if cfg.n_vision_tokens:
        kw["n_vision_tokens"] = 8
        kw["vision_embed_dim"] = d_model
    if cfg.sliding_window:
        kw["sliding_window"] = min(cfg.sliding_window, seq_cap)
    kw["lora"] = dataclasses.replace(cfg.lora, rank=4, alpha=8.0)
    return cfg.with_(**kw)
