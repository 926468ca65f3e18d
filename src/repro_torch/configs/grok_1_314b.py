"""grok-1-314b [moe] — 8 experts top-2, GQA kv=8. [hf:xai-org/grok-1]"""
from repro_torch.configs.base import LoRAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131_072,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32768, capacity_factor=1.25),
    lora=LoRAConfig(rank=16, alpha=32.0, targets=("wq", "wk", "wv", "wo", "wr_router")),
    source="hf:xai-org/grok-1",
)
