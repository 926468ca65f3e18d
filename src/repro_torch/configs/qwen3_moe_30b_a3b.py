"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, GQA kv=4. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import LoRAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,               # per-expert FFN dim
    vocab_size=151_936,
    activation="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768, capacity_factor=1.25),
    lora=LoRAConfig(rank=16, alpha=32.0, targets=("wq", "wk", "wv", "wo", "wr_router")),
    source="hf:Qwen/Qwen3-30B-A3B",
)
