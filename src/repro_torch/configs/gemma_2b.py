"""gemma-2b [dense] — GeGLU, head_dim=256, MQA. [arXiv:2403.08295]"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,          # MQA on the 2b variant
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    lora=LoRAConfig(rank=16, alpha=32.0, targets=("wq", "wk", "wv", "wo")),
    source="arXiv:2403.08295 (Gemma, 2B)",
)
