"""granite-3-2b [dense] — GQA kv=8. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49_155,
    activation="silu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    lora=LoRAConfig(rank=16, alpha=32.0, targets=("wq", "wk", "wv", "wo")),
    source="hf:ibm-granite/granite-3.0-2b-base",
)
