"""qwen1.5-4b [dense] — MHA with QKV bias. [hf:Qwen/Qwen1.5-0.5B family]"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,          # MHA
    head_dim=128,
    d_ff=6912,
    vocab_size=151_936,
    activation="silu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    lora=LoRAConfig(rank=16, alpha=32.0, targets=("wq", "wk", "wv", "wo")),
    source="hf:Qwen/Qwen1.5-0.5B (scaled per assignment: 4B)",
)
