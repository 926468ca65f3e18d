"""granite-20b [dense] — llama-style code model, MQA. [arXiv:2405.04324]"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,          # MQA
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",      # non-gated MLP (gpt_bigcode lineage) -> 20B total
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    lora=LoRAConfig(rank=16, alpha=32.0, targets=("wq", "wk", "wv", "wo")),
    source="arXiv:2405.04324 (Granite Code Models, 20B)",
)
