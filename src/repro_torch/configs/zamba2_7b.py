"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block. [arXiv:2411.15242]"""
from repro_torch.configs.base import LoRAConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,            # mamba2 blocks
    d_model=3584,
    n_heads=32,             # shared attention block
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,             # shared block MLP
    vocab_size=32_000,
    activation="silu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
    shared_attn_every=6,    # one shared attn+MLP block re-applied every 6 mamba blocks
    # long_500k applies sliding_window=8192 to the shared attention (launch layer)
    lora=LoRAConfig(rank=16, alpha=32.0, targets=("in_proj", "out_proj", "wq", "wk", "wv", "wo")),
    source="arXiv:2411.15242 (Zamba2-7B)",
)
