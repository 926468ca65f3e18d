"""rwkv6-3b [ssm] — RWKV-6 "Finch": attention-free, data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.configs.base import LoRAConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=8960,              # channel-mix hidden dim
    vocab_size=65_536,
    activation="relu2",     # channel-mix uses relu^2
    norm="layernorm",
    positional="none",
    tie_embeddings=True,
    ssm=SSMConfig(head_dim=64, ddlerp_rank=32, decay_rank=64),
    lora=LoRAConfig(rank=16, alpha=32.0, targets=("wr", "wk", "wv", "wg", "wo")),
    source="arXiv:2404.05892 (RWKV-6 Finch, 3B)",
)
