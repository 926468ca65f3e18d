"""internvl2-26b [vlm] — InternViT (stub) + InternLM2-20B backbone. [arXiv:2404.16821]

The ViT + MLP projector frontend is the permitted stub: ``input_specs()``
supplies precomputed patch embeddings of shape (B, n_vision_tokens,
vision_embed_dim); the framework implements the projector + language model.
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92_553,
    activation="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    n_vision_tokens=1024,       # 448x448 image -> 1024 patch tokens after pixel shuffle
    vision_embed_dim=3200,      # InternViT-6B hidden size
    lora=LoRAConfig(rank=16, alpha=32.0, targets=("wq", "wk", "wv", "wo")),
    source="arXiv:2404.16821 (InternVL2-26B: InternViT-6B + InternLM2-20B)",
)
