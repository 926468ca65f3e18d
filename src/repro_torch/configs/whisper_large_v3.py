"""whisper-large-v3 [audio] — enc-dec backbone; conv/mel frontend is a stub
that supplies precomputed frame embeddings. [arXiv:2212.04356]"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,            # decoder layers
    n_encoder_layers=32,
    encoder_seq=1500,       # 30 s of audio at 50 Hz after the conv stub
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,          # MHA
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    activation="gelu",
    norm="layernorm",
    positional="learned",
    max_position=32_768,    # decoder-side learned positions (448 in the original;
                            # enlarged so the assigned 32k shapes lower — DESIGN.md §10)
    tie_embeddings=True,
    lora=LoRAConfig(rank=16, alpha=32.0, targets=("wq", "wk", "wv", "wo")),
    source="arXiv:2212.04356 (Whisper large-v3)",
)
