"""Model construction.  Port of ``src/repro/models/api.py``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import DecoderModel


def build_model(cfg: ModelConfig, device="cuda"):
    """The model for ``cfg`` on ``device`` (the CUDA card unless the caller
    asks for the CPU; ``meta`` builds shapes alone).  The encoder, dense,
    moe, vlm and ssm (RWKV6) families are ported; ``DecoderModel`` raises
    for the hybrid and encdec ones (ROADMAP Queue A, item 10)."""
    return DecoderModel(cfg, device)


def supports_decode(cfg: ModelConfig) -> bool:
    # encoder-only models (bert) have no decode step
    return cfg.family != "encoder"


def supports_long_context(cfg: ModelConfig) -> bool:
    """Native sub-quadratic (recurrent) families; dense/moe/vlm need the
    sliding-window variant; whisper enc-dec has no 500k decode at all."""
    return cfg.family in ("ssm", "hybrid")


def long_context_variant(cfg: ModelConfig, window: int = 8192) -> ModelConfig:
    """Sliding-window variant used for long_500k on attention families."""
    if cfg.family in ("ssm",):
        return cfg
    return cfg.with_(sliding_window=window)
