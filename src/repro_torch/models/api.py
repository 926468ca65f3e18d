"""Model construction.  Port of ``src/repro/models/api.py``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import DecoderModel


def build_model(cfg: ModelConfig, device="cuda"):
    """The model for ``cfg`` on ``device`` (the CUDA card unless the caller
    asks for the CPU; ``meta`` builds shapes alone).  The encoder, dense and ssm (RWKV6) families are
    ported; ``DecoderModel`` raises for the others."""
    return DecoderModel(cfg, device)


def supports_decode(cfg: ModelConfig) -> bool:
    # encoder-only models (bert) have no decode step
    return cfg.family != "encoder"
