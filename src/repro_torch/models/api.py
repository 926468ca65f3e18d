"""Model construction.  Port of ``src/repro/models/api.py``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import DecoderModel


def build_model(cfg: ModelConfig, device="cuda"):
    """The model for ``cfg`` on ``device`` (the CUDA card unless the caller
    asks for the CPU).  The encoder family is ported; the others raise."""
    if cfg.family != "encoder":
        raise NotImplementedError(
            f"family {cfg.family!r} comes with a later slice of the port "
            "(ROADMAP Queue A, item 10)")
    return DecoderModel(cfg, device)

