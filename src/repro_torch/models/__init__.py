from repro_torch.models.api import build_model
from repro_torch.models.decoder import DecoderModel

__all__ = ["DecoderModel", "build_model"]
