from repro_torch.models.api import build_model, supports_decode
from repro_torch.models.decoder import DecoderModel

__all__ = ["DecoderModel", "build_model", "supports_decode"]
