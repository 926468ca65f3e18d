from repro_torch.models.api import (build_model, long_context_variant, supports_decode,
                                    supports_long_context)
from repro_torch.models.decoder import DecoderModel

__all__ = ["DecoderModel", "build_model", "long_context_variant", "supports_decode",
           "supports_long_context"]
