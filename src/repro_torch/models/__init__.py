from repro_torch.models.api import (build_model, input_specs, long_context_variant,
                                    supports_decode, supports_long_context)

__all__ = ["build_model", "input_specs", "long_context_variant", "supports_decode",
           "supports_long_context"]
