from repro_torch.comm.quantization import (Quantized, dequantize, quantize,
                                           quantize_with_feedback, transport_bytes)

__all__ = ["Quantized", "dequantize", "quantize", "quantize_with_feedback",
           "transport_bytes"]
