"""mfu: the traced slice's model FLOPs (``harness.work``'s frozen count:
useful products only, each lane from its own cut, no weight gradient for
frozen weights, no recomputation) over its wall time and the chip's peak
for the configuration's type (``harness.work.PEAK_FLOPS``: 989 TFLOP/s
bf16; fp32 at 3xTF32's 164.8 TFLOP/s, the units the program's fp32
tiles run on with TF32 off).
Layer: model step."""
from harness.work import PEAK_FLOPS


def read(ctx):
    if ctx.trace.n_kernels == 0:
        return None
    return 100.0 * ctx.work["model_flops"] / ctx.trace.window_s / PEAK_FLOPS[ctx.work["dtype"]]
