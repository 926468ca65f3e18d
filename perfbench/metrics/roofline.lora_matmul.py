"""roofline.lora_matmul: the adapted projections' calls (one per target
and layer forward, one for each input gradient) at the least time their
shapes allow, over the device time of the kernels below.  A change that
renames or replaces the kernel adds its name here; the work counted stays
the same whatever runs it.  Layer: kernels."""
from harness.roofline import share

KERNELS = ("lora_matmul_kernel", "lora_matmul_bf16_kernel", "lora_matmul_wgmma_kernel")


def read(ctx):
    return share(ctx, "lora_matmul", KERNELS)
