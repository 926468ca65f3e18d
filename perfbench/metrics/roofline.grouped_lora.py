"""roofline.grouped_lora: the cohort-grouped projections' calls (one per
target and layer forward over every lane, one for each input gradient) at
the least time their shapes allow (fp32 against 3xTF32's peak, the
units its fp32 tile runs on), over the device time of the kernels
below.  A change that renames or replaces the kernel adds its name here;
the work counted stays the same whatever runs it.  Layer: kernels."""
from harness.roofline import share

KERNELS = ("grouped_lora_kernel", "grouped_lora_bf16_kernel", "grouped_lora_wgmma_kernel",
           "grouped_lora_direct_kernel", "grouped_lora_direct_wgmma_kernel")


def read(ctx):
    return share(ctx, "grouped_lora", KERNELS)
