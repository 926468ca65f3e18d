"""The port's numerics policy, set in one place.

The paper's BERT-base configuration trains in fp32, and the JAX reference
computes every product in full fp32.  The port matches it: TF32 stays off
for matrix products and for cuDNN, so a float32 product on the card keeps
float32's 24-bit mantissa (TF32 keeps 10).  Every adapted projection under
``fused_lora`` goes through the hand-written CUDA kernel, which runs on the
tensor cores with each operand split into two TF32 parts (3xTF32: about
22 significant bits an operand, each k8 slice's products added to an f32
accumulator with round-to-nearest) and never takes a plain TF32 product;
its error against exact products is close to the plain fp32 product's
(PERF.md).  Tests and
``chip_smoke.py`` call :func:`set_fp32_policy` before they run anything.
"""
from __future__ import annotations

import torch


def set_fp32_policy() -> None:
    """Full-precision fp32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
