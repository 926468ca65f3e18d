"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version (``ref``) and launch counter: ``lora_matmul``, ``grouped_lora``
(modes chunk and direct), ``quant``, ``flash_attention`` and ``wkv6`` —
one for every Pallas kernel of the JAX package.  Nothing is built at
import: a wrapper builds its kernel at its first launch on the card."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
