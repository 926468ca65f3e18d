"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version (``ref``) and launch counter: ``lora_matmul``, ``grouped_lora``
(modes chunk and direct), ``quant``, ``flash_attention`` and ``wkv6`` —
one for every Pallas kernel of the JAX package."""
