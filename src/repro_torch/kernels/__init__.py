"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version (``ref``) and launch counter.  Ported so far: ``lora_matmul``,
``grouped_lora`` (modes chunk and direct) and ``quant``."""
