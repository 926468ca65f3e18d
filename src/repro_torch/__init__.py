"""PyTorch/CUDA port of the split-federated LoRA fine-tuning system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs``, ``data``, ``kernels``, ``models``, ``core``, ``optim``, ``fed``)
and imports nothing from it.  Entry points (``models.build_model``,
``fed.Simulator``) run on the CUDA device unless the caller passes
``device="cpu"``; the fp32 numerics policy lives in :mod:`repro_torch.numerics`.
"""
