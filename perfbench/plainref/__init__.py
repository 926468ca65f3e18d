"""The benchmark's plain reference: the two model families it runs, AdamW,
the LM server step and the federated round, in plain PyTorch.  Nothing
here imports the program (``repro_torch``), the JAX package or JAX; the
reference reads the program's outputs only to judge them."""
