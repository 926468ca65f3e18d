"""The benchmark's harness: cell discovery, seeded inputs, timing, trace
reading, the frozen work counts and the comparison that decides
``correct``.  It drives the program (``repro_torch``) and imports neither
JAX nor the JAX package."""
