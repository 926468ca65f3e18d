"""granite-4.0-h-micro [hybrid] — 40 layers, each a Mamba2 or a GQA attention
mixer followed by its own SiLU-gated MLP; Granite's multipliers; no
positional encoding.  [hf:ibm-granite/granite-4.0-h-micro]

Every width, the 40 layers and the 100,352-token vocabulary are the
published ``config.json``'s.  Assumed (the config names no adapters): LoRA
r 16, alpha 32 on the Mamba2 ``in_proj``/``out_proj`` and the attention's
``wq``/``wk``/``wv``/``wo``, zamba2-7b's targets.  ``wkv_chunk`` 64: the
chunked SSD computes the same sums at any chunk, and on an H100 its
server step at 16 x 512 took 1.30 s at the published ``mamba_chunk_size``
256, 1.07 s at 128 and 1.06 s at 64 (PERF.md).  Departures from the published model: the
RMSNorms scale by (1 + w) with eps 1e-6 (published w and 1e-5), as in
every config of the port, the Mamba2 gate's norm included.
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig, SSMConfig

# the published ``layer_types``: attention at layers 5, 15, 25 and 35
LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba" for i in range(40))

CONFIG = ModelConfig(
    name="granite-4.0-h-micro",
    family="hybrid",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,              # shared_intermediate_size; no routed experts
    vocab_size=100_352,
    activation="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    positional="none",      # position_embedding_type "nope"
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),   # 64 heads of 64, one group
    layer_types=LAYER_TYPES,
    embedding_multiplier=12.0,
    attention_multiplier=0.015625,
    residual_multiplier=0.22,
    logits_scaling=8.0,
    attn_impl="naive",
    wkv_impl="chunked",
    wkv_chunk=64,
    lora=LoRAConfig(rank=16, alpha=32.0, impl="fused",
                    targets=("in_proj", "out_proj", "wq", "wk", "wv", "wo")),
    source="hf:ibm-granite/granite-4.0-h-micro",
)
