"""bert-base [encoder] — the paper's own pre-trained model (Devlin 2018),
fine-tuned on a CARER-style 6-class emotion task with LoRA r=16."""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="bert-base",
    family="encoder",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=30_522,
    activation="gelu",
    norm="layernorm",
    positional="learned",
    max_position=512,
    causal=False,
    tie_embeddings=True,
    n_classes=6,            # CARER: sadness/joy/love/anger/fear/surprise
    dtype="float32",        # the paper fine-tunes in fp32 on the RTX 4080s
    lora=LoRAConfig(rank=16, alpha=32.0, targets=("wq", "wk", "wv", "wo")),
    source="arXiv:1810.04805 (BERT-base); paper §V simulation setup",
)
