"""Config registry of the port: the 10 assigned architectures and the
paper's BERT-base, copies of the JAX package's configs, and the port's
own (``PORT_ARCHS``), which the JAX package does not have.  The port builds
every family: encoder (bert-base), dense (gemma-2b, granite-3-2b,
granite-20b, qwen1.5-4b), ssm (rwkv6-3b), moe (qwen3-moe-30b-a3b,
grok-1-314b), vlm (internvl2-26b), hybrid (zamba2-7b; the per-layer
granite-4.0-h-micro) and encdec (whisper-large-v3)."""
from __future__ import annotations

from repro_torch.configs.base import LoRAConfig, ModelConfig, MoEConfig, SSMConfig, reduced
from repro_torch.configs.shapes import ASSIGNED_SHAPES, SHAPES, InputShape, get_shape

from repro_torch.configs import (  # noqa: E402
    bert_base,
    gemma_2b,
    granite_3_2b,
    granite_4_0_h_micro,
    granite_20b,
    grok_1_314b,
    internvl2_26b,
    qwen1_5_4b,
    qwen3_moe_30b_a3b,
    rwkv6_3b,
    whisper_large_v3,
    zamba2_7b,
)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        granite_20b, gemma_2b, granite_3_2b, grok_1_314b, whisper_large_v3,
        qwen1_5_4b, internvl2_26b, rwkv6_3b, qwen3_moe_30b_a3b, zamba2_7b,
        bert_base, granite_4_0_h_micro,
    )
}

# the port's configs that the JAX package has no copy of
PORT_ARCHS = (granite_4_0_h_micro.CONFIG.name,)
ASSIGNED_ARCHS = tuple(n for n in REGISTRY if n != "bert-base" and n not in PORT_ARCHS)


def get_config(name: str) -> ModelConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}") from None


__all__ = [
    "ASSIGNED_ARCHS", "ASSIGNED_SHAPES", "InputShape", "LoRAConfig",
    "ModelConfig", "MoEConfig", "REGISTRY", "SHAPES", "SSMConfig",
    "get_config", "get_shape", "reduced",
]
