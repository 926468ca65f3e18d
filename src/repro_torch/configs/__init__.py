"""Config registry of the port: the paper's BERT-base and the decoder LMs
of the serving slice (gemma-2b, rwkv6-3b).  The other model families join
as their slices are ported."""
from __future__ import annotations

from repro_torch.configs import bert_base, gemma_2b, rwkv6_3b
from repro_torch.configs.base import LoRAConfig, ModelConfig, MoEConfig, SSMConfig, reduced

REGISTRY: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                    for m in (gemma_2b, rwkv6_3b, bert_base)}


def get_config(name: str) -> ModelConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}") from None


__all__ = ["LoRAConfig", "ModelConfig", "MoEConfig", "REGISTRY", "SSMConfig",
           "get_config", "reduced"]
