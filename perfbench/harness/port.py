"""The program's side of a cell: its configuration object and a check
that the benchmark's weights have the layout the program expects."""
from __future__ import annotations


def model_config(mc: dict):
    """The program's ``ModelConfig`` for a configuration file's "model"."""
    from repro_torch.configs.base import LoRAConfig, ModelConfig
    fields = dict(mc)
    lora = dict(fields.pop("lora"))
    lora["targets"] = tuple(lora["targets"])
    return ModelConfig(**fields, lora=LoRAConfig(**lora))


def check_layout(mine, spec, path: str = "params") -> None:
    """The same keys, shapes and types as the program's spec (``meta``)."""
    if isinstance(spec, dict):
        if not isinstance(mine, dict) or set(mine) != set(spec):
            raise ValueError(f"{path}: keys {sorted(mine) if isinstance(mine, dict) else mine}"
                             f" differ from the program's {sorted(spec)}")
        for k in spec:
            check_layout(mine[k], spec[k], f"{path}.{k}")
        return
    if tuple(mine.shape) != tuple(spec.shape) or mine.dtype != spec.dtype:
        raise ValueError(f"{path}: {tuple(mine.shape)} {mine.dtype} where the program "
                         f"expects {tuple(spec.shape)} {spec.dtype}")


def same_optimizer(opt, spec: dict) -> None:
    """The program's AdamW has the traffic file's settings."""
    for k in ("b1", "b2", "eps"):
        if getattr(opt, k) != spec[k]:
            raise ValueError(f"the program's AdamW has {k}={getattr(opt, k)}, "
                             f"the traffic file {spec[k]}")
    if opt.weight_decay or opt.grad_clip_norm:
        raise ValueError("the reference's AdamW has no weight decay or clipping")
