"""Model construction and the step inputs' stand-ins.  Port of
``src/repro/models/api.py``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models.decoder import DecoderModel
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.layers import torch_dtype


def build_model(cfg: ModelConfig, device="cuda"):
    """The model for ``cfg`` on ``device`` (the CUDA card unless the caller
    asks for the CPU; ``meta`` builds shapes alone): ``EncDecModel`` for
    the encdec family (whisper), ``DecoderModel`` for every other one."""
    if cfg.family == "encdec":
        return EncDecModel(cfg, device)
    return DecoderModel(cfg, device)


def supports_decode(cfg: ModelConfig) -> bool:
    # encoder-only models (bert) have no decode step
    return cfg.family != "encoder"


def supports_long_context(cfg: ModelConfig) -> bool:
    """Native sub-quadratic (recurrent) families; dense/moe/vlm need the
    sliding-window variant; whisper enc-dec has no 500k decode at all."""
    return cfg.family in ("ssm", "hybrid")


def long_context_variant(cfg: ModelConfig, window: int = 8192) -> ModelConfig:
    """Sliding-window variant used for long_500k on attention families."""
    if cfg.family in ("ssm",):
        return cfg
    return cfg.with_(sliding_window=window)


def input_specs(cfg: ModelConfig, shape: InputShape, model=None,
                cache_len: Optional[int] = None) -> dict:
    """Stand-ins for every model input of the given step: ``meta``-device
    tensors of the inputs' shapes and dtypes (the port's counterpart of the
    reference's ``ShapeDtypeStruct``s; nothing is allocated): int32
    tokens, activation-dtype frames and embeddings, and for a decode step
    the cache's (``cache_spec``) at ``cache_len`` slots (default: the
    sliding window, else the sequence).  A VLM shape shorter than the
    vision prefix raises (the reference returns a negative text length)."""
    model = model or build_model(cfg, device="meta")
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = torch_dtype(cfg.dtype)

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if cfg.family == "vlm" and shape.kind != "decode" and s < cfg.n_vision_tokens:
        raise ValueError(f"{shape.name}: {s} tokens do not hold {cfg.name}'s "
                         f"{cfg.n_vision_tokens} vision tokens")

    if shape.kind == "train":
        if cfg.family == "encoder":
            return {"tokens": sds((b, s), i32), "label": sds((b,), i32)}
        if cfg.family == "encdec":
            return {"frames": sds((b, cfg.encoder_seq, cfg.d_model), act),
                    "tokens": sds((b, s), i32), "targets": sds((b, s), i32)}
        if cfg.family == "vlm":
            st = s - cfg.n_vision_tokens
            return {"vision_embeds": sds((b, cfg.n_vision_tokens, cfg.vision_embed_dim), act),
                    "tokens": sds((b, st), i32), "targets": sds((b, st), i32)}
        return {"tokens": sds((b, s), i32), "targets": sds((b, s), i32)}

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"frames": sds((b, cfg.encoder_seq, cfg.d_model), act),
                    "tokens": sds((b, s), i32)}
        if cfg.family == "vlm":
            return {"vision_embeds": sds((b, cfg.n_vision_tokens, cfg.vision_embed_dim), act),
                    "tokens": sds((b, s - cfg.n_vision_tokens), i32)}
        return {"tokens": sds((b, s), i32)}

    if shape.kind == "decode":
        clen = cache_len if cache_len is not None else (
            cfg.sliding_window if cfg.sliding_window else s)
        return {"cache": model.cache_spec(b, clen), "token": sds((b, 1), i32),
                "pos": sds((), i32)}
    raise ValueError(shape.kind)
