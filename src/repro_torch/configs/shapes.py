"""Assigned input shapes (public pool) + the paper's own workload shape.

Each shape names the step kind that the dry-run lowers:
  * train_*    -> ``train_step``   (forward + backward + LoRA/optimizer update)
  * prefill_*  -> ``prefill_step`` (forward, build KV/recurrent cache)
  * decode_*   -> ``serve_step``   (ONE new token against a cache of seq_len)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def step_name(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step", "decode": "serve_step"}[self.kind]


TRAIN_4K = InputShape("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = InputShape("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = InputShape("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = InputShape("long_500k", seq_len=524_288, global_batch=1, kind="decode")

# The paper's own fine-tuning workload (BERT-base, CARER): seq 128, batch 16.
PAPER_FT = InputShape("paper_ft", seq_len=128, global_batch=16, kind="train")

SHAPES: dict[str, InputShape] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, PAPER_FT)
}

ASSIGNED_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def get_shape(name: str) -> InputShape:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown input shape {name!r}; known: {sorted(SHAPES)}") from None
