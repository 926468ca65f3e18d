"""Plain AdamW (no weight decay, no clipping) over a flat dict of float32
tensors, with bias correction at each tensor's own step."""
from __future__ import annotations

import torch


class Adam:
    def __init__(self, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: dict) -> dict:
        return {"step": 0, "m": {k: torch.zeros_like(v) for k, v in params.items()},
                "v": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(self, params: dict, grads: dict, state: dict):
        t = state["step"] + 1
        m = {k: self.b1 * state["m"][k] + (1 - self.b1) * g for k, g in grads.items()}
        v = {k: self.b2 * state["v"][k] + (1 - self.b2) * g * g for k, g in grads.items()}
        c1, c2 = 1 - self.b1 ** t, 1 - self.b2 ** t
        new = {k: p - self.lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + self.eps)
               for k, p in params.items()}
        return new, {"step": t, "m": m, "v": v}
