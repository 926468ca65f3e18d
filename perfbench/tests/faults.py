"""Faults planted in the program's timed path, for the tests that check
that the comparison catches them: a step that returns its state
unchanged, half of the batch left out (the mean over the rest), an
answer (one upload's or one lane's dv) altered where it is produced."""
from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered_answer")


def _half(t, axis):
    n = t.shape[axis] // 2
    return t.narrow(axis, 0, n)


def _pad(dv, full_shape, axis):
    out = torch.zeros(full_shape, dtype=dv.dtype, device=dv.device)
    out.narrow(axis, 0, dv.shape[axis]).copy_(dv)
    return out


def lm_step(make, fault):
    """Wrap ``splitfl.make_server_step``: (params, lora, opt, v, batch)."""
    def make_faulty(*args, **kwargs):
        step = make(*args, **kwargs)

        def faulty(params, lora, opt, v, batch):
            if fault == "half_batch":
                loss, lo, st, dv = step(params, lora, opt, _half(v, 0),
                                        {k: _half(x, 0) for k, x in batch.items()})
                return loss, lo, st, _pad(dv, v.shape, 0)
            loss, lo, st, dv = step(params, lora, opt, v, batch)
            if fault == "unchanged":
                return loss, lora, opt, dv
            dv = dv.clone()
            dv[0] = 0
            return loss, lo, st, dv
        return faulty
    return make_faulty


def cls_batched_step(make, fault):
    """Wrap ``splitfl.make_server_step_cls_batched``: (params, lora, heads,
    opt, v, batch, cuts), lanes first."""
    def make_faulty(*args, **kwargs):
        step = make(*args, **kwargs)

        def faulty(params, lora, heads, opt, v, batch, cuts):
            if fault == "half_batch":
                out = step(params, lora, heads, opt, _half(v, 1),
                           {k: _half(x, 1) for k, x in batch.items()}, cuts)
                return (*out[:4], _pad(out[4], v.shape, 1))
            losses, lo, hd, st, dv = step(params, lora, heads, opt, v, batch, cuts)
            if fault == "unchanged":
                return losses, lora, heads, opt, dv
            dv = dv.clone()
            dv[0] = 0
            return losses, lo, hd, st, dv
        return faulty
    return make_faulty


def plant(monkeypatch, cell_name: str, fault: str) -> None:
    from repro_torch.core import splitfl
    if cell_name.startswith("granite"):
        monkeypatch.setattr(splitfl, "make_server_step",
                            lm_step(splitfl.make_server_step, fault))
    else:
        monkeypatch.setattr(splitfl, "make_server_step_cls_batched",
                            cls_batched_step(splitfl.make_server_step_cls_batched, fault))
