"""The numbers that decide ``correct``, each held against its limit.

A training cell's set-up drives the program through its first steps; the
reference follows the same steps from the same inputs.  Readings on each
side (``Readings``) are small: each step's loss, each leaf's gradient norm
at its first step (the program's is read back from its optimizer's first
moment), each leaf's change after the checked steps, and, where the step
answers a phone, the activation gradient it sent.  The numbers:

* ``loss_gap``: the largest |loss - loss_ref| / |loss_ref| over the steps;
* ``grad_gap`` and ``change_gap``: the worst leaf's |norm - norm_ref| over
  the larger of that leaf's reference norm and the median leaf's;
* ``dv_gap``: the worst token's |dv - dv_ref| (2-norm over the hidden
  size) over the larger of its reference norm and the median token's.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both leaf numbers: their change is AdamW's
round-off (a first step moves every element by about the learning rate,
whatever the sign of a gradient that is nought to rounding).
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional

import torch

TINY_GRAD = 1e-3


@dataclasses.dataclass
class Readings:
    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]
    dvs: List[torch.Tensor] = dataclasses.field(default_factory=list)   # (tokens, d) f32, host


def norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    """{name: scale * ||t||} read back in one transfer."""
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[n].float().norm() for n in names]).mul_(scale)
    return dict(zip(names, vals.tolist()))


def _worst(values) -> float:
    """The largest value; a NaN anywhere reads as infinite, never hidden."""
    values = list(values)
    return math.inf if any(math.isnan(v) for v in values) else max(values)


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              ref_grad: Dict[str, float]) -> float:
    missing = set(ref) - set(prog)
    if missing:
        raise KeyError(f"the program gave no reading for {sorted(missing)[:4]}")
    med_grad = statistics.median(ref_grad.values())
    keep = [n for n in ref if ref_grad.get(n, 0.0) >= TINY_GRAD * med_grad]
    med = statistics.median(ref[n] for n in keep)
    return _worst(abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep)


def _dv_gap(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    worst = 0.0
    for p, r in zip(prog, ref, strict=True):
        gap = (p.float() - r.float()).norm(dim=-1)
        rn = r.float().norm(dim=-1)
        worst = _worst([worst, float((gap / rn.clamp_min(rn.median())).max())])
    return worst


def numbers(prog: Readings, ref: Readings) -> Dict[str, float]:
    out = {"loss_gap": _worst(abs(p - r) / abs(r)
                              for p, r in zip(prog.losses, ref.losses, strict=True)),
           "grad_gap": _leaf_gap(prog.grad_norms, ref.grad_norms, ref.grad_norms),
           "change_gap": _leaf_gap(prog.change_norms, ref.change_norms, ref.grad_norms)}
    if ref.dvs:
        out["dv_gap"] = _dv_gap(prog.dvs, ref.dvs)
    return out


def check(values: Dict[str, float], limits: Dict[str, dict]) -> Dict[str, dict]:
    """Each number beside its limit: {name: {"value", "limit", "ok"}}.  A
    number with no limit is reported and not held (``ok`` is None)."""
    out = {}
    for name, v in values.items():
        lim: Optional[float] = limits.get(name, {}).get("limit")
        out[name] = {"value": v, "limit": lim,
                     "ok": None if lim is None else bool(v <= lim)}
    return out


def all_ok(checks: Dict[str, dict]) -> bool:
    held = [c["ok"] for c in checks.values() if c["ok"] is not None]
    return bool(held) and all(held)
