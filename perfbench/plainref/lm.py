"""The LM server step, plainly: resume the model at the cut from the
phone's activations ``v``, the teacher-forced next-token loss (the mean
over every token), its gradients with respect to the server's adapters
and to ``v``, and one AdamW step of the adapters.  Rows go through in
blocks so that the float32 activations fit beside the program's peak."""
from __future__ import annotations

import torch

from plainref import model as M
from plainref.adamw import Adam
from plainref.numerics import Precision


def nest(leaves: dict) -> dict:
    """{"L3.wq.a": t} -> {3: {"wq": {"a": t}}}"""
    out: dict = {}
    for name, t in leaves.items():
        layer, target, ab = name.split(".")
        out.setdefault(int(layer[1:]), {}).setdefault(target, {})[ab] = t
    return out


def server_step(mc: dict, prec: Precision, params: dict, adapters: dict, opt_state,
                v: torch.Tensor, targets: torch.Tensor, cut: int, adam: Adam,
                block_rows: int, drop_rows: int = 0):
    """One step: (loss, dv, grads, new adapters, new optimizer state), the
    adapters and gradients flat ({"L{l}.{target}.{a|b}": float32 tensor},
    layers [cut, L)).  ``drop_rows`` > 0 leaves that many trailing rows out
    and takes the mean over the rest (a fault, for calibration)."""
    rows = v.shape[0] - drop_rows
    n_tok = rows * v.shape[1]
    names = list(adapters)
    leaves = [adapters[n].detach().float().requires_grad_(True) for n in names]
    grads = [torch.zeros_like(t) for t in leaves]
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    loss = 0.0
    for r0 in range(0, rows, block_rows):
        r1 = min(rows, r0 + block_rows)
        vb = v[r0:r1].detach().float().requires_grad_(True)
        with torch.enable_grad():
            h = M.layers(mc, prec, params, nest(dict(zip(names, leaves))), vb, cut,
                         mc["n_layers"])
            nll = M.lm_nll_sum(mc, prec, params, h, targets[r0:r1]) / n_tok
            gs = torch.autograd.grad(nll, [vb] + leaves)
        dv[r0:r1] = gs[0]
        for acc, g in zip(grads, gs[1:]):
            acc += g
        loss += float(nll.detach())
        del h, nll, gs, vb
    grads = dict(zip(names, grads))
    if opt_state is None:
        opt_state = adam.init(grads)
    new, opt_state = adam.update({n: t.detach() for n, t in zip(names, leaves)}, grads,
                                 opt_state)
    return loss, dv, grads, new, opt_state
