"""The federated round, plainly (the paper's Alg. 1 with Eqs. 5-9): each
client's forward over its layers [0, cut), the server's over [cut, L)
with that client's server adapters and classifier, the loss's gradients
with respect to both sides' adapters and the classifier, one AdamW step
on each side, and every ``interval`` rounds the dataset-weighted mean of
the whole adapter stacks and of the classifiers, split again at each cut,
with fresh optimizer states."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from plainref import model as M
from plainref.adamw import Adam
from plainref.lm import nest
from plainref.numerics import Precision


def client_grads(mc, prec: Precision, params, adapters: dict, head, tokens, labels,
                 drop_rows: int = 0):
    """Loss and gradients of one client's batch through the whole stack;
    ``adapters`` flat over every layer (client's below the cut, the
    server's from it)."""
    rows = tokens.shape[0] - drop_rows
    names = list(adapters)
    leaves = [adapters[n].detach().float().requires_grad_(True) for n in names]
    hd = head.detach().float().requires_grad_(True)
    with torch.enable_grad():
        x = M.embed(mc, params, tokens[:rows])
        h = M.layers(mc, prec, params, nest(dict(zip(names, leaves))), x, 0, mc["n_layers"])
        logits = M.cls_logits(mc, prec, params, hd, h)
        loss = F.cross_entropy(logits, labels[:rows].long())
        gs = torch.autograd.grad(loss, leaves + [hd])
    return float(loss.detach()), dict(zip(names, gs[:-1])), gs[-1]


def split(flat: dict, cut: int):
    cli = {n: t for n, t in flat.items() if int(n.split(".")[0][1:]) < cut}
    srv = {n: t for n, t in flat.items() if int(n.split(".")[0][1:]) >= cut}
    return cli, srv


def run_rounds(mc, prec: Precision, params, global_adapters: dict, head0, cuts,
               batches, data_sizes, interval: int, adam: Adam, n_rounds: int,
               drop_rows: int = 0, zero_client_grads: int = -1):
    """``n_rounds`` rounds from the global adapters and classifier;
    ``batches[r][u]`` is client u's batch in round r.  Returns the mean
    loss of each round, each client's first gradients ({"c": client, "s":
    server, "head"}) and its state after the last round.
    ``zero_client_grads`` >= 0 drops that client's gradient to its own
    side (a fault: its answer from the server altered)."""
    n = len(cuts)
    state = []
    for u in range(n):
        cli, srv = split(global_adapters, cuts[u])
        state.append({"c": cli, "s": srv, "head": head0.float(),
                      "co": adam.init(cli), "so": adam.init({**srv, "head": head0})})
    losses, first = [], None
    for rnd in range(n_rounds):
        round_loss, round_grads = [], []
        for u in range(n):
            st = state[u]
            tokens, labels = batches[rnd][u]
            loss, g, g_head = client_grads(mc, prec, params, {**st["c"], **st["s"]},
                                           st["head"], tokens, labels, drop_rows)
            gc, gs = split(g, cuts[u])
            if u == zero_client_grads:
                gc = {k: torch.zeros_like(t) for k, t in gc.items()}
            st["c"], st["co"] = adam.update(st["c"], gc, st["co"])
            new_s, st["so"] = adam.update({**st["s"], "head": st["head"]},
                                          {**gs, "head": g_head}, st["so"])
            st["head"] = new_s.pop("head")
            st["s"] = new_s
            round_loss.append(loss)
            round_grads.append({"c": gc, "s": gs, "head": g_head})
        losses.append(float(np.mean(round_loss)))
        if first is None:
            first = round_grads
        if (rnd + 1) % interval == 0:
            commit(state, cuts, data_sizes, adam)
    return losses, first, state


def commit(state, cuts, data_sizes, adam: Adam) -> None:
    """Eqs. 5-9: whole stacks averaged by data size, split at each cut."""
    w = np.asarray(data_sizes, np.float64)
    w = w / w.sum()
    fulls = [{**st["c"], **st["s"]} for st in state]
    agg = {}
    for name in fulls[0]:
        acc = float(w[0]) * fulls[0][name]
        for wi, f in zip(w[1:], fulls[1:]):
            acc = acc + float(wi) * f[name]
        agg[name] = acc
    head = sum(float(wi) * st["head"] for wi, st in zip(w, state))
    for st, cut in zip(state, cuts):
        st["c"], st["s"] = split(agg, cut)
        st["head"] = head
        st["co"] = adam.init(st["c"])
        st["so"] = adam.init({**st["s"], "head": head})
