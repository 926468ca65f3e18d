"""Algorithm 1 — the memory-efficient SFL training step, in PyTorch.  Port
of the static-cut part of ``src/repro/core/splitfl.py``.

The three computational pieces of one round:

  client_forward   (Alg.1 l.4, Eq. 3): v_u = f(W_u, R_c^u; x_u)
  server_step      (Alg.1 l.9-11, Eq. 4): resume at the cut on the ONE full
                   model, update R_s^u, emit activation gradients
  client_backward  (Alg.1 l.15): update R_c^u from the activation gradients

Only adapters and the classifier head require grad; the frozen base
weights never do, so no backward pass forms a weight gradient for them.
The cohort-batched server steps come with ROADMAP Queue A, item 6.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any


def as_trainable(tree: PyTree) -> PyTree:
    """Fresh autograd leaves holding the same values."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def tree_grad(out: torch.Tensor, tree: PyTree, extra=(), grad_out=None):
    """Gradients of ``out`` (weighted by ``grad_out``) with respect to the
    leaves of ``tree`` and to the tensors in ``extra``: (grad tree, extras).
    Leaves ``out`` does not reach get zeros, as under ``jax.grad``."""
    leaves = tree_leaves(tree)
    gs = torch.autograd.grad(out, leaves + list(extra), grad_outputs=grad_out,
                             materialize_grads=True)
    return tree_unflatten(tree, list(gs[:len(leaves)])), gs[len(leaves):]


def client_forward(model, params_c: PyTree, lora_c: PyTree, batch: dict,
                   cut: int):
    """Eq. 3. ``params_c``/``lora_c`` hold only the client's prefix (their
    stacked leaves have leading dim == cut)."""
    v, _ = model.forward_hidden(params_c, lora_c, batch, cut=cut, side="client")
    return v


def server_loss(model, params: PyTree, lora_s: PyTree, v: torch.Tensor,
                batch: dict, cut: int):
    """Eq. 4 + loss: resume the full model at the cut with R_s^u."""
    return model.loss(params, lora_s, batch, cut=cut, side="server", x0=v)


def make_server_step_cls(model, opt: AdamW, *, static_cut: int):
    """Server step for classification fine-tuning: the classifier head
    trains alongside the server-side adapters.

    signature: (params, lora_s, head, opt_state, v, batch) ->
               (loss, new_lora_s, new_head, new_opt_state, dv)
    where opt_state is over the tree {"lora": ..., "head": ...} and ``dv`` is
    the gradient of the loss with respect to the received activations ``v``.
    """
    cut = int(static_cut)

    def step(params, lora_s, head, opt_state, v, batch):
        trainable = as_trainable({"lora": lora_s, "head": head})
        vv = v.detach().requires_grad_(True)
        with torch.enable_grad():
            pp = dict(params)
            pp["cls_head"] = trainable["head"]
            loss, _ = server_loss(model, pp, trainable["lora"], vv, batch, cut)
            g_tr, (g_v,) = tree_grad(loss, trainable, extra=(vv,))
        new_tr, new_opt = opt.update(g_tr, opt_state,
                                     tree_map(torch.Tensor.detach, trainable))
        return loss.detach(), new_tr["lora"], new_tr["head"], new_opt, g_v

    return step


@dataclasses.dataclass
class ClientTape:
    """What the client keeps between its forward and its backward: the
    activations with their autograd graph, and the adapter leaves the graph
    starts from.  The backward reuses this graph instead of recomputing the
    forward (the reference recomputes it inside ``bwd``; the values agree)."""
    v: torch.Tensor
    lora: PyTree


def client_vjp(tape: ClientTape, dv: torch.Tensor) -> PyTree:
    """Gradients of the client's adapters given the activation gradient
    ``dv`` (the reference's ``client_forward_with_vjp`` pullback)."""
    g, _ = tree_grad(tape.v, tape.lora, grad_out=dv)
    return g


def make_client_step(model, opt: AdamW, cut: int):
    """The client fwd+bwd pair for a fixed (static) cut.

    forward:  (params_c, lora_c, batch)  -> (v, tape)
    backward: (tape, opt_state, dv)      -> (new_lora_c, new_opt)
    """
    def fwd(params_c, lora_c, batch):
        lc = as_trainable(lora_c)
        with torch.enable_grad():
            v = client_forward(model, params_c, lc, batch, cut)
        return v.detach(), ClientTape(v, lc)

    def bwd(tape: ClientTape, opt_state, dv):
        return opt.update(client_vjp(tape, dv), opt_state,
                          tree_map(torch.Tensor.detach, tape.lora))

    return fwd, bwd
