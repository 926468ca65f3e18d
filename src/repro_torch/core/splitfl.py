"""Algorithm 1 — the memory-efficient SFL training step, in PyTorch.  Port
of the static-cut part of ``src/repro/core/splitfl.py``.

The three computational pieces of one round:

  client_forward   (Alg.1 l.4, Eq. 3): v_u = f(W_u, R_c^u; x_u)
  server_step      (Alg.1 l.9-11, Eq. 4): resume at the cut on the ONE full
                   model, update R_s^u, emit activation gradients
  client_backward  (Alg.1 l.15): update R_c^u from the activation gradients

Only adapters and the classifier head require grad; the frozen base
weights never do, so no backward pass forms a weight gradient for them.

The cohort-batched classification server step is ported in its ``ragged``
form (cut-grouped concat batches through the grouped LoRA kernel); the
``vmap`` form and the LM batched step come with ROADMAP Queue A, items 6
and 3.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.lora import STACKED_KEYS
from repro_torch.models import layers as L
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


# ---------------------------------------------------------------------------
# ragged cohort packing (impl="ragged" of the batched server step)
# ---------------------------------------------------------------------------

def _chunk_slices(u: int, cohort_chunk: Optional[int]):
    k = u if not cohort_chunk or cohort_chunk <= 0 else min(int(cohort_chunk), u)
    return [slice(lo, min(lo + k, u)) for lo in range(0, u, k)]


def _tree_take(tree: PyTree, idx: torch.Tensor) -> PyTree:
    return tree_map(lambda a: a.index_select(0, idx), tree)


def _tree_concat(parts) -> PyTree:
    if len(parts) == 1:
        return parts[0]
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *parts)


def _cohort_to_layer_major(lora_s: PyTree) -> PyTree:
    """Swap cohort-stacked adapter leaves (G, L, ...) to layer-major
    (L, G, ...), so the sliced path's per-layer indexing hands every
    projection a grouped (G, r, K) adapter — the grouped-kernel dispatch
    contract of ``models.layers.lora_apply``.  Keys outside
    ``STACKED_KEYS`` stay cohort-stacked: their leaves are already
    (G, r, K)."""
    return {key: tree_map(lambda a: a.transpose(0, 1), sub) if key in STACKED_KEYS
            else sub for key, sub in lora_s.items()}


def _flatten_cohort(tree: PyTree) -> PyTree:
    """(G, B, ...) leaves -> (G*B, ...): the ragged concat batch."""
    return tree_map(lambda a: a.reshape((a.shape[0] * a.shape[1],) + tuple(a.shape[2:])),
                    tree)


def _concrete_cuts(cuts) -> np.ndarray:
    try:
        arr = np.asarray(cuts, dtype=np.int64)
    except (TypeError, ValueError, RuntimeError):
        raise ValueError(
            "impl='ragged' groups the cohort by CONCRETE cut values (each "
            "distinct cut runs a static-slice step over only its owned "
            "layers); pass cuts as python ints or numpy") from None
    if arr.ndim != 1:
        raise ValueError(f"cuts must be a 1-D cohort vector, got {arr.shape}")
    return arr


def _ragged_chunks(cuts: np.ndarray, cohort_chunk: Optional[int]):
    """Group lane indices by cut value (stable), split by cohort_chunk.
    Returns (orig_indices, cut) pairs with indices as python int lists."""
    order = np.argsort(cuts, kind="stable")
    chunks = []
    lo = 0
    while lo < len(order):
        hi = lo
        while hi < len(order) and cuts[order[hi]] == cuts[order[lo]]:
            hi += 1
        grp = order[lo:hi].tolist()
        for sl in _chunk_slices(len(grp), cohort_chunk):
            chunks.append((grp[sl], int(cuts[order[lo]])))
        lo = hi
    return chunks


def _make_server_step_ragged(model, opt: AdamW, *,
                             cohort_chunk: Optional[int] = None):
    """impl="ragged" of the batched classification server step: the cohort
    is grouped by cut value and each group runs ONE dispatch over the
    concatenated (G*B, S, d) activation batch — only layers [cut, L) run,
    and every adapted projection sees cohort-grouped (G, r, K) adapters,
    which go to the grouped LoRA kernel when ``cfg.lora.impl == 'fused'``.

    Per-client losses are exact: row segments are computationally
    independent, so the gradient of the sum of per-client mean
    cross-entropies gives each client its own gradients; the AdamW update
    then advances each client's lane of the stacked state.
    """
    cfg = model.cfg

    def group_step(params, lora_g, heads_g, opt_g, v_g, batch_g, cut):
        gsz, bsz = v_g.shape[0], v_g.shape[1]
        trainable = as_trainable({"lora": lora_g, "head": heads_g})
        vf = v_g.reshape((gsz * bsz,) + tuple(v_g.shape[2:])).detach().requires_grad_(True)
        batch_flat = _flatten_cohort(batch_g)
        with torch.enable_grad():
            lo_lm = _cohort_to_layer_major(trainable["lora"])
            h, _ = model.forward_hidden(params, lo_lm, batch_flat, cut=cut,
                                        side="server", x0=vf)
            h = L.apply_norm(cfg, params["final_norm"], h)
            pooled = h.reshape((gsz, bsz) + tuple(h.shape[1:]))[:, :, 0, :]
            logits = torch.einsum("gbd,gdc->gbc", pooled.float(),
                                  trainable["head"])      # per-client heads
            losses = torch.stack([L.softmax_xent(lg[:, None, :], lb[:, None])
                                  for lg, lb in zip(logits, batch_g["label"])])
            g_tr, (g_v,) = tree_grad(losses.sum(), trainable, extra=(vf,))
        new_tr, new_opt = opt.update(g_tr, opt_g, tree_map(torch.Tensor.detach, trainable))
        return (losses.detach(), new_tr["lora"], new_tr["head"], new_opt,
                g_v.reshape(v_g.shape))

    def step(params, lora_s, heads, opt_state, v, batch, cuts):
        cuts_np = _concrete_cuts(cuts)
        outs, perm = [], []
        for idx_list, cut in _ragged_chunks(cuts_np, cohort_chunk):
            idx = torch.as_tensor(idx_list, dtype=torch.long, device=v.device)
            outs.append(group_step(params, _tree_take(lora_s, idx),
                                   heads.index_select(0, idx),
                                   _tree_take(opt_state, idx), v.index_select(0, idx),
                                   _tree_take(batch, idx), cut))
            perm.extend(idx_list)
        inv = torch.as_tensor(np.argsort(np.asarray(perm)), dtype=torch.long,
                              device=v.device)
        return _tree_take(_tree_concat(outs), inv)   # back to cohort order

    return step


def make_server_step_cls_batched(model, opt: AdamW, *,
                                 cohort_chunk: Optional[int] = None,
                                 impl: str = "ragged"):
    """Cohort-batched classification server step (per-client heads train
    alongside the server adapters).

    signature: (params, lora_s, heads, opt_state, v, batch, cuts) ->
               (losses, new_lora_s, new_heads, new_opt_state, dv)

    Every argument after ``params`` carries a leading cohort axis U: the
    per-client full-shape server adapters (``lora.embed_in_full_shape`` +
    ``lora.stack_trees``), heads, stacked optimizer states over
    {"lora", "head"}, activations and batches; ``cuts`` is a vector of U
    python ints.  ``cohort_chunk`` bounds how many clients of one cut
    share a dispatch.  Only ``impl="ragged"`` is ported.
    """
    if impl == "vmap":
        raise NotImplementedError(
            "the vmap cohort step runs the masked-scan path, which the port "
            "does not have yet (ROADMAP Queue A, item 6)")
    if impl != "ragged":
        raise KeyError(f"unknown batched-server impl {impl!r}; "
                       f"choose 'vmap' or 'ragged'")
    return _make_server_step_ragged(model, opt, cohort_chunk=cohort_chunk)


def make_server_step_batched(model, opt: AdamW, *,
                             cohort_chunk: Optional[int] = None,
                             impl: str = "vmap"):
    """The LM cohort-batched server step (no classifier head)."""
    raise NotImplementedError(
        "the LM batched server step needs the LM make_server_step (ROADMAP "
        "Queue A, item 3) and comes with the cohort steps (item 6)")


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
