"""Algorithm 1 — the memory-efficient SFL training step, in PyTorch.  Port
of ``src/repro/core/splitfl.py``.

The three computational pieces of one round:

  client_forward   (Alg.1 l.4, Eq. 3): v_u = f(W_u, R_c^u; x_u)
  server_step      (Alg.1 l.9-11, Eq. 4): resume at the cut on the ONE full
                   model, update R_s^u, emit activation gradients
  client_backward  (Alg.1 l.15): update R_c^u from the activation gradients

Two execution paths, identical semantics (tested against each other):
  * path="sliced": a static cut, a Python loop over the owned layers only —
    what the federated simulator and the client steps run;
  * path="scan":   the masked loop over every layer with the cut as an
    argument of each call (``models.decoder.DecoderModel.scan_forward``) —
    the LM server step's ``path="scan"``, the full train step (which owns
    every layer, so no layer is masked) and, with one cut per row, the
    vmap cohort step.  At a Python int cut it runs the owned layers as the
    sliced loop does, so only a tensor cut pays for the masks.

The cohort-batched server steps run a chunk of clients in one dispatch,
in either of the reference's forms: ``vmap`` concatenates the chunk's
lanes into one batch and runs every layer, each lane masked at its own
cut; ``ragged`` groups the lanes by cut and runs each group's own layers.
Both hand every adapted projection cohort-grouped adapters, which go to
the grouped LoRA kernel when ``cfg.lora.impl == 'fused'``.

Only adapters and the classifier head require grad; the frozen base
weights never do, so no backward pass forms a weight gradient for them.

``CohortAdapterStore`` holds the per-client adapter and optimizer state of
the sampled clients only, materialized from one standing global: the
population trainer's state at fleet scale.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import lora as lora_lib
from repro_torch.core.lora import STACKED_KEYS
from repro_torch.models import layers as L
from repro_torch.obs import wall
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any


def as_trainable(tree: PyTree) -> PyTree:
    """Fresh autograd leaves holding the same values."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _detached(tree: PyTree) -> PyTree:
    return tree_map(torch.Tensor.detach, tree)


def tree_grad(out: torch.Tensor, tree: PyTree, extra=(), grad_out=None,
              retain_graph: bool = False):
    """Gradients of ``out`` (weighted by ``grad_out``) with respect to the
    leaves of ``tree`` and to the tensors in ``extra``: (grad tree, extras).
    Leaves ``out`` does not reach get zeros, as under ``jax.grad``."""
    leaves = tree_leaves(tree)
    gs = torch.autograd.grad(out, leaves + list(extra), grad_outputs=grad_out,
                             retain_graph=retain_graph, materialize_grads=True)
    return tree_unflatten(tree, list(gs[:len(leaves)])), gs[len(leaves):]


def client_forward(model, params_c: PyTree, lora_c: PyTree, batch: dict,
                   cut: int):
    """Eq. 3. ``params_c``/``lora_c`` hold only the client's prefix (their
    stacked leaves have leading dim == cut)."""
    v, _ = model.forward_hidden(params_c, lora_c, batch, cut=cut, side="client")
    return v


def server_loss(model, params: PyTree, lora_s: PyTree, v: torch.Tensor,
                batch: dict, cut, *, path: str = "sliced", remat: bool = False):
    """Eq. 4 + loss: resume the full model at the cut with R_s^u."""
    return model.loss(params, lora_s, batch, cut=cut, side="server", path=path, x0=v,
                      remat=remat)


def _server_grads(model, params, trainable, v, batch, cut, path, with_head,
                  remat: bool = False):
    """The server's loss and its gradients with respect to the trainable
    tree ({"lora", "head"} or the bare adapters) and to ``v``."""
    tr = as_trainable(trainable)
    vv = v.detach().requires_grad_(True)
    with torch.enable_grad():
        pp = params
        if with_head:
            pp = dict(params)
            pp["cls_head"] = tr["head"]
        with wall.span("forward"):
            loss, _ = server_loss(model, pp, tr["lora"] if with_head else tr, vv, batch, cut,
                                  path=path, remat=remat)
        with wall.span("backward"):
            g_tr, (g_v,) = tree_grad(loss, tr, extra=(vv,))
    return loss.detach(), g_tr, g_v


def make_server_step(model, opt: AdamW, *, path: str = "sliced",
                     static_cut: Optional[int] = None, remat: bool = False):
    """The LM server step.

    signature: (params, lora_s, opt_state, v, batch, cut) ->
               (loss, new_lora_s, new_opt_state, dv)
    without ``cut`` when ``static_cut`` fixes it.  With path='scan' the cut
    may change from call to call (an int, or a 0-d tensor on the device),
    and every call runs the same masked loop over all layers, each layer
    recomputed in the backward under ``remat`` (the sliced path ignores
    it, as the reference's does)."""
    def step(params, lora_s, opt_state, v, batch, cut=static_cut):
        with wall.span("server_step"):
            loss, g_lora, g_v = _server_grads(model, params, lora_s, v, batch, cut, path,
                                              with_head=False, remat=remat)
            with wall.span("optimizer"):
                new_lora, new_opt = opt.update(g_lora, opt_state, _detached(lora_s))
        return loss, new_lora, new_opt, g_v

    return step


def make_server_step_cls(model, opt: AdamW, *, static_cut: int):
    """Server step for classification fine-tuning: the classifier head
    trains alongside the server-side adapters.

    signature: (params, lora_s, head, opt_state, v, batch) ->
               (loss, new_lora_s, new_head, new_opt_state, dv)
    where opt_state is over the tree {"lora": ..., "head": ...} and ``dv`` is
    the gradient of the loss with respect to the received activations ``v``.
    """
    def step(params, lora_s, head, opt_state, v, batch):
        trainable = {"lora": lora_s, "head": head}
        loss, g_tr, g_v = _server_grads(model, params, trainable, v, batch, static_cut,
                                        "sliced", with_head=True)
        new_tr, new_opt = opt.update(g_tr, opt_state, _detached(trainable))
        return loss, new_tr["lora"], new_tr["head"], new_opt, g_v

    return step


# ---------------------------------------------------------------------------
# cohort packing (the batched server steps)
# ---------------------------------------------------------------------------

def _chunk_slices(u: int, cohort_chunk: Optional[int]):
    k = u if not cohort_chunk or cohort_chunk <= 0 else min(int(cohort_chunk), u)
    return [slice(lo, min(lo + k, u)) for lo in range(0, u, k)]


def _tree_slice(tree: PyTree, sl: slice) -> PyTree:
    return tree_map(lambda a: a[sl], tree)


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


def _make_group_step(model, opt: AdamW, *, with_head: bool, path: str):
    """ONE dispatch over a group of G lanes: their (G, B, S, d) activations
    concatenate into one (G*B, S, d) batch and the stacked (G, L, ...)
    adapters go layer-major, so every adapted projection sees a
    cohort-grouped (G, r, K) adapter — one grouped LoRA launch over all G
    lanes.  ``path="sliced"`` (ragged: one cut for the group) runs only
    layers [cut, L); ``path="scan"`` (vmap: a cut per lane) runs every layer
    and masks each lane's rows at its own cut.

    Per-lane losses are exact where the lanes' rows are computationally
    independent: attention, the MLPs and the grouped projections never mix
    rows, so the gradient of the sum of the lanes' losses gives each lane
    its own gradients and ``dv``, and the AdamW update then advances each
    lane of the stacked state by its own update.  The MoE dispatch does mix
    the tokens it is given (one capacity, sort and router aux over them),
    so the two paths keep the reference's two semantics: on the scan path
    each lane is its own dispatch group (``moe_groups=G`` over the
    lane-major rows) with its own aux, masked at its own cut, as each lane
    of the reference's ``jax.vmap`` runs alone; on the sliced path the
    group's lanes share one dispatch, and the sliced path reports no aux,
    as the reference's ragged step does."""
    cfg = model.cfg

    def group_step(params, lora_g, heads_g, opt_g, v_g, batch_g, cut):
        gsz, bsz = v_g.shape[0], v_g.shape[1]
        trainable = {"lora": lora_g, "head": heads_g} if with_head else lora_g
        tr = as_trainable(trainable)
        vf = v_g.reshape((gsz * bsz,) + tuple(v_g.shape[2:])).detach().requires_grad_(True)
        batch_flat = _flatten_cohort(batch_g)
        ctx = model.make_ctx(vf.shape[1], vf.device, moe_groups=gsz) if path == "scan" \
            else None
        with torch.enable_grad():
            lo_lm = _cohort_to_layer_major(tr["lora"] if with_head else tr)
            h, aux = model.forward_hidden(params, lo_lm, batch_flat, cut=cut,
                                          side="server", path=path, x0=vf, ctx=ctx)
            if with_head:
                h = L.apply_norm(cfg, params["final_norm"], h)
                pooled = h.reshape((gsz, bsz) + tuple(h.shape[1:]))[:, :, 0, :]
                logits = torch.einsum("gbd,gdc->gbc", pooled.float(),
                                      tr["head"])            # per-client heads
                losses = torch.stack([L.softmax_xent(lg[:, None, :], lb[:, None])
                                      for lg, lb in zip(logits, batch_g["label"])])
            else:
                logits = model.lm_logits(params, h, batch_flat["targets"])
                logits = logits.reshape((gsz, bsz) + tuple(logits.shape[1:]))
                losses = torch.stack([L.softmax_xent(lg, tg)
                                      for lg, tg in zip(logits, batch_g["targets"])])
            if aux.dim():                     # per row: each lane's own
                losses = losses + aux.reshape(gsz, bsz)[:, 0]
            else:
                losses = losses + aux
            g_tr, (g_v,) = tree_grad(losses.sum(), tr, extra=(vf,))
        new_tr, new_opt = opt.update(g_tr, opt_g, _detached(tr))
        dv = g_v.reshape(v_g.shape)
        if with_head:
            return losses.detach(), new_tr["lora"], new_tr["head"], new_opt, dv
        return losses.detach(), new_tr, new_opt, dv

    return group_step


def _split_args(with_head: bool, rest):
    if with_head:
        heads, opt_state, v, batch, cuts = rest
        return heads, opt_state, v, batch, cuts
    opt_state, v, batch, cuts = rest
    return None, opt_state, v, batch, cuts


def _make_server_step_ragged(model, opt: AdamW, *,
                             cohort_chunk: Optional[int] = None,
                             with_head: bool = False):
    """impl="ragged" of the batched server steps: the cohort is grouped by
    cut value, split by ``cohort_chunk``, and each group runs ONE dispatch
    (``_make_group_step`` on the sliced path: only layers [cut, L)).  Known
    deltas against the vmap impl, as in the reference: the sliced path
    reports no aux loss, and an MoE layer's capacity spans the group's
    lanes."""
    group_step = _make_group_step(model, opt, with_head=with_head, path="sliced")

    def step(params, lora_s, *rest):
        heads, opt_state, v, batch, cuts = _split_args(with_head, rest)
        cuts_np = _concrete_cuts(cuts)
        outs, perm = [], []
        for idx_list, cut in _ragged_chunks(cuts_np, cohort_chunk):
            idx = torch.as_tensor(idx_list, dtype=torch.long, device=v.device)
            outs.append(group_step(params, _tree_take(lora_s, idx),
                                   heads.index_select(0, idx) if with_head else None,
                                   _tree_take(opt_state, idx), v.index_select(0, idx),
                                   _tree_take(batch, idx), cut))
            perm.extend(idx_list)
        inv = torch.as_tensor(np.argsort(np.asarray(perm)), dtype=torch.long,
                              device=v.device)
        return _tree_take(_tree_concat(outs), inv)   # back to cohort order

    return step


def _make_server_step_vmap(model, opt: AdamW, *,
                           cohort_chunk: Optional[int] = None,
                           with_head: bool = False):
    """impl="vmap" of the batched server steps: the cohort splits into
    chunks of ``cohort_chunk`` lanes in order (``_chunk_slices``), and each
    chunk runs ONE dispatch (``_make_group_step`` on the masked path): all
    L layers for every lane, each lane's rows masked at its own cut, which
    is one cut per row.  This is the reference's ``jax.vmap`` of the scan
    step over the chunk's lanes; the padded work below each lane's cut is
    the reference's stated trade-off against ``ragged``."""
    group_step = _make_group_step(model, opt, with_head=with_head, path="scan")

    def step(params, lora_s, *rest):
        heads, opt_state, v, batch, cuts = _split_args(with_head, rest)
        cuts = torch.as_tensor(cuts, dtype=torch.long).to(v.device)
        if cuts.dim() != 1 or cuts.shape[0] != v.shape[0]:
            raise ValueError(f"cuts must be one per lane, got shape {tuple(cuts.shape)} "
                             f"for {v.shape[0]} lanes")
        bsz = v.shape[1]
        outs = [group_step(params, _tree_slice(lora_s, sl),
                           heads[sl] if with_head else None, _tree_slice(opt_state, sl),
                           v[sl], _tree_slice(batch, sl),
                           cuts[sl].repeat_interleave(bsz))
                for sl in _chunk_slices(int(cuts.shape[0]), cohort_chunk)]
        return _tree_concat(outs)

    return step


_BATCHED_IMPLS = {"vmap": _make_server_step_vmap, "ragged": _make_server_step_ragged}


def _batched(model, opt, cohort_chunk, impl, with_head):
    if impl not in _BATCHED_IMPLS:
        raise KeyError(f"unknown batched-server impl {impl!r}; "
                       f"choose 'vmap' or 'ragged'")
    return _BATCHED_IMPLS[impl](model, opt, cohort_chunk=cohort_chunk, with_head=with_head)


def make_server_step_batched(model, opt: AdamW, *,
                             cohort_chunk: Optional[int] = None,
                             impl: str = "vmap"):
    """Cohort-batched LM server step: a chunk of clients advances in ONE
    dispatch instead of U sequential ones.

    signature: (params, lora_s, opt_state, v, batch, cuts) ->
               (losses, new_lora_s, new_opt_state, dv)

    Every argument after ``params`` carries a leading cohort axis U: the
    per-client full-shape server adapters (``lora.embed_in_full_shape`` +
    ``lora.stack_trees``), stacked optimizer states, activations and
    batches; ``cuts`` holds one cut per client (Python ints, numpy, or a
    tensor).  ``cohort_chunk`` bounds how many clients share a dispatch —
    the paper's sequential server is ``cohort_chunk=1``.  ``impl`` selects
    the execution path (EngineConfig.cohort_impl):

      * "vmap" (default): chunks in cohort order; every lane runs all L
        layers masked at its own cut (:func:`_make_server_step_vmap`);
      * "ragged": cut-grouped chunks; each group runs only its own [cut, L)
        suffix (:func:`_make_server_step_ragged`).
    """
    return _batched(model, opt, cohort_chunk, impl, with_head=False)


def make_server_step_cls_batched(model, opt: AdamW, *,
                                 cohort_chunk: Optional[int] = None,
                                 impl: str = "vmap"):
    """Cohort-batched classification server step (per-client heads train
    alongside the server adapters).

    signature: (params, lora_s, heads, opt_state, v, batch, cuts) ->
               (losses, new_lora_s, new_heads, new_opt_state, dv)
    with the conventions of :func:`make_server_step_batched`; ``opt_state``
    is over the stacked tree {"lora": ..., "head": ...}.
    """
    return _batched(model, opt, cohort_chunk, impl, with_head=True)


@dataclasses.dataclass
class ClientTape:
    """What the client keeps between its forward and its backward: the
    activations with their autograd graph, and the adapter leaves the graph
    starts from.  The backward reuses this graph instead of recomputing the
    forward (the reference recomputes it inside ``bwd``; the values agree)."""
    v: torch.Tensor
    lora: PyTree


def client_vjp(tape: ClientTape, dv: torch.Tensor, retain_graph: bool = False) -> PyTree:
    """Gradients of the client's adapters given the activation gradient
    ``dv`` (the pullback of ``client_forward_with_vjp``)."""
    g, _ = tree_grad(tape.v, tape.lora, grad_out=dv, retain_graph=retain_graph)
    return g


def _client_tape(model, params_c, lora_c, batch, cut) -> ClientTape:
    lc = as_trainable(lora_c)
    with torch.enable_grad():
        v = client_forward(model, params_c, lc, batch, cut)
    return ClientTape(v, lc)


def client_forward_with_vjp(model, params_c: PyTree, lora_c: PyTree,
                            batch: dict, cut: int):
    """Returns (v, vjp_fn) where vjp_fn(dv) -> grads w.r.t. lora_c; like
    the reference's pullback it may be called more than once."""
    tape = _client_tape(model, params_c, lora_c, batch, cut)
    return tape.v.detach(), lambda dv: client_vjp(tape, dv, retain_graph=True)


def make_client_step(model, opt: AdamW, cut: int):
    """The client fwd+bwd pair for a fixed (static) cut.

    forward:  (params_c, lora_c, batch)  -> (v, tape)
    backward: (tape, opt_state, dv)      -> (new_lora_c, new_opt)
    """
    def fwd(params_c, lora_c, batch):
        tape = _client_tape(model, params_c, lora_c, batch, cut)
        return tape.v.detach(), tape

    def bwd(tape: ClientTape, opt_state, dv):
        return opt.update(client_vjp(tape, dv), opt_state, _detached(tape.lora))

    return fwd, bwd


def make_full_train_step(model, opt: AdamW, *, remat: bool = False, path: str = "scan"):
    """Centralized LoRA fine-tuning step (the cut-0 oracle and the central
    training mode of ``launch/train.py``).  Side "full" owns every layer,
    so ``path="scan"`` runs the sliced loop's operations, adds each
    block's aux loss and honours ``remat``; ``path="sliced"`` ignores
    ``remat``, as the reference's sliced path does.

    signature: (params, lora, opt_state, batch) -> (loss, lora, opt_state)
    """
    def step(params, lora, opt_state, batch):
        lo = as_trainable(lora)
        with torch.enable_grad():
            loss, _ = model.loss(params, lo, batch, cut=0, side="full", path=path,
                                 remat=remat)
            g, _ = tree_grad(loss, lo)
        new_lora, new_opt = opt.update(g, opt_state, _detached(lo))
        return loss.detach(), new_lora, new_opt

    return step


class CohortAdapterStore:
    """Cohort-indexed per-client adapter + optimizer state for population-
    scale federation: only the SAMPLED clients ever hold materialized
    trees.

    The per-object ``Simulator`` eagerly builds every client's
    ``(client_lora, client_opt, server_lora, head, server_opt)`` tuple at
    init and re-builds ALL of them from the aggregated global at each sync
    commit.  At 10^4 clients that is the memory wall this store removes:
    it keeps ONE standing global ``(full adapter, head)`` plus a dict of
    slots for the clients a cohort actually touched, and materializes a
    slot on first use from a per-cut TEMPLATE cache —

        client_lora = split_lora(global_full, cut)[0]
        server_lora = embed_in_full_shape(split[1], spec, cut, "server")
        opt states  = opt.init(...) on those trees

    ``split_lora`` slices and ``embed_in_full_shape`` copies into zeros,
    and ``opt.init`` is deterministic, so a materialized slot holds the
    values the eager Simulator holds for an untouched client, bit for
    bit.  Distinct cuts share one template; slots are shallow copies, so
    untouched trees alias until a training step replaces them (every step
    returns new tensors: nothing is written through).

    Two global-update modes mirror the two commit families:
      * ``reset_global``  (sync barrier): every client re-enters from the
        new global -> drop ALL slots and caches;
      * ``set_global``    (async): non-contributors keep training on their
        in-flight state -> keep slots, invalidate only the fresh-view
        caches; callers re-materialize the contributors via ``drop``.
    """

    def __init__(self, lora_spec, opt: AdamW, global_full, global_head, cut_of):
        self.lora_spec = lora_spec
        self.opt = opt
        self.global_full = global_full
        self.global_head = global_head
        self._cut_of = cut_of            # uid -> cut
        self._slots: dict = {}           # uid -> slot dict
        self._templates: dict = {}       # cut -> template slot
        self._views: dict = {}           # cut -> (client_view, server_split)
        self._slot_nbytes: dict = {}     # cut -> bytes one slot holds

    # ----------------------------------------------------------- materialize
    def _template(self, cut: int) -> dict:
        tpl = self._templates.get(cut)
        if tpl is None:
            c, s = lora_lib.split_lora(self.global_full, cut)
            full_shape = lora_lib.embed_in_full_shape(s, self.lora_spec, cut, "server")
            tpl = {
                "client_lora": c,
                "client_opt": self.opt.init(c),
                "server_lora": full_shape,
                "head": self.global_head,
                "server_opt": self.opt.init({"lora": full_shape,
                                             "head": self.global_head}),
            }
            self._templates[cut] = tpl
        return tpl

    def materialize(self, u: int) -> dict:
        """The slot for client ``u``, built from the standing global on
        first touch (shallow copy of the cut's template)."""
        u = int(u)
        slot = self._slots.get(u)
        if slot is None:
            slot = dict(self._template(int(self._cut_of(u))))
            self._slots[u] = slot
        return slot

    def slot(self, u: int) -> dict:
        return self._slots[int(u)]

    def peek(self, u: int):
        """The slot if materialized, else None (no side effects)."""
        return self._slots.get(int(u))

    def touched(self):
        """Materialized uids, ascending."""
        return sorted(self._slots)

    def fresh_views(self, cut: int):
        """``(client_view, server_split_view)`` of the standing global at
        ``cut`` — what an untouched client's state looks like, shared
        across every absent client at that cut (cached slices, no
        per-client copies)."""
        pr = self._views.get(cut)
        if pr is None:
            pr = lora_lib.split_lora(self.global_full, cut)
            self._views[cut] = pr
        return pr

    # ---------------------------------------------------------- global swaps
    def drop(self, u: int) -> None:
        self._slots.pop(int(u), None)

    def set_global(self, full, head) -> None:
        """Async commit: new standing global; in-flight slots survive."""
        self.global_full = full
        self.global_head = head
        self._templates.clear()
        self._views.clear()

    def reset_global(self, full, head) -> None:
        """Sync barrier commit: new global, every slot re-enters fresh."""
        self.set_global(full, head)
        self._slots.clear()

    # ------------------------------------------------------------ accounting
    def slot_nbytes(self, cut: int) -> float:
        """Bytes one materialized slot at ``cut`` holds (adapters + heads +
        optimizer state), counted on the template's leaves."""
        nb = self._slot_nbytes.get(cut)
        if nb is None:
            tpl = self._template(cut)
            nb = float(sum(leaf.numel() * leaf.element_size()
                           for leaf in tree_leaves(tpl)))
            self._slot_nbytes[cut] = nb
        return nb

    def resident_nbytes(self) -> float:
        """Bytes all currently materialized slots hold — the cohort-resident
        figure the obs ledger prices per round."""
        return float(sum(self.slot_nbytes(int(self._cut_of(u)))
                         for u in self._slots))
