"""LoRA adapter management for the split-federated framework.  Port of
``src/repro/core/lora.py``.

Adapters live in *stacked* trees whose leading axis is the layer index, so
the split at a cut point (Eq. 9) is a slice along axis 0 and re-assembly
(Eq. 5) is a concat — exact and loss-free for heterogeneous cuts.  Every
function returns new tensors or views and never writes into its inputs.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

# keys (per model family) holding layer-stacked, cut-splittable adapters
STACKED_KEYS = ("layers", "enc_layers")
# keys holding server-resident, non-splittable adapters: the hybrid's
# shared attention block and the encoder-decoder's decoder
SERVER_ONLY_KEYS = ("shared", "dec_layers")


def split_lora(lora: PyTree, cut: int) -> Tuple[PyTree, PyTree]:
    """Eq. 9: R_i -> (R_c [layers < cut], R_s [layers >= cut]).

    The client part contains only the stacked prefix; the server part keeps
    the full structure (server-only subtrees stay with the server).
    """
    client, server = {}, {}
    for key, sub in lora.items():
        if key in STACKED_KEYS:
            client[key] = tree_map(lambda a: a[:cut], sub)
            server[key] = tree_map(lambda a: a[cut:], sub)
        else:
            server[key] = sub
    return client, server


def assemble_full(client: PyTree, server: PyTree, cut: int) -> PyTree:
    """Eq. 5: R_f^u = {R_c^u, R_s^u} — concat stacked parts at the cut."""
    full = {}
    for key, sub in server.items():
        if key in STACKED_KEYS:
            full[key] = tree_map(lambda c, s: torch.cat([c, s], dim=0),
                                 client[key], sub)
        else:
            full[key] = sub
    return full


def embed_in_full_shape(part: PyTree, full_spec: PyTree, cut: int,
                        side: str) -> PyTree:
    """Place a split part back into a full-length zero tree (the execution
    engine always indexes adapters by absolute layer id).  ``full_spec``'s
    leaves give each full leaf's shape, dtype and device."""
    out = {}
    for key, spec_sub in full_spec.items():
        if key in STACKED_KEYS:
            if key not in part:
                out[key] = tree_map(torch.zeros_like, spec_sub)
                continue

            def place(z, p):
                n = p.shape[0]
                lo = 0 if side == "client" else cut
                head = z.new_zeros((lo,) + tuple(z.shape[1:]))
                tail = z.new_zeros((z.shape[0] - lo - n,) + tuple(z.shape[1:]))
                return torch.cat([head, p.to(z.dtype), tail], dim=0)

            out[key] = tree_map(place, spec_sub, part[key])
        else:
            out[key] = part[key] if key in part else tree_map(torch.zeros_like,
                                                             spec_sub)
    return out


def adapter_list(lora: PyTree):
    """Depth-ordered flat list of (path, A, B) pairs — the paper's
    {A_1,B_1,...,A_N,B_N} view. N = len(result)."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            if set(node.keys()) == {"a", "b"}:
                out.append(("/".join(path), node["a"], node["b"]))
            else:
                for k in sorted(node.keys()):
                    walk(node[k], path + [k])

    walk(lora, [])
    return out


def count_adapters(lora: PyTree) -> int:
    n = 0
    for _, a, _b in adapter_list(lora):
        n += a.shape[0] if a.dim() == 3 else 1   # stacked (L, r, in)
    return n


def adapter_bytes(lora: PyTree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(lora))


def merge_lora(params: PyTree, lora: PyTree, scale: float) -> PyTree:
    """W' = W + scale * B A for every adapted weight (Eq. 1) — used for
    export / merged-inference equivalence tests."""
    def merge_into(pnode, lnode):
        if not isinstance(lnode, dict):
            return pnode
        out = dict(pnode)
        for key, lsub in lnode.items():
            if key not in pnode:
                continue
            if isinstance(lsub, dict) and set(lsub.keys()) == {"a", "b"}:
                w = pnode[key]
                a, b = lsub["a"], lsub["b"]
                if a.dim() == 3:   # stacked (L, r, in) x (L, out, r)
                    delta = torch.einsum("lor,lri->lio", b, a)
                else:
                    delta = torch.einsum("or,ri->io", b, a)
                out[key] = (w.float() + scale * delta).to(w.dtype)
            elif isinstance(lsub, dict):
                out[key] = merge_into(pnode[key], lsub)
        return out

    return merge_into(params, lora)


def zeros_like_lora(lora: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, lora)


def stack_trees(trees: Sequence[PyTree]) -> PyTree:
    """Stack same-structure trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def unstack_tree(tree: PyTree) -> list:
    """Inverse of :func:`stack_trees`: split the leading axis back into a
    list of trees."""
    n = tree_leaves(tree)[0].shape[0]
    return [tree_map(lambda a, i=i: a[i], tree) for i in range(n)]


def slice_stack(tree: PyTree, lo: int, hi: int) -> PyTree:
    return tree_map(lambda a: a[lo:hi], tree)
