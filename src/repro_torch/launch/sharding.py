"""The sharding plan: megatron-style tensor parallelism over "model", the
batch over ("pod", "data"), optional FSDP weight sharding and sequence
sharding.  Port of ``src/repro/launch/sharding.py``.

The rules are the reference's, path-pattern driven over the parameter
trees of ``repro_torch.models``; dimensions index from the END of each
leaf's shape, so one rule covers stacked (L, ...) and unstacked leaves.
Each leaf gets a :class:`Placement`: the mesh and the spec, a tuple that
holds for each dimension what the reference's ``NamedSharding.spec``
holds for the same mesh sizes (an axis name, a tuple of them, or None).
Specs can be asked of any ``Mesh.abstract``; the port runs on the one-card
mesh, where every placement is that card.  No step of the port reads the
specs: they are kept for parity with the reference's API, and the tests
hold them equal to the reference's ``NamedSharding.spec`` trees.  Of the
policy's fields only ``moe_shard_map`` and ``microbatch`` change a step.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh, dp_axes

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = False            # additionally shard weights over "data"
    seq_shard: bool = False       # shard the seq dim of hidden states over "model"
    shard_vocab_embed: bool = True
    shard_lora: bool = False      # adapters are tiny; replicate by default
    moe_shard_map: bool = False   # shard_map MoE: local dispatch + combine-then-reduce
    microbatch: int = 1           # gradient-accumulation steps (peak-memory /k)


@dataclasses.dataclass(frozen=True)
class Placement:
    mesh: Mesh
    spec: tuple

    @property
    def device(self) -> torch.device:
        """Where the leaf lives: on the one-card mesh, its card."""
        return self.mesh.device


# (pattern, kind) — kind: "col" (shard last dim), "row" (shard dim -2),
# "vocab" (embedding), "rep" (replicate). First match wins.
_RULES = [
    ("*/cm/wk", "col"), ("*/cm/wv", "row"), ("*/cm/wr", "col"),
    ("*/tm/wr", "col"), ("*/tm/wk", "col"), ("*/tm/wv", "col"),
    ("*/tm/wg", "col"), ("*/tm/wo", "row"), ("*/tm/*", "rep"),
    ("*/cm/*", "rep"),
    ("*wr_router", "rep"),
    ("*/experts/we_u", "col"), ("*/experts/we_g", "col"),
    ("*/experts/we_d", "row"),
    ("*/attn/wq", "col"), ("*/attn/wk", "col"), ("*/attn/wv", "col"),
    ("*/attn/bq", "col"), ("*/attn/bk", "col"), ("*/attn/bv", "col"),
    ("*/attn/wo", "row"),
    ("*/xattn/wq", "col"), ("*/xattn/wk", "col"), ("*/xattn/wv", "col"),
    ("*/xattn/bq", "col"), ("*/xattn/bk", "col"), ("*/xattn/bv", "col"),
    ("*/xattn/wo", "row"),
    ("*/mlp/wu", "col"), ("*/mlp/wg", "col"), ("*/mlp/wd", "row"),
    ("*in_proj", "col"), ("*out_proj", "row"),
    ("embed", "vocab"), ("head", "col"), ("cls_head", "rep"),
    ("pos_embed", "rep"), ("enc_pos", "rep"), ("proj", "rep"),
]


def _map_with_path(fn: Callable, tree: PyTree, path: tuple = ()) -> PyTree:
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (named ones
    keep their type); a path is the dict keys and sequence indices."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(path, tree)


def _replicated(mesh: Mesh, leaf) -> Placement:
    return Placement(mesh, (None,) * leaf.dim())


def _spec_for(kind: str, ndim: int, policy: ShardingPolicy,
              divisible_last: bool, divisible_row: bool) -> tuple:
    none = [None] * ndim
    if kind == "rep" or ndim < 2:
        return tuple(none)
    fs = "data" if policy.fsdp else None
    if kind == "col":
        spec = list(none)
        if divisible_last:
            spec[-1] = "model"
            spec[-2] = fs
        return tuple(spec)
    if kind == "row":
        spec = list(none)
        if divisible_row:
            spec[-2] = "model"
            spec[-1] = fs
        return tuple(spec)
    if kind == "vocab":
        spec = list(none)
        spec[0] = "model" if policy.shard_vocab_embed else None
        spec[1] = fs
        return tuple(spec)
    raise ValueError(kind)


def param_shardings(cfg: ModelConfig, params_spec: PyTree, mesh: Mesh,
                    policy: ShardingPolicy = ShardingPolicy()) -> PyTree:
    nmodel = mesh.shape.get("model", 1)
    ndata = mesh.shape.get("data", 1)

    def assign(path, leaf):
        ps = "/".join(str(p) for p in path)
        shape, ndim = leaf.shape, leaf.dim()
        kind = "rep"
        for pattern, k in _RULES:
            if fnmatch.fnmatch(ps, pattern) or ps == pattern.lstrip("*/"):
                kind = k
                break
        if ndim < 2:
            kind = "rep"
        div_last = ndim >= 1 and shape[-1] % nmodel == 0
        div_row = ndim >= 2 and shape[-2] % nmodel == 0
        if policy.fsdp:
            # the FSDP dim must divide too, else the rule falls back (the
            # reference's order of fall-backs, rule for rule)
            if kind == "col" and shape[-2] % ndata != 0:
                return Placement(mesh, _spec_for(kind, ndim, ShardingPolicy(fsdp=False),
                                                 div_last, div_row))
            if kind == "row" and shape[-1] % ndata != 0:
                return Placement(mesh, _spec_for(kind, ndim, ShardingPolicy(fsdp=False),
                                                 div_last, div_row))
            if kind == "vocab" and (shape[0] % nmodel or shape[1] % ndata):
                return _replicated(mesh, leaf)
        if kind == "vocab" and shape[0] % nmodel:
            kind = "rep"
        return Placement(mesh, _spec_for(kind, ndim, policy, div_last, div_row))

    return _map_with_path(assign, params_spec)


def lora_shardings(lora_spec: PyTree, mesh: Mesh,
                   policy: ShardingPolicy = ShardingPolicy()) -> PyTree:
    # adapters are O(r x m): replicate (they are the paper's "switchable" state)
    return _map_with_path(lambda _, leaf: _replicated(mesh, leaf), lora_spec)


def batch_shardings(specs: dict, mesh: Mesh) -> dict:
    """Input batch: shard the batch dim over the dp axes when divisible."""
    dp = dp_axes(mesh)
    dp_total = math.prod(mesh.shape[a] for a in dp)
    dp_entry = dp[0] if len(dp) == 1 else dp    # as PartitionSpec stores one axis

    def assign_leaf(leaf, batch_dim: int) -> Placement:
        spec = [None] * leaf.dim()
        if leaf.dim() > batch_dim and leaf.shape[batch_dim] % dp_total == 0:
            spec[batch_dim] = dp_entry
        return Placement(mesh, tuple(spec))

    out = {}
    for key, val in specs.items():
        if key == "cache":
            out[key] = _map_with_path(lambda _, leaf: assign_leaf(leaf, 1), val)
        elif key == "pos":
            out[key] = Placement(mesh, ())
        else:
            out[key] = _map_with_path(lambda _, leaf: assign_leaf(leaf, 0), val)
    return out

