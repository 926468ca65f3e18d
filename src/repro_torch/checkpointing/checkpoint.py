"""Tree checkpointing on the standard library, numpy and torch.  Port of
``src/repro/checkpointing/checkpoint.py`` with a file format of its own
(no msgpack, no zstandard, no pickle on either side).

A tree is nested dicts, lists and tuples (named tuples such as optimizer
states are written as tuples) whose leaves are torch tensors, numpy arrays
or Python scalars.  Structure becomes path keys (``_flatten``: dict keys
sorted, tuple items ``T<i>``, list items ``L<i>``, joined by ``\\x1f``), as
in the reference.  One file holds:

    8 bytes   magic ``b"RTCKPT1\\n"``
    8 bytes   header length H, little-endian unsigned
    H bytes   JSON header: ``{"leaves": {key: {"kind": "torch" | "numpy",
              "dtype": ..., "shape": [...], "offset": ..., "nbytes": ...}},
              "empty": {key: "dict" | "list" | "tuple"}}``
    the leaves' raw bytes, each at its offset (from the end of the header,
    64-byte aligned), C order, native little-endian

A torch leaf's dtype is its torch name (``"bfloat16"`` is stored through
its 16-bit integer view); a numpy leaf's is numpy's.  ``load`` gives a
torch leaf back as a contiguous tensor of its own storage on the requested
device, a numpy leaf as numpy (64-bit values are never narrowed), and an
empty dict, list or tuple as itself.  ``save`` writes ``path + ".tmp"``
and renames it over ``path``, so a reader never sees a half-written file.

Non-array state (event heaps, RNG stream positions, commit logs — the
discrete-event side of a mid-flight snapshot) rides the same format as a
JSON blob packed into a uint8 leaf: ``pack_json`` / ``unpack_json``.
CPython's JSON float repr round-trips bit-exactly, so the DES timeline
survives a save/load unchanged.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

PyTree = Any
_SEP = "\x1f"   # unit separator: never appears in our dict keys
MAGIC = b"RTCKPT1\n"
_ALIGN = 64
# torch dtypes without a numpy twin travel through an integer view of
# the same width
_VIEWS = {torch.bfloat16: torch.int16}


def pack_json(obj: Any) -> np.ndarray:
    """Encode a JSON-able object as a uint8 ndarray leaf.

    Floats round-trip bit-exactly (CPython ``repr`` is shortest-exact and
    ``json`` uses it); NaN/Infinity use the Python-extended literals, which
    ``unpack_json`` reads back.  Use for discrete-event/bookkeeping state
    that must live inside an array-leaf pytree checkpoint.

    >>> int(unpack_json(pack_json({"t": 1.5}))["t"] * 2)
    3
    """
    return np.frombuffer(json.dumps(obj).encode("utf-8"), np.uint8).copy()


def unpack_json(arr: Any) -> Any:
    """Inverse of :func:`pack_json`."""
    return json.loads(np.asarray(arr).tobytes().decode("utf-8"))


def _flatten(tree: PyTree):
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node.keys()):
                walk(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            tag = "T" if isinstance(node, tuple) else "L"
            for i, v in enumerate(node):
                walk(v, path + [f"{tag}{i}"])
        else:
            # torch leaves stay tensors (the writer moves them to the host)
            flat[_SEP.join(path)] = (node if isinstance(node, torch.Tensor)
                                     else np.asarray(node))

    walk(tree, [])
    return flat


def _unflatten(flat: dict) -> PyTree:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k[0] in "TL" and k[1:].isdigit() for k in keys):
            seq = [rebuild(node[k]) for k in sorted(keys, key=lambda s: int(s[1:]))]
            return tuple(seq) if keys[0][0] == "T" else seq
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _empties(tree: PyTree) -> dict:
    """Path key -> container kind of every empty dict, list or tuple, which
    ``_flatten`` (like the reference's) has no leaf to record."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            if not node:
                out[_SEP.join(path)] = "dict"
            for k in sorted(node.keys()):
                walk(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            tag = "T" if isinstance(node, tuple) else "L"
            if not node:
                out[_SEP.join(path)] = "tuple" if tag == "T" else "list"
            for i, v in enumerate(node):
                walk(v, path + [f"{tag}{i}"])

    walk(tree, [])
    return out


def _host_bytes(leaf) -> tuple:
    """(kind, dtype name, shape, raw bytes) of one leaf.  A tensor is copied
    to the host here and only here: the caller's tensor is not touched."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype in _VIEWS:
            t = t.view(_VIEWS[t.dtype])
        arr = t.cpu().contiguous().numpy()
        return "torch", name, list(leaf.shape), arr.tobytes()
    arr = np.asarray(leaf)
    return "numpy", arr.dtype.str, list(arr.shape), arr.tobytes()


def save(path: str, tree: PyTree) -> None:
    leaves, blobs, offset = {}, [], 0
    for key, leaf in _flatten(tree).items():
        kind, dtype, shape, raw = _host_bytes(leaf)
        leaves[key] = {"kind": kind, "dtype": dtype, "shape": shape,
                       "offset": offset, "nbytes": len(raw)}
        pad = -len(raw) % _ALIGN
        blobs += [raw, b"\0" * pad]
        offset += len(raw) + pad
    header = json.dumps({"leaves": leaves, "empty": _empties(tree)}).encode("utf-8")
    header += b" " * (-(len(MAGIC) + 8 + len(header)) % _ALIGN)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC + struct.pack("<Q", len(header)) + header)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, path)


def _numpy_dtype(name: str) -> np.dtype:
    t = getattr(torch, name)
    return torch.empty((), dtype=_VIEWS.get(t, t)).numpy().dtype


def load(path: str, device="cuda") -> PyTree:
    """Read a :func:`save` file: torch leaves onto ``device`` (resolved only
    where the file holds one), numpy leaves as numpy."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:len(MAGIC)] != MAGIC:
        raise ValueError(f"{path} is not a checkpoint of this format")
    (hlen,) = struct.unpack_from("<Q", blob, len(MAGIC))
    base = len(MAGIC) + 8 + hlen
    header = json.loads(blob[len(MAGIC) + 8:base].decode("utf-8"))
    dev = None
    flat = {}
    for key, rec in header["leaves"].items():
        np_dtype = (_numpy_dtype(rec["dtype"]) if rec["kind"] == "torch"
                    else np.dtype(rec["dtype"]))
        arr = np.frombuffer(blob, dtype=np_dtype, count=rec["nbytes"] // np_dtype.itemsize,
                            offset=base + rec["offset"]).reshape(rec["shape"]).copy()
        if rec["kind"] == "numpy":
            flat[key] = arr
            continue
        if dev is None:
            dev = resolve_device(device)
        t = torch.from_numpy(arr)
        want = getattr(torch, rec["dtype"])
        if want in _VIEWS:
            t = t.view(want)
        flat[key] = t.to(dev)
    kinds = {"dict": dict, "list": list, "tuple": tuple}
    for key, kind in header["empty"].items():
        flat[key] = kinds[kind]()
    if "" in flat:          # the whole tree is one leaf or one empty container
        return flat[""]
    return _unflatten(flat)
