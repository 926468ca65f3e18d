"""Every input of a run, made from the seed: weights, adapters, uploads.

Each tensor draws from a generator of its own, seeded from the run's seed
and the tensor's name, on the device and in one call, in the type it is
served in.  So the same seed gives the same tensors in any order, and the
reference makes the same ones again after the program's state is freed.
The layout is the program's (layers stacked on a leading axis, weights
(in, out)); the harness checks it against the program's own spec.
"""
from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from harness.work import proj_io

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def derive(seed: int, *names) -> int:
    """A 63-bit seed for one tensor: the run's seed and the tensor's name."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [zlib.crc32(str(n).encode()) for n in names]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def generator(device, seed: int, *names) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *names))
    return g


def normal(shape, std: float, dtype, device, seed: int, *names) -> torch.Tensor:
    t = torch.randn(shape, generator=generator(device, seed, *names), device=device,
                    dtype=dtype)
    return t.mul_(std)


def randint(high: int, shape, device, seed: int, *names) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=generator(device, seed, *names),
                         device=device, dtype=torch.int64)


def _norm(mc, shape, device):
    f32 = dict(dtype=torch.float32, device=device)
    if mc["norm"] == "rmsnorm":
        return {"scale": torch.zeros(shape, **f32)}
    return {"scale": torch.ones(shape, **f32), "bias": torch.zeros(shape, **f32)}


def params(mc: dict, seed: int, device) -> dict:
    """The frozen weights: N(0, 1/fan_in) matrices, N(0, 0.02^2) tables,
    norms at their identity, a float32 classifier where there is one."""
    dt = DTYPES[mc["dtype"]]
    L, d, ff = mc["n_layers"], mc["d_model"], mc["d_ff"]
    io = proj_io(mc)

    def w(name, shape, fan_in):
        return normal(shape, 1.0 / math.sqrt(fan_in), dt, device, seed, "w", name)

    p = {"embed": normal((mc["vocab_size"], d), 0.02, dt, device, seed, "w", "embed")}
    if mc["positional"] == "learned":
        p["pos_embed"] = normal((mc["max_position"], d), 0.02, dt, device, seed, "w",
                                "pos_embed")
    mlp = {"wu": w("wu", (L, d, ff), d), "wd": w("wd", (L, ff, d), ff)}
    if mc["activation"] in ("silu", "geglu"):
        mlp["wg"] = w("wg", (L, d, ff), d)
    p["layers"] = {
        "ln1": _norm(mc, (L, d), device),
        "attn": {t: w(t, (L, k, n), k) for t, (k, n) in io.items()},
        "ln2": _norm(mc, (L, d), device),
        "mlp": mlp,
    }
    p["final_norm"] = _norm(mc, (d,), device)
    if mc["n_classes"]:
        p["cls_head"] = normal((d, mc["n_classes"]), 1.0 / math.sqrt(d), torch.float32,
                               device, seed, "w", "cls_head")
    return p


def adapters(mc: dict, seed: int, owner: str, device, b_std: float, lo: int = 0) -> dict:
    """Float32 adapter stacks over every layer in the program's layout
    ({"layers": {"attn": {target: {"a": (L, r, in), "b": (L, out, r)}}}}):
    A ~ N(0, 1/r), B ~ N(0, b_std^2) (a run in progress, not a fresh
    adapter), zero below layer ``lo`` (a server's adapters below its cut)."""
    L, r = mc["n_layers"], mc["lora"]["rank"]
    f32 = torch.float32
    out = {}
    io = proj_io(mc)
    for t in mc["lora"]["targets"]:
        fan_in, fan_out = io[t]
        a = normal((L, r, fan_in), 1.0 / math.sqrt(r), f32, device, seed, owner, t, "a")
        b = normal((L, fan_out, r), b_std, f32, device, seed, owner, t, "b")
        a[:lo] = 0
        b[:lo] = 0
        out[t] = {"a": a, "b": b}
    return {"layers": {"attn": out}}


def flat_adapters(tree: dict, lo: int, hi: int) -> dict:
    """{"L{l}.{target}.{a|b}": layer l's tensor} for l in [lo, hi)."""
    return {f"L{l}.{t}.{ab}": ad[ab][l]
            for t, ad in tree["layers"]["attn"].items() for ab in ("a", "b")
            for l in range(lo, hi)}
