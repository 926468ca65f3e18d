"""Frozen counts of the work a step needs, from shapes alone.

These are the yardstick's formulas: later changes to the program do not
change them.  Model FLOPs count useful work only: matrix products (norms
and elementwise work are not counted), no weight gradient for a frozen
base weight, attention over the (query, key) pairs the mask keeps, no
recomputation.  A kernel call's bytes count each input read once and each
output written once.  Formulas first written in the program's
``kernels/work.py`` and ``launch/cost_analysis.py``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# published dense peaks of one H100 SXM (NVIDIA's data sheet), for the
# units the configuration's type runs on: bf16 on the tensor cores (989
# TFLOP/s); fp32 as 3xTF32, three TF32 tensor-core products per product
# (494.5 TFLOP/s over 3), which is how the program's fp32 kernels keep
# fp32 accuracy with TF32 off.  The CUDA cores' fp32 SIMT peak (67 TFLOP/s)
# lies below what such a tile reaches, so a share of it could pass 100 %.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 494.5e12 / 3}
PEAK_HBM_BYTES = 3.35e12
ELT = {"bfloat16": 2, "float32": 4}


def lora_call(m: int, k: int, n: int, r: int, groups: int, elt: int) -> Tuple[float, float]:
    """y = x W + s (x A_g^T) B_g^T over m rows, K -> N, rank r, ``groups``
    adapter pairs: (operations, bytes)."""
    flops = 2.0 * m * k * n + 2.0 * m * r * (k + n)
    nbytes = elt * (m * k + k * n + groups * r * (k + n) + m * n)
    return flops, nbytes


def call_bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip allows: operations over the peak of the
    type, or bytes over the HBM rate, whichever is longer."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_HBM_BYTES)


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def proj_io(mc) -> Dict[str, Tuple[int, int]]:
    """{projection: (in, out)} of a layer's attention projections."""
    d = mc["d_model"]
    q_out, kv_out = mc["n_heads"] * mc["head_dim"], mc["n_kv_heads"] * mc["head_dim"]
    return {"wq": (d, q_out), "wk": (d, kv_out), "wv": (d, kv_out), "wo": (q_out, d)}


def layer_flops(mc, seqs: int, seq_len: int, backward: bool, input_grad: bool = True) -> float:
    """One layer over ``seqs`` sequences: forward, and with ``backward`` the
    gradients to its input and its adapters.  ``input_grad=False`` (the
    first layer of a client) skips q, k and v's products towards the
    layer's input, which no adapter needs."""
    t = seqs * seq_len
    d, ff, r = mc["d_model"], mc["d_ff"], mc["lora"]["rank"]
    gated = mc["activation"] in ("silu", "geglu")
    io = proj_io(mc)
    targets = set(mc["lora"]["targets"])
    pairs = causal_pairs(seq_len) if mc["causal"] else seq_len * seq_len
    attn = 4.0 * seqs * mc["n_heads"] * mc["head_dim"] * pairs
    fwd = attn + (3 if gated else 2) * 2.0 * t * d * ff
    dx = 2.0 * attn + (3 if gated else 2) * 2.0 * t * d * ff
    grads = 0.0
    for name, (k, n) in io.items():
        base = 2.0 * t * k * n + (2.0 * t * r * (k + n) if name in targets else 0.0)
        fwd += base
        if input_grad or name == "wo":
            dx += base
        if name in targets:
            grads += 2.0 * t * r * (2 * n + k)      # g B, (g B)^T x, g^T (x A^T)
    return fwd + (dx + grads if backward else 0.0)


def lm_head_flops(mc, tokens: int, backward: bool) -> float:
    """The tied LM head over ``tokens``: logits, and their gradient to the
    hidden states (the table is frozen)."""
    f = 2.0 * tokens * mc["d_model"] * mc["vocab_size"]
    return f * (2 if backward else 1)


def cls_head_flops(mc, seqs: int) -> float:
    """The classifier on the first position: logits, its own gradient and
    the gradient to the hidden state."""
    return 3 * 2.0 * seqs * mc["d_model"] * mc["n_classes"]


def server_step_flops(mc, seqs: int, seq_len: int, cut: int) -> float:
    """The LM server step at ``cut``: layers [cut, L) forward and back, the
    head, the gradient to the phone's activations."""
    n = mc["n_layers"] - cut
    return (n * layer_flops(mc, seqs, seq_len, backward=True)
            + lm_head_flops(mc, seqs * seq_len, backward=True))


def split_round_flops(mc, seqs: int, seq_len: int, cuts: List[int]) -> float:
    """A round of split fine-tuning with a classifier: each client's layers
    [0, cut) and its server layers [cut, L), forward and back, counted from
    each client's own cut (work below a cut that a masked dispatch pads
    in is not useful and not counted)."""
    total = 0.0
    L = mc["n_layers"]
    for cut in cuts:
        total += layer_flops(mc, seqs, seq_len, backward=True, input_grad=False)
        total += (L - 1) * layer_flops(mc, seqs, seq_len, backward=True)
        total += cls_head_flops(mc, seqs)
    return total


def projection_calls(mc, rows: int, layers: int, groups: int, input_grad_first: bool):
    """The adapted projections' kernel calls of ``layers`` layers over
    ``rows`` rows: one forward call per target and layer, and one call for
    its input gradient (K and N swapped) where that gradient is needed.
    Returns [(m, k, n, r, groups)]."""
    r = mc["lora"]["rank"]
    io = proj_io(mc)
    calls = []
    for layer in range(layers):
        for t in mc["lora"]["targets"]:
            k, n = io[t]
            calls.append((rows, k, n, r, groups))
            if input_grad_first or layer > 0 or t == "wo":
                calls.append((rows, n, k, r, groups))
    return calls
