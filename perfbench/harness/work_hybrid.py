"""Frozen counts of the work of the per-layer hybrid's LM server step
(granite-4.0-h-micro), from shapes alone, as ``harness.work`` counts the
dense decoder's: useful products only (no weight gradient for a frozen
weight, no recomputation, norms and elementwise work not counted).

* The attention layers, their MLPs and the tied head: ``harness.work``'s
  ``layer_flops`` and ``lm_head_flops``.
* A Mamba2 layer's projections (in_proj, out_proj) as ``harness.work``
  counts an adapted projection: forward, the gradient to its input, and
  the adapter's gradients; its MLP likewise.
* The depthwise causal conv over (x, B, C): 2 * d_conv operations per
  channel and token forward, as many for its input gradient.
* The SSD as the chunked form computes it at the published chunk
  (``mamba_chunk_size`` 256), forward and backward: within a chunk the
  Gram C_t . B_j and the weighted sum over x_j on the (t, j) pairs the
  causal mask keeps; across chunks a chunk's state contribution (for every
  chunk but the last, whose state no output reads) and each chunk's
  output from the state carried into it (for every chunk but the first,
  which starts from zero).  Every one of these products has two operands
  that need a gradient, so the backward is twice the forward.
"""
from __future__ import annotations

from harness import work as W

SSD_CHUNK = 256


def mamba_io(mc):
    """{projection: (in, out)} of a Mamba2 mixer, and its conv channels."""
    s, d = mc["ssm"], mc["d_model"]
    d_in = s["expand"] * d
    nh = d_in // s["head_dim"]
    return ({"in_proj": (d, 2 * d_in + 2 * s["d_state"] + nh), "out_proj": (d_in, d)},
            d_in + 2 * s["d_state"])


def _adapted(t: int, k: int, n: int, r: int) -> float:
    """An adapted projection over t rows: forward, input gradient, and the
    adapter's gradients (g B, (g B)^T x, g^T (x A^T))."""
    base = 2.0 * t * k * n + 2.0 * t * r * (k + n)
    return 2 * base + 2.0 * t * r * (2 * n + k)


def ssd_flops(mc, seqs: int, seq_len: int) -> float:
    """The SSD over ``seqs`` sequences at ``SSD_CHUNK``, forward and backward."""
    s, chunk = mc["ssm"], SSD_CHUNK
    h = s["expand"] * mc["d_model"] // s["head_dim"]
    p, n = s["head_dim"], s["d_state"]
    lengths = [min(chunk, seq_len - c0) for c0 in range(0, seq_len, chunk)]
    fwd = 0.0
    for c, q in enumerate(lengths):
        pairs = W.causal_pairs(q)
        fwd += 2.0 * n * pairs + 2.0 * h * p * pairs
        if c < len(lengths) - 1:
            fwd += 2.0 * q * h * p * n          # the chunk's state contribution
        if c > 0:
            fwd += 2.0 * q * h * p * n          # its output from the carried state
    return 3 * seqs * fwd


def mamba_layer_flops(mc, seqs: int, seq_len: int) -> float:
    """One Mamba2 layer and its MLP, forward and backward."""
    t = seqs * seq_len
    r = mc["lora"]["rank"]
    io, conv_ch = mamba_io(mc)
    targets = set(mc["lora"]["targets"])
    total = 2 * 3 * 2.0 * t * mc["d_model"] * mc["d_ff"]           # the gated MLP, x and dx
    for name, (k, n) in io.items():
        total += _adapted(t, k, n, r) if name in targets else 2 * 2.0 * t * k * n
    total += 2 * 2.0 * mc["ssm"]["d_conv"] * conv_ch * t
    return total + ssd_flops(mc, seqs, seq_len)


def server_step_flops(mc, seqs: int, seq_len: int, cut: int) -> float:
    """The LM server step at ``cut``: layers [cut, L) by their mixers,
    forward and back, and the head."""
    total = W.lm_head_flops(mc, seqs * seq_len, backward=True)
    for kind in mc["layer_types"][cut:]:
        total += (mamba_layer_flops(mc, seqs, seq_len) if kind == "mamba"
                  else W.layer_flops(mc, seqs, seq_len, backward=True))
    return total


def projection_calls(mc, rows: int, cut: int):
    """The adapted projections' kernel calls of layers [cut, L): each
    target's forward and its input gradient.  Returns [(m, k, n, r, groups)]."""
    r = mc["lora"]["rank"]
    io, _ = mamba_io(mc)
    attn = W.proj_io(mc)
    attn_mc = dict(mc, lora=dict(mc["lora"], targets=[t for t in mc["lora"]["targets"]
                                                      if t in attn]))
    calls = []
    for kind in mc["layer_types"][cut:]:
        if kind == "mamba":
            for name in ("in_proj", "out_proj"):
                if name in mc["lora"]["targets"]:
                    k, n = io[name]
                    calls += [(rows, k, n, r, 1), (rows, n, k, r, 1)]
        else:
            calls += W.projection_calls(attn_mc, rows, 1, 1, True)
    return calls
