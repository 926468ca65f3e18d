"""Plain forward and LM server step of the per-layer hybrid
(granite-4.0-h-micro), in float32: the benchmark's copy of the repository's
``tests/plain_granite_hybrid.py``, with every product through a
``Precision`` (for the controls) and the server step over blocks of rows.

Each layer is ``x + m * mixer(rms_norm(x))``, then ``x + m * mlp(rms_norm(x))``
(m the residual multiplier), the mixer a Mamba2 block or causal grouped-query
attention as ``layer_types`` lists.  Attention: no positions, the softmax
scale the attention multiplier.  Mamba2: in_proj to (z, x, B, C, dt), a
depthwise causal conv with bias and SiLU over (x, B, C), dt = softplus(dt +
dt_bias), A = -exp(a_log), the SSD in its quadratic form over the whole
sequence,

    y_t = sum_{j<=t} exp(sum_{j<i<=t} dt_i A_h) (C_t . B_j) dt_j x_j + D x_t,

then RMSNorm(y * silu(z)) and out_proj.  The head is tied and its logits
are divided by ``logits_scaling``.  As in the program, every RMSNorm scales
by (1 + w) with eps 1e-6 (published: w, 1e-5).

Weights come in the program's layout (``kinds/server_seq_hybrid.py``): the
layers' norms and MLPs stacked over every layer, the mixers over the
layers of their kind.  Adapters per layer: ``{target: {"a": (r, in),
"b": (out, r)}}`` on in_proj, out_proj, wq, wk, wv and wo.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from plainref.adamw import Adam
from plainref.lm import nest
from plainref.model import layer_params, rms_norm
from plainref.numerics import Precision

MIXER_KEYS = {"mamba": "mamba", "attention": "attn"}


def proj(mc, prec: Precision, x, w, ad):
    y = prec.mm(x, w)
    if ad is not None:
        y = y + mc["lora"]["alpha"] / mc["lora"]["rank"] * prec.mm(prec.mm(x, ad["a"].t()),
                                                                   ad["b"].t())
    return y


def ssd(prec: Precision, x, bmat, cmat, dt, a, d_skip):
    """x (B,S,H,P), bmat/cmat (B,S,N), dt (B,S,H), a and d_skip (H,)."""
    s = x.shape[1]
    cs = torch.cumsum(dt * a, dim=1)
    seg = cs[:, :, None, :] - cs[:, None, :, :]                        # (B,t,j,H)
    keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    decay = torch.exp(torch.where(keep, seg, torch.full_like(seg, -math.inf)))
    gram = prec.mm(cmat, bmat.transpose(1, 2))                         # (B,t,j)
    w = (decay * gram[..., None] * dt[:, None, :, :]).permute(0, 3, 1, 2)   # (B,H,t,j)
    y = prec.mm(w, x.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)          # (B,S,H,P)
    return y + d_skip[:, None] * x


def mamba(mc, prec: Precision, p, ad, h):
    ss = mc["ssm"]
    d_in = ss["expand"] * mc["d_model"]
    n, hp = ss["d_state"], ss["head_dim"]
    nh = d_in // hp
    z, xbc, dt = torch.split(proj(mc, prec, h, p["in_proj"], ad.get("in_proj")),
                             [d_in, d_in + 2 * n, nh], dim=-1)
    k = ss["d_conv"]
    conv = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)), p["conv_w"].float().t()[:, None, :],
                    p["conv_b"].float(), groups=xbc.shape[-1])
    x, bmat, cmat = torch.split(F.silu(conv.transpose(1, 2)), [d_in, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].float())
    b, s, _ = h.shape
    y = ssd(prec, x.reshape(b, s, nh, hp), bmat, cmat, dt, -torch.exp(p["a_log"].float()),
            p["d_skip"].float()).reshape(b, s, d_in)
    y = rms_norm(y * F.silu(z), p["norm"]["scale"])
    return proj(mc, prec, y, p["out_proj"], ad.get("out_proj"))


def attention(mc, prec: Precision, p, ad, h):
    b, s, _ = h.shape
    nh, nk, hd = mc["n_heads"], mc["n_kv_heads"], mc["head_dim"]

    def heads(name, n):
        return proj(mc, prec, h, p[name], ad.get(name)).reshape(b, s, n, hd).transpose(1, 2)

    q, k, v = heads("wq", nh), heads("wk", nk), heads("wv", nk)
    k, v = k.repeat_interleave(nh // nk, dim=1), v.repeat_interleave(nh // nk, dim=1)
    scores = prec.mm(q, k.transpose(-1, -2)) * mc["attention_multiplier"]
    keep = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~keep, -math.inf), dim=-1)
    out = prec.mm(probs, v).transpose(1, 2).reshape(b, s, nh * hd)
    return proj(mc, prec, out, p["wo"], ad.get("wo"))


def mlp(prec: Precision, p, h):
    return prec.mm(F.silu(prec.mm(h, p["wg"])) * prec.mm(h, p["wu"]), p["wd"])


def layers(mc, prec: Precision, params, adapters, x, lo, hi):
    """Layers [lo, hi); ``adapters[i]`` holds layer i's adapters."""
    rm = mc["residual_multiplier"]
    kinds = mc["layer_types"]
    for i in range(lo, hi):
        key = MIXER_KEYS[kinds[i]]
        mixer = layer_params(params[key], sum(1 for t in kinds[:i] if t == kinds[i]))
        common = layer_params(params["layers"], i)
        ad = adapters.get(i, {})
        h = rms_norm(x, common["ln1"]["scale"])
        branch = mamba if key == "mamba" else attention
        x = x + rm * branch(mc, prec, mixer, ad, h)
        x = x + rm * mlp(prec, common["mlp"], rms_norm(x, common["ln2"]["scale"]))
    return x


def lm_nll_sum(mc, prec: Precision, params, h, targets):
    """The summed next-token negative log-likelihood over the tied head,
    its logits divided by ``logits_scaling``."""
    h = rms_norm(h, params["final_norm"]["scale"])
    logits = prec.mm(h, params["embed"].t()) / mc["logits_scaling"]
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def server_step(mc: dict, prec: Precision, params: dict, adapters: dict, opt_state,
                v: torch.Tensor, targets: torch.Tensor, cut: int, adam: Adam,
                block_rows: int, drop_rows: int = 0):
    """``plainref.lm.server_step`` for this model: one step from the
    phone's activations ``v`` at ``cut``, rows in blocks.  Returns (loss,
    dv, grads, new adapters, new optimizer state), adapters and gradients
    flat ({"L{l}.{target}.{a|b}": float32 tensor}); ``drop_rows`` > 0
    leaves that many trailing rows out (a fault, for calibration)."""
    rows = v.shape[0] - drop_rows
    n_tok = rows * v.shape[1]
    names = list(adapters)
    leaves = [adapters[n].detach().float().requires_grad_(True) for n in names]
    grads = [torch.zeros_like(t) for t in leaves]
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    loss = 0.0
    for r0 in range(0, rows, block_rows):
        r1 = min(rows, r0 + block_rows)
        vb = v[r0:r1].detach().float().requires_grad_(True)
        with torch.enable_grad():
            h = layers(mc, prec, params, nest(dict(zip(names, leaves))), vb, cut,
                       mc["n_layers"])
            nll = lm_nll_sum(mc, prec, params, h, targets[r0:r1]) / n_tok
            gs = torch.autograd.grad(nll, [vb] + leaves)
        dv[r0:r1] = gs[0]
        for acc, g in zip(grads, gs[1:]):
            acc += g
        loss += float(nll.detach())
        del h, nll, gs, vb
    grads = dict(zip(names, grads))
    if opt_state is None:
        opt_state = adam.init(grads)
    new, opt_state = adam.update({n: t.detach() for n, t in zip(names, leaves)}, grads,
                                 opt_state)
    return loss, dv, grads, new, opt_state
