"""Plain reference of granite-4.0-h-micro (IBM Granite 4.0-H Micro,
``granitemoehybrid``, hf:ibm-granite/granite-4.0-h-micro): its forward, its
teacher-forced loss and the LM server step of split fine-tuning, in float32
and plain ``torch`` alone.  It imports nothing of the port or of the JAX
package, and turns TF32 off for every float32 product.

The model, as published: 40 layers, each

    x = x + residual_multiplier * mixer(rms_norm(x))
    x = x + residual_multiplier * mlp(rms_norm(x))

with the mixer a Mamba2 block or grouped-query attention as ``layer_types``
lists.  The token embeddings are scaled by ``embedding_multiplier``; the
tied head's logits are divided by ``logits_scaling``.

* Attention: q, k, v, o projections with no bias; no positional encoding
  (``nope``); causal; each group of query heads reads one key head; the
  softmax scale is ``attention_multiplier`` (not 1/sqrt(D)).
* Mamba2: in_proj to (z, x, B, C, dt); a depthwise causal conv of width
  ``d_conv`` with bias over (x, B, C), then SiLU; dt = softplus(dt + dt_bias);
  A = -exp(a_log); the SSD, one B/C group shared by every head,

      y_t = sum_{j<=t} L[t, j, h] (C_t . B_j) dt_j x_j + D x_t,
      L[t, j, h] = exp(sum_{j<i<=t} dt_i A_h),

  formed here over the whole sequence at once (the quadratic form; no
  chunks, no carried state); then RMSNorm(y * silu(z)) and out_proj.
* MLP: down(silu(gate(h)) * up(h)).

Departures from the published model, shared with the port: every RMSNorm
(the gate's included) scales by (1 + w) with eps 1e-6, where the published
one scales by w with eps 1e-5; the weights are random.  LoRA adapters
(y = x W + s (x A^T) B^T, s = alpha / rank) sit on in_proj, out_proj, wq,
wk, wv and wo.

Layouts.  ``mc`` is a configuration dict with the port's field names
(d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab_size, layer_types,
ssm {d_state, d_conv, expand, head_dim}, the four multipliers, lora
{rank, alpha}).  Weights are (in, out), the layers' norms and MLPs stacked
on a leading axis of all layers and the mixers on one of their kind:
``{"embed", "layers": {"ln1", "ln2", "mlp": {"wu", "wg", "wd"}},
"mamba": {"in_proj", "conv_w" (K, C), "conv_b", "a_log", "d_skip",
"dt_bias", "norm", "out_proj"}, "attn": {"wq", "wk", "wv", "wo"},
"final_norm"}``, norms as ``{"scale": w}``.  Adapters are flat:
``{"L{layer}.{target}.{a|b}": tensor}``, a (r, in), b (out, r).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MIXER_KEYS = {"mamba": "mamba", "attention": "attn"}


def rms_norm(x, w, eps=1e-6):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w.float())


def proj(mc, x, w, adapters, name):
    """x W, plus the adapter s (x A^T) B^T where ``adapters`` has one."""
    y = x @ w.float()
    a, b = adapters.get(name + ".a"), adapters.get(name + ".b")
    if a is not None:
        y = y + mc["lora"]["alpha"] / mc["lora"]["rank"] * ((x @ a.float().t()) @ b.float().t())
    return y


def ssd(x, bmat, cmat, dt, a, d_skip):
    """The quadratic SSD: x (B,S,H,P), bmat/cmat (B,S,N), dt (B,S,H), a and
    d_skip (H,) -> y (B,S,H,P)."""
    s = x.shape[1]
    cs = torch.cumsum(dt * a, dim=1)                                   # (B,S,H)
    seg = cs[:, :, None, :] - cs[:, None, :, :]                        # (B,t,j,H)
    keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    decay = torch.exp(torch.where(keep, seg, torch.full_like(seg, -math.inf)))
    gram = torch.einsum("btn,bjn->btj", cmat, bmat)                    # (B,t,j)
    w = decay * gram[..., None] * dt[:, None, :, :]                    # (B,t,j,H)
    return torch.einsum("btjh,bjhp->bthp", w, x) + d_skip[:, None] * x


def ssd_recurrence(x, bmat, cmat, dt, a, d_skip):
    """The SSD one step after another from a zero state: the check of
    :func:`ssd` (S_t = exp(dt_t a) S_{t-1} + dt_t x_t (x) B_t, y_t = S_t C_t
    + D x_t)."""
    b, s, h, p = x.shape
    state = torch.zeros(b, h, p, bmat.shape[-1], dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        state = (torch.exp(dt[:, t] * a)[..., None, None] * state
                 + torch.einsum("bhp,bn->bhpn", dt[:, t, :, None] * x[:, t], bmat[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", state, cmat[:, t]) + d_skip[:, None] * x[:, t])
    return torch.stack(ys, dim=1)


def mamba(mc, p, adapters, pre, h):
    """The Mamba2 mixer on the normed h (B,S,d)."""
    ss = mc["ssm"]
    d_in = ss["expand"] * mc["d_model"]
    n, hp = ss["d_state"], ss["head_dim"]
    nh = d_in // hp
    z, xbc, dt = torch.split(proj(mc, h, p["in_proj"], adapters, pre + "in_proj"),
                             [d_in, d_in + 2 * n, nh], dim=-1)
    k = ss["d_conv"]
    conv = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)), p["conv_w"].float().t()[:, None, :],
                    p["conv_b"].float(), groups=xbc.shape[-1])
    x, bmat, cmat = torch.split(F.silu(conv.transpose(1, 2)), [d_in, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].float())
    b, s, _ = h.shape
    y = ssd(x.reshape(b, s, nh, hp), bmat, cmat, dt, -torch.exp(p["a_log"].float()),
            p["d_skip"].float()).reshape(b, s, d_in)
    y = rms_norm(y * F.silu(z), p["norm"]["scale"])
    return proj(mc, y, p["out_proj"], adapters, pre + "out_proj")


def attention(mc, p, adapters, pre, h):
    """Causal grouped-query attention on the normed h, no positions."""
    b, s, _ = h.shape
    nh, nk, hd = mc["n_heads"], mc["n_kv_heads"], mc["head_dim"]
    q = proj(mc, h, p["wq"], adapters, pre + "wq").reshape(b, s, nh, hd).transpose(1, 2)
    k = proj(mc, h, p["wk"], adapters, pre + "wk").reshape(b, s, nk, hd).transpose(1, 2)
    v = proj(mc, h, p["wv"], adapters, pre + "wv").reshape(b, s, nk, hd).transpose(1, 2)
    k, v = k.repeat_interleave(nh // nk, dim=1), v.repeat_interleave(nh // nk, dim=1)
    scores = (q @ k.transpose(-1, -2)) * mc["attention_multiplier"]
    keep = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~keep, -math.inf), dim=-1)
    out = (probs @ v).transpose(1, 2).reshape(b, s, nh * hd)
    return proj(mc, out, p["wo"], adapters, pre + "wo")


def mlp(p, h):
    return (F.silu(h @ p["wg"].float()) * (h @ p["wu"].float())) @ p["wd"].float()


def _at(tree, i):
    return {k: _at(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def layers(mc, params, adapters, x, lo, hi):
    """Layers [lo, hi) of the stack on the residual stream x (B,S,d)."""
    rm = mc["residual_multiplier"]
    kinds = mc["layer_types"]
    for i in range(lo, hi):
        key = MIXER_KEYS[kinds[i]]
        mixer = _at(params[key], sum(1 for t in kinds[:i] if t == kinds[i]))
        common = _at(params["layers"], i)
        h = rms_norm(x, common["ln1"]["scale"])
        branch = mamba if key == "mamba" else attention
        x = x + rm * branch(mc, mixer, adapters, f"L{i}.", h)
        x = x + rm * mlp(common["mlp"], rms_norm(x, common["ln2"]["scale"]))
    return x


def embed(mc, params, tokens):
    return params["embed"].float()[tokens.long()] * mc["embedding_multiplier"]


def logits(mc, params, h):
    return (rms_norm(h, params["final_norm"]["scale"]) @ params["embed"].float().t()
            / mc["logits_scaling"])


def lm_loss(mc, params, h, targets):
    """The mean next-token negative log-likelihood."""
    lg = logits(mc, params, h)
    gold = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    return (torch.logsumexp(lg, dim=-1) - gold).mean()


def forward(mc, params, adapters, tokens):
    """The hidden states after every layer, from token ids."""
    return layers(mc, params, adapters, embed(mc, params, tokens), 0, len(mc["layer_types"]))


def server_step(mc, params, adapters, v, targets, cut, lr, eps=1e-8):
    """One LM server step from a phone's activations ``v`` at ``cut``: the
    loss of layers [cut, L) and the head, its gradients with respect to
    the adapters and to ``v``, and one Adam step of the adapters from a
    zero state.  Returns (loss, dv, grads, new adapters)."""
    names = list(adapters)
    leaves = [adapters[n].detach().float().requires_grad_(True) for n in names]
    vv = v.detach().float().requires_grad_(True)
    with torch.enable_grad():
        h = layers(mc, params, dict(zip(names, leaves)), vv, cut, len(mc["layer_types"]))
        loss = lm_loss(mc, params, h, targets)
        gs = torch.autograd.grad(loss, [vv] + leaves)
    grads = dict(zip(names, gs[1:]))
    new = {}
    for n, t in zip(names, leaves):     # Adam's first step: m / (1 - b1), v / (1 - b2)
        g = grads[n]
        m_hat, v_hat = g, g * g
        new[n] = t.detach() - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return loss.detach(), gs[0], grads, new
