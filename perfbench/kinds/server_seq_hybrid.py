"""The edge server serving one phone's upload per dispatch, in turn, on the
per-layer hybrid (granite-4.0-h-micro): ``kinds/server_seq.py``'s loop,
timing and comparison, with this model's weights, adapters, work and
reference.

Weights (the program's layout, checked against its spec): the layers'
norms and SiLU-gated MLPs stacked over all layers; the Mamba2 mixers over
the Mamba2 layers (in_proj and out_proj N(0, 1/fan_in) in the model's
type; conv N(0, 1/d_conv) with a N(0, 0.1^2) bias, a_log = log U(1, 16),
dt_bias the inverse softplus of a log-uniform dt in [1e-3, 1e-1], D = 1,
float32); the attention mixers over the attention layers; the tied
embedding N(0, 0.02^2); every norm at its identity.  Adapters stay
stacked over every layer, each layer with both mixers' targets; a layer's
own mixer's hold A ~ N(0, 1/r) and B ~ N(0, b_std^2), the other mixer's
and those below a phone's cut zeros.
"""
from __future__ import annotations

import math

import torch

from harness import compare, port, weights, work_hybrid
from harness.stats import Clock as _Clock
from kinds import server_seq as seq
from plainref import hybrid as ref_hybrid
from plainref.adamw import Adam
from plainref.numerics import Precision

MIXER_KEYS = ref_hybrid.MIXER_KEYS


def model_config(mc: dict):
    """The program's ``ModelConfig``: the file's "model" with its nested
    groups as the program's dataclasses."""
    from repro_torch.configs.base import LoRAConfig, ModelConfig, SSMConfig
    fields = dict(mc)
    lora = dict(fields.pop("lora"))
    lora["targets"] = tuple(lora["targets"])
    fields["ssm"] = SSMConfig(**fields["ssm"])
    fields["layer_types"] = tuple(fields["layer_types"])
    return ModelConfig(**fields, lora=LoRAConfig(**lora))


def _mixer_io(mc) -> dict:
    """{mixer key: {projection: (in, out)}}."""
    return {"mamba": work_hybrid.mamba_io(mc)[0], "attn": work_hybrid.W.proj_io(mc)}


def params(mc: dict, seed: int, device) -> dict:
    dt = weights.DTYPES[mc["dtype"]]
    f32 = torch.float32
    L, d, ff = mc["n_layers"], mc["d_model"], mc["d_ff"]
    n = {key: sum(1 for t in mc["layer_types"] if MIXER_KEYS[t] == key) for key in _mixer_io(mc)}
    s = mc["ssm"]
    d_in = s["expand"] * d
    nh, conv_ch, k = d_in // s["head_dim"], work_hybrid.mamba_io(mc)[1], s["d_conv"]

    def w(name, shape, fan_in):
        return weights.normal(shape, 1.0 / math.sqrt(fan_in), dt, device, seed, "w", name)

    def uniform(name, shape, lo, hi):
        return torch.rand(shape, generator=weights.generator(device, seed, "w", name),
                          device=device, dtype=f32).mul_(hi - lo).add_(lo)

    zeros = lambda *shape: torch.zeros(shape, dtype=f32, device=device)  # noqa: E731
    step = torch.exp(uniform("mamba.dt", (n["mamba"], nh), math.log(1e-3), math.log(1e-1)))
    mamba = {name: w("mamba." + name, (n["mamba"], fi, fo), fi)
             for name, (fi, fo) in _mixer_io(mc)["mamba"].items()}
    mamba.update({
        "conv_w": weights.normal((n["mamba"], k, conv_ch), 1.0 / math.sqrt(k), f32, device,
                                 seed, "w", "mamba.conv_w"),
        "conv_b": weights.normal((n["mamba"], conv_ch), 0.1, f32, device, seed, "w",
                                 "mamba.conv_b"),
        "a_log": torch.log(uniform("mamba.a", (n["mamba"], nh), 1.0, 16.0)),
        "d_skip": torch.ones((n["mamba"], nh), dtype=f32, device=device),
        "dt_bias": step + torch.log(-torch.expm1(-step)),
        "norm": {"scale": zeros(n["mamba"], d_in)}})
    return {
        "embed": weights.normal((mc["vocab_size"], d), 0.02, dt, device, seed, "w", "embed"),
        "layers": {"ln1": {"scale": zeros(L, d)}, "ln2": {"scale": zeros(L, d)},
                   "mlp": {"wu": w("wu", (L, d, ff), d), "wg": w("wg", (L, d, ff), d),
                           "wd": w("wd", (L, ff, d), ff)}},
        "mamba": mamba,
        "attn": {name: w("attn." + name, (n["attn"], fi, fo), fi)
                 for name, (fi, fo) in _mixer_io(mc)["attn"].items()},
        "final_norm": {"scale": zeros(d)},
    }


def adapters(mc: dict, seed: int, owner: str, device, b_std: float, lo: int = 0) -> dict:
    """Float32 adapter stacks over every layer, both mixers' targets
    ({"layers": {"mamba": {t: {"a", "b"}}, "attn": {...}}}); each layer's
    own mixer's drawn from layer ``lo`` on, the rest zeros."""
    L, r = mc["n_layers"], mc["lora"]["rank"]
    out = {}
    for key, io in _mixer_io(mc).items():
        own = torch.tensor([MIXER_KEYS[t] == key and i >= lo
                            for i, t in enumerate(mc["layer_types"])], device=device)
        out[key] = {}
        for t, (fan_in, fan_out) in io.items():
            if t not in mc["lora"]["targets"]:
                continue
            a = weights.normal((L, r, fan_in), 1.0 / math.sqrt(r), torch.float32, device,
                               seed, owner, key, t, "a")
            b = weights.normal((L, fan_out, r), b_std, torch.float32, device, seed, owner,
                               key, t, "b")
            out[key][t] = {"a": a.mul_(own[:, None, None]), "b": b.mul_(own[:, None, None])}
    return {"layers": out}


def flat_adapters(mc: dict, tree: dict, lo: int, hi: int) -> dict:
    """{"L{l}.{target}.{a|b}": layer l's tensor} of each layer's own mixer,
    for l in [lo, hi)."""
    out = {}
    for l in range(lo, hi):
        for t, ad in tree["layers"][MIXER_KEYS[mc["layer_types"][l]]].items():
            for ab in ("a", "b"):
                out[f"L{l}.{t}.{ab}"] = ad[ab][l]
    return out


class Program(seq.Program):
    def setup(self) -> None:
        from repro_torch.core import splitfl
        from repro_torch.models import build_model
        from repro_torch.optim.adamw import AdamW

        mc, tr, dev = self.mc, self.tr, self.device
        clock = _Clock()
        model = build_model(model_config(mc), dev)
        self.params = params(mc, self.seed, dev)
        port.check_layout(self.params, model.params_spec())
        clock.lap("weights")
        o = tr["optimizer"]
        opt = AdamW(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"])
        port.same_optimizer(opt, o)
        self.steps = {c: splitfl.make_server_step(model, opt, path="sliced", static_cut=c)
                      for c in sorted(set(self.cuts))}
        self.lora = [adapters(mc, self.seed, f"phone{i}", dev, tr["lora_b_std"], lo=c)
                     for i, c in enumerate(self.cuts)]
        port.check_layout(self.lora[0], model.lora_spec(), "adapters")
        self.state = [opt.init(lo) for lo in self.lora]
        self.pool = [[seq._upload(mc, tr, self.seed, i, k, dev) for k in range(tr["pool"])]
                     for i in range(len(self.cuts))]
        clock.lap("adapters and uploads")
        self._checked_steps()
        clock.lap("checked steps")
        unwarmed = set(self.cuts) - {self.cuts[i] for i, _ in seq._schedule(tr, self.k)}
        if unwarmed:        # the checked steps are the warm-up: one step at each cut
            raise ValueError(f"the checked steps leave cuts {sorted(unwarmed)} unwarmed: "
                             "order the traffic so that they visit every cut")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_log = clock.log

    def _checked_steps(self) -> None:
        mc, tr, L = self.mc, self.tr, self.mc["n_layers"]
        b1 = tr["optimizer"]["b1"]
        first = {}
        losses, dvs, grads = [], [], {}
        for _ in range(tr["checked_steps"]):
            i, loss, dv = self._step()
            losses.append(float(loss))
            dvs.append(dv.float().reshape(-1, mc["d_model"]))
            if i not in first:
                first[i] = adapters(mc, self.seed, f"phone{i}", self.device,
                                    tr["lora_b_std"], lo=self.cuts[i])
                mu = flat_adapters(mc, self.state[i].mu, self.cuts[i], L)
                grads.update({f"p{i}.{n}": g for n, g in
                              compare.norms(mu, 1.0 / (1.0 - b1)).items()})
        change = {}
        for i, init in first.items():
            now = flat_adapters(mc, self.lora[i], self.cuts[i], L)
            was = flat_adapters(mc, init, self.cuts[i], L)
            change.update({f"p{i}.{n}": c for n, c in
                           compare.norms({n: now[n] - was[n] for n in now}).items()})
        self.readings = compare.Readings(losses, grads, change, dvs)

    def trace_slice(self) -> dict:
        """``trace_steps`` uploads, with the work they need from shapes and
        the kernel wrapper's launch count over them."""
        from repro_torch.kernels.lora_matmul import lora_matmul
        mc, tr = self.mc, self.tr
        n = tr["trace_steps"]
        before = lora_matmul.launches
        cuts = [self.cuts[self._step()[0]] for _ in range(n)]
        rows = self.tokens_per_upload
        return {"attempted": n, "failed": 0, "tokens": n * rows, "dtype": mc["dtype"],
                "model_flops": sum(work_hybrid.server_step_flops(mc, tr["seqs"], tr["seq_len"], c)
                                   for c in cuts),
                "calls": {"lora_matmul": [c for cut in cuts for c in
                                          work_hybrid.projection_calls(mc, rows, cut)]},
                "launches": {"lora_matmul": lora_matmul.launches - before}}


# -- the reference -------------------------------------------------------------
def reference(mc: dict, tr: dict, seed: int, device, precision: str = "fp32",
              fault: str = "") -> compare.Readings:
    """The checked steps, plainly, from the same inputs; ``fault`` as in
    ``kinds/server_seq.py``."""
    device = torch.device(device)
    L = mc["n_layers"]
    prec = Precision(precision)
    o = tr["optimizer"]
    adam = Adam(o["lr"], o["b1"], o["b2"], o["eps"])
    p = seq._float(params(mc, seed, device))
    state, first, flat = {}, {}, {}
    losses, dvs, grads = [], [], {}
    for i, k in seq._schedule(tr, tr["checked_steps"]):
        cut = tr["phones"][i]["cut"]
        if i not in flat:
            tree = adapters(mc, seed, f"phone{i}", device, tr["lora_b_std"], lo=cut)
            flat[i] = flat_adapters(mc, tree, cut, L)
            first[i] = dict(flat[i])
        v, batch = seq._upload(mc, tr, seed, i, k, device)
        drop = tr["seqs"] // 2 if fault == "half_batch" else 0
        loss, dv, g, flat[i], st = ref_hybrid.server_step(
            mc, prec, p, flat[i], state.get(i), v, batch["targets"], cut, adam,
            tr["reference_block_rows"], drop_rows=drop)
        if fault == "altered_answer":
            dv[0] = 0
        if i not in state:
            grads.update({f"p{i}.{n}": x for n, x in compare.norms(g).items()})
        state[i] = st
        losses.append(loss)
        dvs.append(dv.reshape(-1, mc["d_model"]).cpu())
    change = {}
    for i, was in first.items():
        change.update({f"p{i}.{n}": x for n, x in
                       compare.norms({n: flat[i][n] - was[n] for n in was}).items()})
    return compare.Readings(losses, grads, change, dvs)
