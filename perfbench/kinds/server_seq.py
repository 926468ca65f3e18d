"""The edge server serving one phone's upload per dispatch, in turn.

Each phone holds a cut, its own full-shape server adapters and its own
AdamW state on the server.  An upload is ``seqs`` x ``seq_len`` token ids
with next-token targets and the phone's activations at its cut; the
server's step (``core.splitfl.make_server_step``, sliced, one static cut
each) turns (weights, adapters, state, activations, batch) into (loss,
adapters, state, dv), and ``dv`` goes to the host for the downlink, which
ends the upload's time.  The loop is closed: the phones' uploads are
served back to back in the traffic file's order, each phone's from a pool
made in set-up and cycled.

Set-up drives the first ``checked_steps`` uploads through the same call;
the reference follows them from the same inputs after the window.
"""
from __future__ import annotations

import time

import torch

from harness.stats import Clock as _Clock
from harness import compare, port, weights, work
from plainref import lm as ref_lm
from plainref.adamw import Adam
from plainref.numerics import Precision


def _upload(mc, tr, seed, phone: int, k: int, device):
    b, s, d = tr["seqs"], tr["seq_len"], mc["d_model"]
    v = weights.normal((b, s, d), tr["activation_std"], weights.DTYPES[mc["dtype"]], device,
                       seed, "upload", phone, k, "v")
    ids = weights.randint(mc["vocab_size"], (b, s + 1), device, seed, "upload", phone, k,
                          "ids")
    return v, {"tokens": ids[:, :s], "targets": ids[:, 1:]}


def _schedule(tr, n_steps: int):
    """(phone, its upload's pool index) of the first ``n_steps`` uploads."""
    seen = [0] * len(tr["phones"])
    out = []
    for j in range(n_steps):
        i = tr["order"][j % len(tr["order"])]
        out.append((i, seen[i] % tr["pool"]))
        seen[i] += 1
    return out


class Program:
    def __init__(self, mc: dict, traffic: dict, seed: int, device):
        self.mc, self.tr, self.seed, self.device = mc, traffic, seed, torch.device(device)
        self.cuts = [p["cut"] for p in traffic["phones"]]
        self.tokens_per_upload = traffic["seqs"] * traffic["seq_len"]
        self.readings = None
        self.k = 0                      # uploads served so far
        self.seen = [0] * len(self.cuts)  # uploads served per phone

    # -- the program ---------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core import splitfl
        from repro_torch.models import build_model
        from repro_torch.optim.adamw import AdamW

        mc, tr, dev = self.mc, self.tr, self.device
        clock = _Clock()
        model = build_model(port.model_config(mc), dev)
        self.params = weights.params(mc, self.seed, dev)
        port.check_layout(self.params, model.params_spec())
        clock.lap("weights")
        o = tr["optimizer"]
        opt = AdamW(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"])
        port.same_optimizer(opt, o)
        self.steps = {c: splitfl.make_server_step(model, opt, path="sliced", static_cut=c)
                      for c in sorted(set(self.cuts))}
        self.lora = [weights.adapters(mc, self.seed, f"phone{i}", dev, tr["lora_b_std"], lo=c)
                     for i, c in enumerate(self.cuts)]
        self.state = [opt.init(lo) for lo in self.lora]
        self.pool = [[_upload(mc, tr, self.seed, i, k, dev) for k in range(tr["pool"])]
                     for i in range(len(self.cuts))]
        clock.lap("adapters and uploads")
        self._checked_steps()
        clock.lap("checked steps")
        unwarmed = set(self.cuts) - {self.cuts[i] for i, _ in _schedule(tr, self.k)}
        if unwarmed:        # the checked steps are the warm-up: one step at each cut
            raise ValueError(f"the checked steps leave cuts {sorted(unwarmed)} unwarmed: "
                             "order the traffic so that they visit every cut")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_log = clock.log

    def _next(self) -> int:
        return self.tr["order"][self.k % len(self.tr["order"])]

    def _step(self):
        """Serve the next upload: (phone, loss on the device, dv on the host)."""
        i = self._next()
        v, batch = self.pool[i][self.seen[i] % self.tr["pool"]]
        self.seen[i] += 1
        self.k += 1
        loss, self.lora[i], self.state[i], dv = self.steps[self.cuts[i]](
            self.params, self.lora[i], self.state[i], v, batch)
        return i, loss, dv.to("cpu")

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
                first[i] = weights.adapters(mc, self.seed, f"phone{i}", self.device,
                                            tr["lora_b_std"], lo=self.cuts[i])
                mu = weights.flat_adapters(self.state[i].mu, self.cuts[i], L)
                grads.update({f"p{i}.{n}": g for n, g in
                              compare.norms(mu, 1.0 / (1.0 - b1)).items()})
        change = {}
        for i, init in first.items():
            now = weights.flat_adapters(self.lora[i], self.cuts[i], L)
            was = weights.flat_adapters(init, self.cuts[i], L)
            change.update({f"p{i}.{n}": c for n, c in
                           compare.norms({n: now[n] - was[n] for n in now}).items()})
        self.readings = compare.Readings(losses, grads, change, dvs)

    def window(self, seconds: float) -> dict:
        """Uploads back to back until ``seconds`` have passed; the window
        ends when the last one's dv reaches the host."""
        lat = []
        t_start = time.perf_counter()
        deadline = t_start + seconds
        t1 = t_start
        while t1 < deadline:
            t0 = time.perf_counter()
            self._step()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
        return {"attempted": len(lat), "failed": 0, "elapsed_s": t1 - t_start,
                "tokens": len(lat) * self.tokens_per_upload, "latencies_s": lat}

    def trace_slice(self) -> dict:
        """``trace_steps`` uploads, with the work they need from shapes and
        the kernel wrappers' launch counts over them."""
        from repro_torch.kernels.lora_matmul import lora_matmul
        mc, tr = self.mc, self.tr
        n = tr["trace_steps"]
        before = lora_matmul.launches
        cuts = [self.cuts[self._step()[0]] for _ in range(n)]
        rows, L = self.tokens_per_upload, mc["n_layers"]
        return {"attempted": n, "failed": 0, "tokens": n * rows, "dtype": mc["dtype"],
                "model_flops": sum(work.server_step_flops(mc, tr["seqs"], tr["seq_len"], c)
                                   for c in cuts),
                "calls": {"lora_matmul": [c for cut in cuts for c in
                                          work.projection_calls(mc, rows, L - cut, 1, True)]},
                "launches": {"lora_matmul": lora_matmul.launches - before}}

    def free(self) -> None:
        for name in ("params", "steps", "lora", "state", "pool"):
            self.__dict__.pop(name, None)


# -- the reference -------------------------------------------------------------
def reference(mc: dict, tr: dict, seed: int, device, precision: str = "fp32",
              fault: str = "") -> compare.Readings:
    """The checked steps, plainly, from the same inputs.  ``fault``
    ("half_batch", "altered_answer") plants one of the comparison's faults
    in the reference put in the program's place."""
    device = torch.device(device)
    L = mc["n_layers"]
    prec = Precision(precision)
    o = tr["optimizer"]
    adam = Adam(o["lr"], o["b1"], o["b2"], o["eps"])
    params = weights.params(mc, seed, device)
    params = _float(params)
    adapters, states, first = {}, {}, {}
    losses, dvs, grads = [], [], {}
    for i, k in _schedule(tr, tr["checked_steps"]):
        cut = tr["phones"][i]["cut"]
        if i not in adapters:
            tree = weights.adapters(mc, seed, f"phone{i}", device, tr["lora_b_std"], lo=cut)
            adapters[i] = weights.flat_adapters(tree, cut, L)
            first[i] = dict(adapters[i])
        v, batch = _upload(mc, tr, seed, i, k, device)
        drop = tr["seqs"] // 2 if fault == "half_batch" else 0
        loss, dv, g, adapters[i], st = ref_lm.server_step(
            mc, prec, params, adapters[i], states.get(i), v, batch["targets"], cut, adam,
            tr["reference_block_rows"], drop_rows=drop)
        if fault == "altered_answer":
            dv[0] = 0
        if i not in states:
            grads.update({f"p{i}.{n}": x for n, x in compare.norms(g).items()})
        states[i] = st
        losses.append(loss)
        dvs.append(dv.reshape(-1, mc["d_model"]).cpu())
    change = {}
    for i, was in first.items():
        change.update({f"p{i}.{n}": x for n, x in
                       compare.norms({n: adapters[i][n] - was[n] for n in was}).items()})
    return compare.Readings(losses, grads, change, dvs)


def _float(tree):
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    return tree.float()
