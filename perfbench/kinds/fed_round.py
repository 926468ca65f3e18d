"""The federation's round on the edge server: the Simulator's whole round
on its analytic engine (``fed.simulator.Simulator.run_round``).

Each client draws a batch from its share of the corpus and runs its
layers [0, cut); the server serves the clients' activations in dispatches
of ``cohort_chunk`` (``cohort_impl`` vmap: one masked dispatch over every
layer, each lane at its own cut); each client runs its backward from its
dv; every ``interval`` rounds the commit averages the adapters (Eqs.
5-9).  The benchmark makes the corpus, the weights (written into the
Simulator's own storage, which the clients' views share) and the adapters,
classifiers and optimizer states (loaded with ``load_state_dict``).

Set-up runs the first ``checked_rounds`` rounds, a commit among them; the
reference follows them from the same inputs after the window.
"""
from __future__ import annotations

import time

import torch

from harness.stats import Clock as _Clock
from harness import compare, data, port, weights, work
from plainref import fed as ref_fed
from plainref.adamw import Adam
from plainref.numerics import Precision


def _corpus(mc, tr, seed):
    return data.emotion_corpus(tr["train_examples"], tr["seq_len"], mc["vocab_size"], seed)


def _flat(tree, lo, hi, prefix):
    return {f"{prefix}.{n}": t for n, t in weights.flat_adapters(tree, lo, hi).items()}


class Program:
    def __init__(self, mc: dict, traffic: dict, seed: int, device):
        self.mc, self.tr, self.seed, self.device = mc, traffic, seed, torch.device(device)
        self.cuts = [c["cut"] for c in traffic["clients"]]
        self.tokens_per_round = len(self.cuts) * traffic["batch"] * traffic["seq_len"]
        self.readings = None
        self.rnd = 0

    def setup(self) -> None:
        from repro_torch.core.cost_model import DeviceProfile
        from repro_torch.data import EmotionDataset
        from repro_torch.fed.config import AggConfig, EngineConfig, FedRunConfig
        from repro_torch.fed.simulator import Simulator

        mc, tr, dev = self.mc, self.tr, self.device
        clock = _Clock()
        tokens, labels = _corpus(mc, tr, self.seed)
        train = EmotionDataset(tokens, labels)
        test = EmotionDataset(tokens[:tr["batch"]], labels[:tr["batch"]])
        devices = [DeviceProfile(c["name"], tflops=c["tflops"], mem_gb=c["mem_gb"])
                   for c in tr["clients"]]
        e, o = tr["engine"], tr["optimizer"]
        run = FedRunConfig(
            scheme=tr["scheme"], rounds=1, batch_size=tr["batch"], seq_len=tr["seq_len"],
            lr=o["lr"], alpha=tr["dirichlet_alpha"], seed=self.seed,
            eval_every=tr["eval_every"],
            engine=EngineConfig(mode="analytic", scheduler=e["scheduler"],
                                cohort_chunk=e["cohort_chunk"], cohort_impl=e["cohort_impl"],
                                fused_lora=e["fused_lora"]),
            agg=AggConfig(policy="sync", interval=tr["interval"]))
        clock.lap("corpus")
        self.sim = sim = Simulator(port.model_config(mc), devices, self.cuts, train, test, run,
                                   device=dev)
        clock.lap("Simulator")
        port.same_optimizer(sim.opt, o)
        self._write_weights()
        glob = weights.adapters(mc, self.seed, "global", dev, tr["lora_b_std"])
        head0 = sim.params["cls_head"]
        from repro_torch.core import lora as lora_lib
        cli, srv = [], []
        for cut in self.cuts:
            c, s = lora_lib.split_lora(glob, cut)
            cli.append(c)
            srv.append(lora_lib.embed_in_full_shape(s, glob, cut, "server"))
        sim.load_state_dict({
            "sim_clock": 0.0, "round": 0, "client_lora": cli, "server_lora": srv,
            "heads": [head0] * len(self.cuts),
            "client_opt": [tuple(sim.opt.init(c)) for c in cli],
            "server_opt": [tuple(sim.opt.init({"lora": s, "head": head0})) for s in srv]})
        clock.lap("weights and state")
        self._checked_rounds(glob, head0.clone())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        clock.lap("checked rounds")
        self.setup_log = clock.log

    def _write_weights(self) -> None:
        """The benchmark's weights into the Simulator's own tensors, in
        place; each client's view of the stack must share that storage."""
        sim = self.sim
        mine = weights.params(self.mc, self.seed, self.device)
        port.check_layout(mine, sim.params)

        def copy(dst, src):
            if isinstance(dst, dict):
                for k in dst:
                    copy(dst[k], src[k])
            else:
                dst.copy_(src)
        copy(sim.params, mine)
        ptr = sim.params["layers"]["attn"]["wq"].data_ptr()
        for pc in sim.client_params:
            if pc["layers"]["attn"]["wq"].data_ptr() != ptr:
                raise RuntimeError("a client's view of the weights does not share the "
                                   "Simulator's storage")

    def _checked_rounds(self, glob, head0) -> None:
        sim, tr, L = self.sim, self.tr, self.mc["n_layers"]
        inv = 1.0 / (1.0 - tr["optimizer"]["b1"])
        losses, grads = [], {}
        for r in range(tr["checked_rounds"]):
            losses.append(sim.run_round(self.rnd).mean_loss)
            self.rnd += 1
            if r == 0:
                for u, cut in enumerate(self.cuts):
                    mu_c, mu_s = sim.client_opt[u].mu, sim.server_opt[u].mu
                    g = {**_flat(mu_c, 0, cut, f"u{u}.c"),
                         **_flat(mu_s["lora"], cut, L, f"u{u}.s"),
                         f"u{u}.head": mu_s["head"]}
                    grads.update(compare.norms(g, inv))
        change = {}
        for u, cut in enumerate(self.cuts):
            now = {**_flat(sim.client_lora[u], 0, cut, f"u{u}.c"),
                   **_flat(sim.server_lora[u], cut, L, f"u{u}.s"),
                   f"u{u}.head": sim.heads[u]}
            was = {**_flat(glob, 0, cut, f"u{u}.c"), **_flat(glob, cut, L, f"u{u}.s"),
                   f"u{u}.head": head0}
            change.update(compare.norms({n: now[n] - was[n] for n in now}))
        self.readings = compare.Readings(losses, grads, change)

    def _round(self) -> None:
        self.sim.run_round(self.rnd)
        self.rnd += 1

    def window(self, seconds: float) -> dict:
        """Whole rounds until ``seconds`` have passed; the window ends when
        the device has finished the last one."""
        t_start = time.perf_counter()
        n = 0
        while time.perf_counter() < t_start + seconds:
            self._round()
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t_start
        return {"attempted": n * len(self.cuts), "failed": 0, "elapsed_s": elapsed,
                "tokens": n * self.tokens_per_round}

    def trace_slice(self) -> dict:
        from repro_torch.kernels.grouped_lora import grouped_lora_chunk, grouped_lora_direct
        from repro_torch.kernels.lora_matmul import lora_matmul
        mc, tr = self.mc, self.tr
        n = tr["trace_rounds"]

        def grouped():
            return grouped_lora_chunk.launches + grouped_lora_direct.launches

        before = (lora_matmul.launches, grouped())
        for _ in range(n):
            self._round()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rows, lanes, L = tr["batch"] * tr["seq_len"], len(self.cuts), mc["n_layers"]
        chunk = tr["engine"]["cohort_chunk"]
        if tr["engine"]["cohort_impl"] != "vmap" or chunk < lanes:
            raise NotImplementedError("the grouped calls are counted for one vmap "
                                      "dispatch of every lane")
        return {"attempted": n * lanes, "failed": 0, "tokens": n * self.tokens_per_round,
                "dtype": mc["dtype"],
                "model_flops": n * work.split_round_flops(mc, tr["batch"], tr["seq_len"],
                                                          self.cuts),
                "calls": {"grouped_lora": n * work.projection_calls(mc, lanes * rows, L,
                                                                    lanes, True),
                          "lora_matmul": n * [c for cut in self.cuts for c in
                                              work.projection_calls(mc, rows, cut, 1,
                                                                    False)]},
                "launches": {"lora_matmul": lora_matmul.launches - before[0],
                             "grouped_lora": grouped() - before[1]}}

    def free(self) -> None:
        self.__dict__.pop("sim", None)


def reference(mc: dict, tr: dict, seed: int, device, precision: str = "fp32",
              fault: str = "") -> compare.Readings:
    """The checked rounds, plainly, from the same inputs: the corpus, its
    split and each client's batch order worked out again from the seed.
    ``fault`` ("half_batch", "altered_answer") plants one of the
    comparison's faults in the reference put in the program's place."""
    device = torch.device(device)
    L = mc["n_layers"]
    cuts = [c["cut"] for c in tr["clients"]]
    o = tr["optimizer"]
    adam = Adam(o["lr"], o["b1"], o["b2"], o["eps"])
    params = weights.params(mc, seed, device)
    glob_tree = weights.adapters(mc, seed, "global", device, tr["lora_b_std"])
    glob = weights.flat_adapters(glob_tree, 0, L)
    head0 = params["cls_head"]
    tokens, labels = _corpus(mc, tr, seed)
    parts = data.dirichlet_split(labels, len(cuts), tr["dirichlet_alpha"], seed)
    n_rounds = tr["checked_rounds"]
    rows = [data.batch_rows(len(p), tr["batch"], seed + u, n_rounds)
            for u, p in enumerate(parts)]
    batches = [[(torch.as_tensor(tokens[parts[u][rows[u][r]]]).to(device),
                 torch.as_tensor(labels[parts[u][rows[u][r]]]).to(device))
                for u in range(len(cuts))] for r in range(n_rounds)]
    losses, first, state = ref_fed.run_rounds(
        mc, Precision(precision), params, glob, head0, cuts, batches,
        [len(p) for p in parts], tr["interval"], adam, n_rounds,
        drop_rows=tr["batch"] // 2 if fault == "half_batch" else 0,
        zero_client_grads=0 if fault == "altered_answer" else -1)
    grads, change = {}, {}
    for u, (g, st) in enumerate(zip(first, state)):
        grads.update(compare.norms({**{f"u{u}.c.{n}": t for n, t in g["c"].items()},
                                    **{f"u{u}.s.{n}": t for n, t in g["s"].items()},
                                    f"u{u}.head": g["head"]}))
        now = {**{f"u{u}.c.{n}": t for n, t in st["c"].items()},
               **{f"u{u}.s.{n}": t for n, t in st["s"].items()}, f"u{u}.head": st["head"]}
        was = {**{f"u{u}.c.{n}": glob[n] for n in st["c"]},
               **{f"u{u}.s.{n}": glob[n] for n in st["s"]}, f"u{u}.head": head0}
        change.update(compare.norms({n: now[n] - was[n] for n in now}))
    return compare.Readings(losses, grads, change)
