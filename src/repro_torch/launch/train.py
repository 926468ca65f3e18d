"""End-to-end training entry point.  Port of ``src/repro/launch/train.py``.

Two modes:
  * ``--mode central``: centralized LoRA fine-tuning of ``--arch`` on a
    synthetic LM stream (``make_full_train_step`` on the masked path; runs
    at full width on the card, or on the CPU with ``--reduced``).  AdamW
    runs at the constant ``--lr`` unless ``--schedule``, ``--weight-decay``
    or ``--grad-clip`` ask for more.
  * ``--mode sfl``: the paper's memory-efficient split-federated loop with
    the heterogeneous device fleet of §V (BERT-family classification).

Runs on the CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpointing import save as save_ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.core.splitfl import make_full_train_step
from repro_torch.data import lm_batches, lm_stream, make_emotion_dataset
from repro_torch.device import resolve_device
from repro_torch.fed import (PAPER_CLIENTS, PAPER_CUTS, AggConfig, EngineConfig,
                             FedRunConfig, Simulator)
from repro_torch.models import build_model
from repro_torch.numerics import set_fp32_policy
from repro_torch.optim import AdamW, schedules


def make_optimizer(args) -> AdamW:
    """The central run's AdamW: the reference's ``AdamW(lr)`` under the
    default flags; else ``--lr`` read through ``--schedule`` at the int32
    step, with decoupled ``--weight-decay`` and global-norm ``--grad-clip``."""
    lr = {"constant": lambda: args.lr,
          "warmup-cosine": lambda: schedules.linear_warmup_cosine(args.lr, args.warmup,
                                                                  args.steps),
          "inverse-sqrt": lambda: schedules.inverse_sqrt(args.lr, args.warmup)}[args.schedule]
    return AdamW(lr(), weight_decay=args.weight_decay, grad_clip_norm=args.grad_clip)


def run_central(args):
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, n_layers=args.layers, d_model=args.d_model)
    model = build_model(cfg, device)
    gen = torch.Generator(device=device)
    params = model.init_params(gen.manual_seed(args.seed))
    lora = model.init_lora(gen.manual_seed(args.seed + 1))
    opt = make_optimizer(args)
    opt_state = opt.init(lora)
    step_fn = make_full_train_step(model, opt, remat=False, path="scan")

    stream = lm_stream(200_000, cfg.vocab_size, seed=args.seed)
    batches = lm_batches(stream, args.batch, args.seq, seed=args.seed)
    t0 = time.time()
    losses = []
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v).to(device) for k, v in next(batches).items()}
        loss, lora, opt_state = step_fn(params, lora, opt_state, batch)
        losses.append(float(loss))
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            print(f"step {step+1:5d} loss={np.mean(losses[-args.log_every:]):.4f} "
                  f"({dt/ (step+1):.3f}s/step)")
    if args.ckpt:
        save_ckpt(args.ckpt, {"lora": lora, "opt": tuple(opt_state)})
        print(f"saved adapters to {args.ckpt}")
    print(f"final loss {np.mean(losses[-10:]):.4f} "
          f"(first-10 {np.mean(losses[:10]):.4f})")
    return losses


def run_sfl(args):
    cfg = get_config("bert-base")
    if args.reduced:
        cfg = reduced(cfg, n_layers=args.layers, d_model=args.d_model)
        cfg = cfg.with_(vocab_size=4096, max_position=max(args.seq, 64))
    train = make_emotion_dataset(args.n_train, seq_len=args.seq,
                                 vocab_size=cfg.vocab_size, seed=args.seed)
    test = make_emotion_dataset(args.n_train // 5, seq_len=args.seq,
                                vocab_size=cfg.vocab_size, seed=args.seed + 1)
    cuts = list(PAPER_CUTS)
    if args.reduced:  # clamp cuts to the reduced depth
        cuts = [min(c, cfg.n_layers - 1) for c in cuts]
    run = FedRunConfig(scheme=args.scheme, engine=EngineConfig(scheduler=args.scheduler),
                       rounds=args.steps, agg=AggConfig(interval=args.agg_interval),
                       batch_size=args.batch, seq_len=args.seq, lr=args.lr,
                       eval_every=args.log_every, seed=args.seed)
    sim = Simulator(cfg, PAPER_CLIENTS, cuts, train, test, run, device=args.device)
    sim.run_training(verbose=True)
    rep = sim.server_memory_report()
    print(f"[{args.scheme}] simulated time {sim.sim_clock:.1f}s  "
          f"server memory {rep.total_mb:.1f} MB")
    return sim


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=("central", "sfl"), default="central")
    ap.add_argument("--arch", default="granite-3-2b",
                    help="a registered config of the dense, moe, vlm, ssm or hybrid family")
    ap.add_argument("--scheme", default="ours", choices=("ours", "sfl", "sl"))
    ap.add_argument("--scheduler", default="ours",
                    choices=("ours", "fifo", "wf", "optimal"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="constant",
                    choices=("constant", "warmup-cosine", "inverse-sqrt"),
                    help="central mode: how the learning rate follows the step "
                         "(warmup-cosine decays to a tenth of --lr at --steps)")
    ap.add_argument("--warmup", type=int, default=10,
                    help="central mode: warmup steps of the two schedules (>= 1)")
    ap.add_argument("--weight-decay", type=float, default=0.0,
                    help="central mode: AdamW's decoupled weight decay")
    ap.add_argument("--grad-clip", type=float, default=None,
                    help="central mode: clip the gradients to this global L2 norm")
    ap.add_argument("--agg-interval", type=int, default=5)
    ap.add_argument("--n-train", type=int, default=2000)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    set_fp32_policy()
    if args.mode == "central":
        run_central(args)
    else:
        run_sfl(args)


if __name__ == "__main__":
    main()
