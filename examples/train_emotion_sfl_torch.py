"""End-to-end example on PyTorch, the twin of ``examples/train_emotion_sfl.py``:
split-federated LoRA fine-tuning of a BERT-family model on the CARER-shaped
emotion task across the paper's six heterogeneous devices, for the schemes
``ours``, ``sfl`` and ``sl`` (a ``-fifo`` / ``-wf`` suffix picks a scheduling
baseline), with the analytic engine or the event-driven clock (sync, or
async ``buffered`` / ``staleness`` federation) over the network plane.

Default is a ~29M-parameter BERT-small sized model; ``--full`` selects the
paper's exact BERT-base (110M) at the paper's cuts; ``--tiny`` a 2-layer
smoke model.  The run is on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/train_emotion_sfl_torch.py --full --rounds 20
    PYTHONPATH=src python examples/train_emotion_sfl_torch.py --tiny --rounds 3 \
        --schemes ours,sfl,sl --device cpu

Continuous-time async federation (the reference example's event setting):

    PYTHONPATH=src python examples/train_emotion_sfl_torch.py --tiny --rounds 3 \
        --engine event --agg-policy buffered --max-inflight-rounds 2 --device cpu

Online cut re-assignment at commit boundaries (the control plane):

    PYTHONPATH=src python examples/train_emotion_sfl_torch.py --tiny --rounds 3 \
        --engine event --controller reactive --device cpu

Kill and resume (a mid-flight snapshot every 0.02 simulated s, the server
preempted at 0.05 s, then the run continued from the latest snapshot; the
resumed run ends as the uninterrupted one would):

    PYTHONPATH=src python examples/train_emotion_sfl_torch.py --tiny --rounds 3 \
        --engine event --agg-policy buffered --max-inflight-rounds 2 --device cpu \
        --snapshot-every 0.02 --snapshot-dir snaps --kill-at 0.05
    PYTHONPATH=src python examples/train_emotion_sfl_torch.py --tiny --rounds 3 \
        --engine event --agg-policy buffered --max-inflight-rounds 2 --device cpu \
        --resume-from snaps

The script takes every flag of the reference's, and ``--device``.
"""
import argparse

import numpy as np

from repro_torch.configs import REGISTRY, reduced
from repro_torch.core.partition import assign_cuts
from repro_torch.data import make_emotion_dataset
from repro_torch.control import CONTROLLERS
from repro_torch.fed import (AggConfig, ControlConfig, EngineConfig, FedRunConfig,
                             NetConfig, ObsConfig, PAPER_CLIENTS, PAPER_CUTS, Simulator,
                             validate_run_config)
from repro_torch.fed.engine import AGG_POLICIES
from repro_torch.net import bundled_trace
from repro_torch.numerics import set_fp32_policy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="paper's BERT-base 110M")
    ap.add_argument("--tiny", action="store_true", help="2-layer smoke model")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--agg-interval", type=int, default=None,
                    help="rounds per sync aggregation (default 5; async "
                    "policies commit per agg-buffer-k uploads, default 1)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schemes", default="ours",
                    help="comma list from: ours,sfl,sl,ours-fifo,ours-wf")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--n-train", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    # -- server engine / continuous-time async federation
    ap.add_argument("--engine", choices=("analytic", "event"), default="analytic",
                    help="closed-form Eq. 10-12 vs event-driven clock")
    ap.add_argument("--agg-policy", choices=AGG_POLICIES, default="sync",
                    help="sync barrier | buffered k-of-U | staleness-weighted")
    ap.add_argument("--max-inflight-rounds", type=int, default=1,
                    help="local rounds a client may run past its last commit")
    ap.add_argument("--agg-buffer-k", type=int, default=None,
                    help="async commit threshold (distinct client uploads)")
    ap.add_argument("--staleness-alpha", type=float, default=None,
                    help="polynomial (1+s)^-alpha discount exponent "
                    "(staleness policy only; default 0.5)")
    # -- network plane
    ap.add_argument("--link-model", choices=("constant", "trace", "gilbert"),
                    default="constant",
                    help="per-client link process (trace = the bundled 4G/5G "
                    "bandwidth trace, per-client time-rotated; gilbert = seeded "
                    "good/bad Markov fading; both need --engine event)")
    ap.add_argument("--shared-medium", action="store_true",
                    help="concurrent transfers split one cell per direction")
    ap.add_argument("--medium-capacity-mbps", type=float, default=None,
                    help="cell capacity (required with --shared-medium)")
    ap.add_argument("--agg-transport", choices=("nominal", "plane"), default="nominal",
                    help="route adapter syncs through the network plane "
                    "instead of the scalar nominal link")
    # -- adaptive control plane
    ap.add_argument("--controller", choices=CONTROLLERS, default="static",
                    help="online cut re-assignment at commit boundaries "
                    "(needs --engine event)")
    ap.add_argument("--resolve-every", type=int, default=1,
                    help="periodic controller: commits between re-solves")
    ap.add_argument("--hysteresis", type=float, default=None,
                    help="reactive controller: relative rate band "
                    "(default 0.25)")
    # -- mid-flight checkpoint / resume
    ap.add_argument("--snapshot-every", type=float, default=None,
                    help="write a full mid-flight snapshot every N SIMULATED "
                    "seconds (needs --snapshot-dir and --engine event)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="rotated snapshot directory (atomic writes)")
    ap.add_argument("--resume-from", default=None,
                    help="resume from a snapshot file or directory written "
                    "by an identically configured run")
    ap.add_argument("--kill-at", type=float, default=None,
                    help="fault injection: preempt the server at this "
                    "simulated instant (resume later with --resume-from)")
    ap.add_argument("--trace-out", default=None, metavar="DIR",
                    help="record spans + metrics + memory ledger and write a "
                    "Perfetto-loadable trace.json under DIR (one subdir per "
                    "--schemes entry; needs --engine event)")
    ap.add_argument("--cohort-impl", choices=("vmap", "ragged"), default="vmap",
                    help="batched server step of a cohort chunk (one client "
                    "per dispatch here, as in the reference's default)")
    ap.add_argument("--fused-lora", action="store_true",
                    help="run adapted projections through the hand-written "
                    "fused LoRA kernel (its plain version on the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the models run (default: the CUDA card)")
    args = ap.parse_args()
    if args.agg_interval is None:
        args.agg_interval = 5 if args.agg_policy == "sync" else 1
    if (args.snapshot_dir or args.resume_from or args.kill_at) \
            and len(args.schemes.split(",")) > 1:
        # entries would share one snapshot directory: a later entry's
        # rotation deletes an earlier preempted entry's snapshots
        ap.error("--snapshot-dir/--resume-from/--kill-at work with a "
                 "single --schemes entry")
    set_fp32_policy()

    if args.full:
        cfg = REGISTRY["bert-base"]
        args.seq = 128
    elif args.tiny:
        # conftest-sized smoke model: 2 layers, d=256
        cfg = reduced(REGISTRY["bert-base"], n_layers=2, d_model=256)
        cfg = cfg.with_(vocab_size=4096, max_position=32, dtype="float32")
        args.seq = min(args.seq, 16)
        args.batch = min(args.batch, 4)
        args.n_train = min(args.n_train, 400)
    else:
        # bert-small-ish: 4 layers, d=512 -> ~29M params
        cfg = reduced(REGISTRY["bert-base"], n_layers=4, d_model=512)
        # reduced() caps vocab at 512 but the emotion corpus spans ~6.4k ids
        cfg = cfg.with_(n_heads=8, n_kv_heads=8, head_dim=64, vocab_size=8192,
                        max_position=max(64, args.seq), dtype="float32")

    train = make_emotion_dataset(args.n_train, seq_len=args.seq,
                                 vocab_size=cfg.vocab_size, seed=args.seed)
    test = make_emotion_dataset(args.n_train // 5, seq_len=args.seq,
                                vocab_size=cfg.vocab_size, seed=args.seed + 1)

    if args.full:
        cuts = list(PAPER_CUTS)            # the paper's §V assignment
    else:
        cuts = assign_cuts(cfg, PAPER_CLIENTS, args.batch, args.seq,
                           max_cut=cfg.n_layers - 1)
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.0f}M params, "
          f"{cfg.n_layers} layers)  cuts={cuts}")

    # "trace" drives every client from the bundled bandwidth trace,
    # time-rotated per client so fades hit at different instants
    link_traces = None
    if args.link_model == "trace":
        bp, rates = bundled_trace()
        link_traces = [(bp, np.roll(rates, 17 * i).tolist())
                       for i in range(len(PAPER_CLIENTS))]

    # validate every schemes entry up front, so a bad late entry does not
    # abort the script after earlier entries trained
    runs = []
    for entry in args.schemes.split(","):
        scheme, _, sched = entry.partition("-")
        run = FedRunConfig(scheme=scheme, rounds=args.rounds,
                           batch_size=args.batch, seq_len=args.seq,
                           lr=args.lr, alpha=args.alpha, seed=args.seed,
                           eval_every=max(args.rounds // 10, 1),
                           snapshot_every=args.snapshot_every,
                           snapshot_dir=args.snapshot_dir,
                           resume_from=args.resume_from,
                           preempt_at=args.kill_at,
                           engine=EngineConfig(mode=args.engine, scheduler=sched or "ours",
                                               cohort_impl=args.cohort_impl,
                                               fused_lora=args.fused_lora),
                           agg=AggConfig(policy=args.agg_policy, interval=args.agg_interval,
                                         buffer_k=args.agg_buffer_k,
                                         max_inflight=args.max_inflight_rounds,
                                         staleness_alpha=args.staleness_alpha,
                                         transport=args.agg_transport),
                           net=NetConfig(link_model=args.link_model, traces=link_traces,
                                         shared=args.shared_medium,
                                         capacity_mbps=args.medium_capacity_mbps),
                           control=ControlConfig(policy=args.controller,
                                                 resolve_every=args.resolve_every,
                                                 hysteresis=args.hysteresis),
                           obs=(ObsConfig(trace=True, metrics=True, memory_ledger=True,
                                          trace_dir=f"{args.trace_out}/{entry}")
                                if args.trace_out else ObsConfig()))
        try:
            validate_run_config(run, len(PAPER_CLIENTS))
        except (KeyError, ValueError) as e:
            ap.error(f"--schemes entry {entry!r}: {e}")
        runs.append((entry, run))

    for entry, run in runs:
        sim = Simulator(cfg, PAPER_CLIENTS, cuts, train, test, run, device=args.device)
        sim.run_training(verbose=True)
        if sim.clock_result is not None and sim.clock_result.preempted:
            print(f"== {entry}: PREEMPTED at t={sim.sim_clock:.3f}s "
                  f"(snapshots in {run.snapshot_dir}; rerun with "
                  f"--resume-from to continue)\n")
            continue
        acc, f1 = sim.evaluate()
        mem = sim.server_memory_report()
        print(f"== {entry} [{args.engine}/{args.agg_policy}]: acc={acc:.4f} f1={f1:.4f} "
              f"sim_time={sim.sim_clock:.1f}s server_mem={mem.total_mb:.1f}MB")
        if args.trace_out:
            report = sim.obs.ledger.report()
            print(f"   trace: {run.obs.trace_dir}/trace.json  worst client peak "
                  f"{report['worst_client_peak_bytes'] / 2**20:.1f} MiB, "
                  f"{report.get('client_reduction_vs_local', 0.0):.0%} below "
                  f"local fine-tuning; {len(sim.discarded_updates)} local updates "
                  f"lost a race to a commit")
        if args.controller != "static":
            events = sim.control_events
            print(f"   control ({args.controller}): {len(events)} decisions, "
                  f"{sum(ev.applied for ev in events)} applied; cuts {sim.cuts}")
            for ev in events:
                print(f"     t={ev.time:.3f}s commit {ev.version} {ev.trigger}: "
                      f"cuts {ev.cut_changes} gain {ev.predicted_gain_s:.4f}s "
                      f"migration {ev.migration_s} applied={ev.applied}")
        print()


if __name__ == "__main__":
    main()
