#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every CUDA kernel (lora_matmul, grouped_lora, quant,
   flash_attention, wkv6), compiled
   with nvcc from the sources in this checkout, one nvcc per source, all
   at once; ptxas's register and shared-memory lines are printed, and the
   count of tensor-core instructions (HMMA, HGMMA) in each library's SASS,
   which must hold HGMMA (wgmma) in lora_matmul, grouped_lora and
   flash_attention, and in every instance of grouped_lora's direct-mode
   tiles (HGMMA in bf16, HMMA in fp32), with no function of the SIMT
   direct body left;
3. kernel check: each kernel against its plain PyTorch version on the card,
   forward and backward, at its path's shape and at ragged shapes (the
   quantize kernel bit for bit, .5 ties and a zero row included, in f32
   and bf16 at the cohort shape, timed, and both of its bodies at wide
   and unaligned rows), with times for the kernel, the plain version and
   the base product;
   lora_matmul also on the .t() views of W, A and B that its backward
   passes, at M, N and K off its 128 x 96 x 32 tiles (N 130 and 770) and
   at r 5, 16 and 64; at the main shape its error against exact (fp64)
   products, split into what the TF32 operand split and what the kernel's
   accumulation contribute (``lora_error_sources``); grouped_lora also on
   the views of W, B and A its backward passes (the dx call's layout), and
   at the cohort shape its errors against fp64 products forward and on
   that dx call (``grouped_error_sources``), beside the plain fp32
   version's; in bf16, lora_matmul at gemma-2b's q and k/v projections
   and rwkv6-3b's three projection shapes over the prefill's 8192 rows
   (timed, with the bf16 base product, the bound at the bf16 tensor-core
   peak, the mma.sync tile at the same shape (A misaligned by one
   element, which sends the call there) and the error against exact
   products, held within 5 % of the plain version's), at zamba2-7b's
   in_proj (K 3584, N 14576: the last 256-wide tile partial; timed, the
   same readings), at the reference's
   sweep shapes and ranks and at ragged shapes; lora_matmul fp32 at the
   MoE router's shapes over 8192 rows (qwen3-moe's d 2048 to 128 experts,
   timed, whose dx call has K 128; grok-1's d 6144 to 8); grouped_lora in chunk mode
   (the 2-tenant prefill's q-projection, timed, and ragged cohorts) and
   direct mode, each also on the backward's views and for dx, dA and dB
   (each output row's error over its own scale, <= 1e-2); each result
   names the tile that ran (``tma_ok``: wgmma, else mma.sync); direct
   mode in both types at its timed shapes (K 128: fp32 over two groups of
   2048 rows, N 768; bf16 over two of 4096, N 2048), beside chunk mode on
   the same inputs and the base product, the bf16 one's error against
   exact products held within 5 % of the plain version's, and at ragged
   shapes and K 770 (each result names its body: ``resident`` or the K
   sweep, and its dx call's); fp32 direct mode also where the MoE cohort
   steps run it, the router's dx call (three lanes of 1024 rows, K 128,
   N 2048, timed);
4. main path: the paper's split-federated round at the full width of
   bert-base (12 layers, d 768, vocab 30522, seq 128, batch 16) across the
   six paper clients at the paper cuts, scheme "ours", analytic engine,
   2 rounds with one aggregation and one evaluation, through the fused
   kernel; the kernel's launch count must equal the count derived in
   PERF.md;
5. comparison: the same run on the reference's default einsum path; the
   per-round losses must agree;
6. cohort path: the same run with all six clients in one server dispatch
   chunk (cohort_chunk=6, cohort_impl="ragged": three cut groups of two,
   each one grouped-kernel dispatch) and int8 links with error feedback
   (net quantize=True), fused and then einsum; the launches of every
   kernel per round must equal the counts derived in PERF.md, the losses
   of the two runs must agree and their simulated times be equal;
   then the same cohort path on the vmap cohort step (cohort_impl="vmap":
   one masked dispatch of all six lanes over every layer, each lane at its
   own cut), fused and einsum: the grouped kernel once per projection of
   each layer a round whatever the cuts (2*T*L, asserted), its losses
   within 1e-3 of the ragged run's on the same data and its simulated
   times equal, wall time and peak memory printed beside the ragged run's;
   then the split-learning baseline (scheme "sl": one traveling adapter
   set, clients one after the other), 2 rounds through the fused kernel,
   its launches asserted by the main path's rule; and the paper's memory
   model (``server_memory_report``) for ours, sfl and sl printed beside
   each run's measured peak device memory;
7. event: the main path under the event-driven federation clock
   (mode "event", sync FedAvg every 2 rounds, fused): each round's
   simulated time within 1e-12 (relative) of the analytic engine's closed
   form over the order the clock served (under scheduler "ours" the clock
   serves by Alg. 2's online form, which may differ from the analytic
   run's fixed order; both times are printed), its losses within 1e-6 of
   the analytic fused run's, its lora_matmul launches equal to that run's;
   then the reference example's async event setting at the same width:
   buffered commits (two local rounds in flight) fused and einsum, and
   staleness commits fused, over Gilbert-Elliott links sharing one
   200 Mbps cell, adapter syncs routed through the network plane, int8
   links, ragged chunks of up to 3 clients formed by the clock, and every
   observability sink on (the Chrome trace written to a temporary
   directory, loaded and summarised by track, the metrics counters and the
   memory ledger's modelled peaks printed beside the measured peak); the
   launches of lora_matmul, grouped_lora (chunk) and quantize_rows are
   asserted by a rule over the clock's serve events
   (``expected_event_launches``), the fused run's loss events, discarded
   updates and simulated times must equal the einsum run's and its losses
   agree within 1e-3, and at least one run must discard a local update
   that a commit overtook;
8. control: the cohort path under the event clock (chunks of up to 3 on
   the ragged step, int8 links, every obs sink on) with a reactive
   controller, fused and einsum: sync rounds with a commit after each, the
   memory budget of client 4 (cut 3) cut before the run to below its
   cut-3 footprint, so the first commit sheds a layer; and buffered async
   commits (one local
   round in flight, plane-routed adapter syncs) with client 4's link (cut
   3) fading from 100 to 4 Mbps at 0.3 simulated s, so the fade trigger
   re-plans it.  In each run at least one cut change is applied, the
   migrated clients' frozen prefixes and steps follow the live cuts, the
   decision log, simulated times, loss-event keys and discards equal the
   CPU prediction (``--predict-control``, below) and the other
   run's, the launches of lora_matmul, grouped_lora (chunk) and
   quantize_rows equal ``expected_event_launches`` at the cuts in force at
   each serve event (in the sync run they differ from the rule at the
   initial cuts), losses agree within 1e-3, and the trace holds one
   ``reassign`` span per decision;
9. resume: the buffered event run of phase 7 and both controlled runs of
   phase 8 (fused), each run again with a mid-flight snapshot every
   ``RESUME_KNOBS`` simulated seconds into a temporary directory (removed
   at the end) and preempted, then resumed from the latest snapshot in a
   fresh Simulator: the clock's state_dict JSON, the history, loss events,
   discards, control decisions and cuts, the obs outputs (trace, metrics,
   ledger) and, by ``torch.equal``, the final global adapters and head
   must equal the uninterrupted run's; the snapshot instants, the resumed
   snapshot's instant, cuts, in-flight pulls, residuals and serves, and the
   serves replayed between it and the kill must equal the CPU prediction
   (``--predict-resume``, below); the resumed run's launches of
   lora_matmul, grouped_lora (chunk) and quantize_rows must equal
   ``launch_rule`` over the serves the resumed clock performed, at the
   cuts in force at each; snapshot bytes beside the leaves' bytes from
   their shapes, save and load wall times and the resumed run's peak
   memory are printed;
9b. population: FleetSpec fleets at bert-base's full width (fp32, fused
   unless named): ``[population:sim]``, the Simulator on 24 clients of a
   FleetSpec, sync FedAvg each round, Pareto cohorts of half the fleet,
   stragglers at 0.3, three k-means edge cells, ragged chunks of up to 6,
   int8 links, 2 rounds, fused and einsum (losses within 1e-3, timelines
   equal); ``[population:exact]``, ``train_population`` against the
   Simulator on one 12-client FleetSpec below the population threshold,
   sync (Pareto 0.6, the vmap step, two cells) and buffered async (the
   ragged step): loss events, history rows, every global-adapter leaf and
   the makespan bit for bit; ``[population:scale]``, ``train_population``
   on 10^4 clients (Pareto cohorts of 30, four k-means cells, vectorized
   rounds, ragged chunks of 8 on four slots, 3 rounds and an evaluation):
   finite losses, the resident slots at each commit at most a cohort, wall
   s, peak bytes and resident bytes printed.  Every run's cohorts,
   straggler draws, edge cells, simulated times, loss-event keys, chunks
   and launches (``launch_rule``, also under vmap) equal the CPU
   prediction (``--predict-population``, below);
10. LM kernel check: the flash-attention kernel at the gemma-2b prefill
   shape (B 4, S = T 2048, H 8, K 1, D 256, causal) in bf16 and fp32 and
   at a GQA shape with a ragged T (2, 1000, 32 heads, 8 kv heads, 64;
   causal with window 256, and non-causal) and, in bf16, at D 64 and 128
   (ragged S != T, and GQA with a window), at qwen3-moe's prefill shape
   (4 x 2048, 32 heads on 4 kv heads, D 128, causal; timed) and at
   granite-3-2b's (32 on 8, D 64), at zamba2-7b's shared attention (4 x
   2048, 32 heads on 32, D 112: the 128-wide tile, zero past D; causal;
   bf16 and fp32, timed) and at whisper-large-v3's encoder (4 x 1500, 20
   heads, D 64, non-causal; timed), beside PyTorch's
   scaled_dot_product_attention as the yardstick, in bf16 each shape also
   through the normalise-first instance (held and, where timed, timed);
   the kernel pair (``check_flash_pair``: the forward's lse and its online
   and normalise-first instances, the backward's dq, dk, dv from each, per
   row and over the tensor, beside a bf16-dS control that must fail, two
   backward calls bit-equal) at granite-3-2b's server step (16 x 512, 32
   heads on 8, D 64, causal; timed, SDPA's backward the yardstick) and at
   ragged S and T, MQA and windows; the WKV6 kernel at the
   rwkv6-3b prefill shape (B 4, T 2048, H 40, D 64; bf16 r/k/v with an f32
   decay, and fp32) and at a ragged T of 1000, with slow decays and with
   fast ones (exp(-exp(z)), z ~ N(0, 1): many near 0), at T 37, and at
   every head dimension it takes (16, 32, 64, 128); each against its plain
   version (flash: each query row's error over that row's own scale;
   WKV6: over the output's; <= 1e-5 in fp32, <= 1e-2 in bf16; the final
   state <= 1e-5);
11. LM prefill: gemma-2b (at full depth) and rwkv6-3b (8 of its 32
   layers, ``LM_PHASE_LAYERS``) at full width in bf16 with random weights,
   4 prompts of 2048 tokens, under attn_impl / wkv_impl "chunked" (the
   kernels: 18 flash launches, 8 WKV6 launches) and under
   "naive" / "scan" in plain PyTorch (``PlainAttention``: no launch, though
   "naive" runs the flash kernel's normalise-first instance on the card in
   bf16); then every layer of both
   settings on the same input (the plain run's), so that each layer's
   output, its cache leaves and the last-token logits are held together
   (LM_TOL) without the depth amplifying one layer's bf16 rounding; the
   same prefill with LoRAConfig(impl="fused") (bf16 lora_matmul, one
   launch per adapted projection, asserted, every one on the wgmma tile)
   and with two tenants' adapters stacked into a group (bf16 grouped_lora
   chunk, asserted the same way), each held layer by layer against the
   einsum prefill (per tenant for the group);
11b. the MoE, VLM and dense completions, the same way at full width in
   bf16 (``NEW_LM_PHASES``): qwen3-moe-30b-a3b at full depth, qwen1.5-4b
   with random qkv biases, internvl2-26b on 1024 random vision embeddings
   before 1024 text tokens, grok-1-314b cut to 2 layers; for the MoE family
   each layer's output is held in the relative 2-norm over the whole
   tensor and each layer's routing flips printed (``layerwise_prefill``),
   the router's adapter runs fp32 lora_matmul (fused) or fp32 grouped_lora
   chunk (two tenants), asserted by count; qwen3-moe also served with one
   tenant (three requests), qwen1.5-4b also on an int8 KV cache, its
   per-step logits within the reference's 5e-2 of the model-type cache's
   over the steps both fed alike (``int8_cache_gap``), greedy agreement
   printed;
11c. the hybrid and the encoder-decoder (``FAMILY_LM_PHASES``) at full
   width and depth in bf16: zamba2-7b the same way as 11 (its plain
   setting attn_impl "naive" with the same plain chunked SSD, which has no
   kernel; 14 flash launches, one a segment; 218 fused and 218 grouped
   bf16 LoRA launches; the layer-by-layer holds run the shared block after
   each segment, and the LoRA prefills' every block held against fp32
   (``Fp32Hold``), the einsum path's distance printed; the decode check also holds every Mamba2 layer's
   conv history and state and every segment's K/V against the prefill's);
   whisper-large-v3 on 4 x 1500 random frames and prompts of 448 tokens
   (``lm_phase_encdec``: 96 flash launches, the encoder's 32 and the
   decoder's 64 self- and cross-attentions, and none in the plain
   setting; 384 fused and
   384 grouped bf16 LoRA launches; held encoder and decoder layer by
   layer; its decode from a fresh cache holding the prefill's
   cross-attention K/V, every step's logits against the teacher-forced
   ones; no ServingEngine: it has no frames to encode);
11d. build: every registered config, all eleven, through ``build_model``
   on the card (``build_phase``) at full width and 2 layers, a 128-token
   forward (whisper-large-v3: its 1500 frames) with finite hidden states;
12. LM serving: a ServingEngine per model with two tenants (every adapter
   leaf ~ N(0, 0.05), as in tests/test_serving.py), six greedy requests
   of 16-64 prompt tokens and 16 new tokens in 4 slots of a 128-token
   cache; every request completes, the stats hold, decode launches
   neither kernel; and for one prompt, every layer's decode, token by
   token from its own cache, agrees with that layer's prefill on the same
   input (LM_TOL);
13. LM backward: the gradient of a token cross-entropy with respect to
   the adapters, gemma-2b and rwkv6-3b at full width and 4 layers, 2 x 512
   tokens, attn_impl / wkv_impl "chunked" (under grad the plain chunked
   forms run), fused (bf16 lora_matmul forward and dx, launches asserted,
   every one on the wgmma tile)
   against einsum: the loss within 1e-2; gemma-2b's end-to-end adapter
   gradients within 1e-1; and layer by layer from shared inputs, every
   adapter leaf's gradient within 5e-2 of fp32 where the einsum path is
   too (the other leaves listed, at least one held a layer);
14. LM training: gemma-2b at full width and depth, rwkv6-3b at full
   width and 4 layers, qwen3-moe-30b-a3b at full width and 8 layers,
   zamba2-7b at 12 (sliced against scan at cuts 6 and 3) and
   whisper-large-v3 at 4 + 4 layers (cut 2, its one path: no scan or
   cohort step), bf16, fused LoRA, 2 x 512 tokens, a mid cut (for the MoE family the
   rules of ``lm_train``'s docstring: logits bit for bit and the aux
   rule for sliced against scan, remat on and off bit for bit, vmap lanes
   against their own scan steps, ragged lanes against sliced steps (neither
   has the aux), the router's grouped dx call in direct mode): the
   LM server step on the sliced path against the scan path on the same
   inputs, bit for bit; three split steps (client forward, server step,
   client backward) on one repeated batch, whose loss must fall; the full
   train step with remat off and on for two steps, bit for bit; and the
   LM cohort step over three lanes at three cuts, vmap and ragged against
   the three sequential steps (losses, dv and each lane's adapter
   gradients, read from its optimizer state; zamba2-7b's dv and gradients
   held on the same steps run again in fp32); every call's bf16
   lora_matmul or grouped
   launches asserted (all on the wgmma tile), and whisper-large-v3's flash
   pair (its encoder, decoder self- and cross-attention train through the
   forward with lse and the backward kernels: a forward launch per
   attention a pass, two backward launches per attention differentiated),
   its wall s, peak bytes and device s printed;
15. launch: ``python -m repro_torch.launch.train`` in central mode on
   granite-3-2b (its default arch) at full width for three steps in a
   process of its own, with
   the warmup-cosine schedule, weight decay and gradient clipping, which
   must print the reference's lines with a finite loss; then, each in a
   process of its own, ``launch.serve`` at the reference's defaults (its
   two lines, a (4, 32) token array), ``launch.dryrun`` of gemma-2b's
   prefill_32k at full width and depth under ``--attn-impl chunked
   --execute --batch 1`` (18 flash launches, the peak under the card's
   memory, ops.flops within 10 % of ``prefill_flops``; step s, roofline
   terms and mfu_bound printed), flash at that attention shape (1 x 32768,
   8 heads on 1 of 256) held on its last 1024 query rows against the
   plain version's arithmetic and timed, and ``launch.dryrun
   --server-resume --execute`` on granite-3-2b at full width, one step at
   cuts 10 and 30 (finite losses, dv of the input's shape);
16. summary: the phases' total wall time, one JSON line per ported
   kernel, then the device line last.

Every launch counter is set to 0 just before each path runs and read just
after it.  ``--profile`` adds a phase before the summary: one warm round of
the main path (fused and einsum) and of the cohort path (fused), and a
whole fused event run (sync, and buffered async), under
``torch.profiler``, with the device time by kernel, the host time by
operator, and the device's busy share of the wall time.

    python3 chip_smoke.py --ab OLD_ROOT

compares the port of another checkout (a parent commit, unpacked with
``git archive <commit> | tar -x -C OLD_ROOT`` into a directory that
``.gitignore`` lists) with this one on the same card, and does nothing
else: four processes in the order old, new, new, old, each importing and
building its own checkout's port, each printing one ``[ab] {json}`` line
(``ab_measure``: every kernel at its path's shape (fp32 lora_matmul and
grouped chunk, bf16 lora_matmul and grouped chunk at gemma-2b's
q-projection, quantize_rows, flash, WKV6), grouped direct mode at its two
timed shapes, bf16 quantize_rows where the checkout takes it, a warm main
and a warm cohort
round under the profiler, the cohort server step fused against einsum,
the cohort rounds' loss gap with int8 links on and off, a gemma-2b and an
rwkv6-3b prefill, and the rwkv6-3b prefill with fused bf16 LoRA).

    python3 chip_smoke.py --predict-control

needs no card: it replays the ``[control]`` phase's two runs on the CPU
(``predict_control``), prints each run's decision log, simulated times,
served chunks, cuts and the launches the rule gives, and last
``PREDICTED_CONTROL`` in the literal form this file holds, which the
card's runs are held to.

    python3 chip_smoke.py --predict-resume

needs no card either: it replays the ``[resume]`` phase's three kills and
resumes on the CPU the same way (``kill_and_resume``) and prints
``PREDICTED_RESUME``.

    python3 chip_smoke.py --predict-population

replays the ``[population]`` phase's runs on the CPU (``population_runs``
at width 64 under bert-base's full-width timing) and prints
``PREDICTED_POPULATION``.

Without either, exits non-zero without a result when no
CUDA device is available, or when run from a directory that does not hold
the repository's ``src/``.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import json
import math
import os
import pprint
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

# Where the interpreter is told to write no bytecode (PYTHONDONTWRITEBYTECODE)
# and site-packages holds none, every process compiles torch's Python source
# anew: 15-19 s of each launch process's set-up on a slow host.  This
# process keeps the bytecode it compiles under a pycache prefix in a
# temporary directory, removed at exit; the processes it starts inherit the
# prefix, read what is there and add what they compile.
PYCACHE = tempfile.mkdtemp(prefix="chip_smoke_pyc_")
atexit.register(shutil.rmtree, PYCACHE, ignore_errors=True)
sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
sys.dont_write_bytecode = False
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
# the checkout whose port this process runs: this one, or with --ab-one DIR
# (a process that --ab starts) the one at DIR
PORT_ROOT = (Path(sys.argv[sys.argv.index("--ab-one") + 1]).resolve()
             if "--ab-one" in sys.argv[:-1] else ROOT)
sys.path.insert(0, str(PORT_ROOT / "src"))

# --predict-control, --predict-resume and --predict-population run on the
# CPU; everything else needs the card
if not torch.cuda.is_available() and not {"--predict-control", "--predict-resume",
                                          "--predict-population"} & set(sys.argv[1:]):
    sys.exit("chip_smoke: no CUDA device is available")

from repro_torch.numerics import set_fp32_policy  # noqa: E402

set_fp32_policy()   # TF32 off for matmuls and cuDNN: fp32 as in the reference

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.checkpointing import load_snapshot, unpack_json  # noqa: E402
from repro_torch.data import make_emotion_dataset  # noqa: E402
from repro_torch.core.cost_model import lora_upload_bytes, makespan  # noqa: E402
from repro_torch.core import lora as lora_lib  # noqa: E402
from repro_torch.core.memory_model import client_memory  # noqa: E402
from repro_torch.fed import (PAPER_CLIENTS, PAPER_CUTS, AggConfig,  # noqa: E402
                             ControlConfig, EngineConfig, FedRunConfig, FleetConfig,
                             FleetSpec, NetConfig, ObsConfig, Simulator)
from repro_torch.fed.population_training import (PopulationTrainer,  # noqa: E402
                                                 train_population)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS,  # noqa: E402
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain)
from repro_torch.kernels import grouped_lora as grouped_module  # noqa: E402
from repro_torch.kernels.grouped_lora import (grouped_lora,  # noqa: E402
                                              grouped_lora_chunk,
                                              grouped_lora_direct)
from repro_torch.kernels import lora_matmul as lora_matmul_module  # noqa: E402
from repro_torch.kernels.lora_matmul import lora_matmul  # noqa: E402
from repro_torch.kernels.ops import fused_lora_matmul, grouped_lora_matmul  # noqa: E402
from repro_torch.kernels import quant as quant_module  # noqa: E402
from repro_torch.kernels.quant import quantize_rows  # noqa: E402
from repro_torch.kernels.ref import (grouped_lora_matmul_ref,  # noqa: E402
                                     lora_matmul_ref, quantize_rows_ref, wkv6_ref)
from repro_torch.kernels.wkv6 import wkv6  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.models import blocks as blocks_module  # noqa: E402
from repro_torch.models import layers as layers_module  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import softmax_xent, torch_dtype  # noqa: E402
from repro_torch.net import ConstantLink, TraceLink  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# the bf16 tiles' dispatch rule, the quantize kernel's body rule and direct
# mode's; a parent checkout under --ab (which runs only ab_measure, where
# they are not read) may predate them
tma_ok = getattr(lora_matmul_module, "tma_ok", None)
resident_loads = getattr(quant_module, "resident_loads", None)
direct_resident = getattr(grouped_module, "direct_resident", None)

# H100 SXM data-sheet peaks (dense): fp32 on the CUDA cores, bf16 on the
# tensor cores, HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12

# what each redesigned kernel is built from, for the summary line
DESIGNS = {
    "lora_matmul": "3xTF32 mma.sync.m16n8k8 (big/small TF32 splits: about 22-bit "
                   "operands; each k8 slice's 3 products summed from zero, then added "
                   "to the f32 accumulator round-to-nearest) on 128x96 tiles, 4-stage "
                   "cp.async ring of 32-deep K steps; W N- or K-contiguous, A and B by "
                   "strides",
    "flash_attention": "bf16: wgmma m64n64k16 (Q K^T) and m64nDk16 (P V, P from "
                       "registers), 2 consumer warpgroups x 64 query rows, TMA "
                       "2-stage K/V ring on mbarriers; D 112 as the 128-wide tile, "
                       "TMA zero-filling past D; fp32: SIMT FMAs",
    "grouped_lora_chunk": "lora_matmul's 3xTF32 mma.sync tile (shared header "
                          "tf32_lora_tile.cuh) per 128x96 tile of one group, from a "
                          "device tile table; 4-stage cp.async ring; W N- or "
                          "K-contiguous, A and B by group and element strides",
    "grouped_lora_direct": "K <= 128: the 3xTF32 mma.sync tile of chunk mode on 128x96 "
                           "tiles from the device tile table with the whole K slab copied "
                           "by cp.async in one step and waited for once (no stage "
                           "recycled); K > 128: chunk mode's K sweep; W, A and B by "
                           "strides",
    "lora_matmul_bf16": "wgmma m64nBNk16 (x @ W) and m64nRPk16 (x @ A^T, same x "
                        "descriptor) with f32 accumulators, 2 consumer warpgroups x 64 rows "
                        "of a 128 x BN tile (BN 256 where the grid fills the card, else 64), "
                        "1 producer warpgroup (setmaxnreg 40/232) keeping a 4-stage TMA ring "
                        "of 64-deep K steps on full/empty mbarriers; W N- or K-contiguous by "
                        "the B descriptor's transpose bit; A by TMA or the producer's 16-byte "
                        "loads; x @ A^T kept in f32 and the up-projection as three "
                        "register-A wgmma of its three-term bf16 split (about 2^-26); y "
                        "rounded to bf16 once (bf16_wgmma_tile.cuh)",
    "lora_matmul_bf16_mma_sync": "bf16 mma.sync.m16n8k16 with f32 accumulators, fed by "
                                 "ldmatrix (.trans for the N-contiguous W) on 128x128 tiles, "
                                 "two blocks an SM up to r 32; 4-stage ring of 32-deep K "
                                 "steps; for operands TMA cannot describe "
                                 "(bf16_lora_tile.cuh)",
    "grouped_lora_chunk_bf16": "lora_matmul's wgmma tile (shared header "
                               "bf16_wgmma_tile.cuh) per 128-row tile of one group, from the "
                               "device tile table; A_g by a 3-D tensor map or by pointer",
    "grouped_lora_chunk_bf16_mma_sync": "lora_matmul's mma.sync tile (bf16_lora_tile.cuh) per "
                                        "128x128 tile of one group, for operands TMA cannot "
                                        "describe",
    "grouped_lora_direct_bf16": "K <= 128 with operands TMA describes: a resident wgmma "
                                "tile, one block an SM walking a balanced share of the "
                                "(128-row tile, 128-column tile) pairs; a producer "
                                "warpgroup loads a row tile's x slab and A_g once by TMA "
                                "and streams W through a 2-stage TMA ring; 2 consumer "
                                "warpgroups form x @ A_g^T once a row tile (m64nRPk16) "
                                "and keep its three-term bf16 split in registers, issue "
                                "m64n128k16 over the slab and the register-A "
                                "up-projection per N tile, and store y by double-buffered "
                                "TMA stores in bulk groups; otherwise chunk mode's K "
                                "sweep (the wgmma tile, or mma.sync where TMA cannot "
                                "describe the operands)",
    "quantize_rows": "a warp per row, 8 rows a block (one resident wave at 2048 rows): "
                     "each lane issues all of its 16-byte loads (4 f32 or 8 bf16) "
                     "before the first use, keeps the row in registers, absmax by warp "
                     "shuffles, the scale formed by every lane, codes stored 4 or 8 to "
                     "a 32- or 64-bit store; rows that are not whole aligned 16-byte "
                     "chunks, or wider than 512 chunks, take a block-per-row body that "
                     "reads the row twice; x read in its stored type (f32 or bf16)",
    "wkv6": "state split over P lanes per group of JC columns and the columns over "
            "S blocks a head ((P, S, JC) = (8, 2, 2) at D 64), outputs reduced P steps "
            "at a time by one shuffle butterfly; r, k, w, v staged by cp.async into a "
            "two-buffer ring in their stored types, one barrier a chunk",
}

# kernel vs plain version: fp32 sums taken in another order differ by a few
# ulps of the largest partial sum; 1e-4 of the output's scale is far above
# that and far below any indexing or masking fault (which is O(1))
KERNEL_RTOL = 1e-4
# fused run vs einsum run, per-round mean loss: the two paths differ only in
# fp32 summation order, but AdamW's first step moves each adapter element by
# about lr whatever the gradient's size, so an element whose gradient is near
# zero can move the other way (ROADMAP Queue C.1); that shifts the round-2
# loss by far less than 1e-3 of its value
LOSS_RTOL = 1e-3

# flash and WKV6 kernels vs their plain versions (flash: each query row's
# error over that row's scale, ``row_err``; WKV6: ``norm_err``): in fp32
# both sum the same f32 products in another order (the flash kernel's
# online softmax against one softmax); in bf16 the output, and in flash
# the probabilities, round to bf16 at other points (an ulp of bf16 is
# 2**-8 of the value, relative, so the limit is relative to the row too)
LM_KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the flash backward's dq, dk and dv against its plain version over the
# whole tensor (``rel2``): both keep dS in f32 precision (the kernel as hi +
# lo bf16 terms) and round each gradient to bf16 once, so the two differ
# only where an f32 value straddles a bf16 rounding edge; a backward that
# rounded dS to bf16 alone parts from the plain one on most elements of dq
# and dk.  Set between the two (``check_flash_pair``, which requires the
# plain backward's bf16-dS control to read above it): on an H100, over
# both instances and seven shapes at two seeds, the kernel read 2.1e-8 to
# 1.7e-4 and the control 2.46e-3 to 2.74e-3
FLASH_GRAD_REL_TOL = 5e-4
# the LM paths in bf16, layer by layer from a shared input: kernel vs plain
# (each layer's output and cache, the last-token logits) and decode vs
# prefill.  The two sides differ by bf16 roundings of the attention or WKV
# output (~2**-8 of a value, the kernel checks' 1e-2) carried through one
# layer's projections; a wrong mask, position, cache slot or state changes
# a layer's output by O(1) of its scale.  Held per layer because a
# random-weight model run free through 18-32 layers in bf16 amplifies one
# rounding into O(1) differences (measured: the free-running numbers are
# printed beside the held ones)
LM_TOL = 5e-2
# the bf16 LoRA kernels vs their plain versions, each output row's relative
# error over its own scale (``row_err``): both sum bf16 products in f32 (in
# another order) and round y to bf16 once, so rows differ by single-ulp
# roundings (2**-8 of an element); a fault in indexing or masking is O(1)
BF16_KERNEL_TOL = 1e-2
# the LM backward in bf16 (4 layers, full width), fused against einsum: the
# loss (relative); and every adapter leaf's gradient layer by layer from
# shared inputs (the einsum run's input to the layer and the gradient at its
# output), each bf16 path against the fp32 gradient of the same layer on the
# same (bf16-valued) weights and inputs, as the relative 2-norm over the
# leaf.  A leaf is held when the einsum path is itself within LM_GRAD_TOL of
# fp32: the fused path must then be within LM_GRAD_TOL too.  The leaves where
# the einsum path is farther are ill-conditioned in bf16 (the einsum path's
# own roundings of r and k put some RWKV6 leaves 15-21 % from fp32 where the
# fused path is at 4.4 %, CPU, reduced width); they are listed with both
# readings and not held, and a layer with no held leaf fails.  A wrong dx,
# dA or dB is O(1) of a leaf.
LM_GRAD_LOSS_RTOL, LM_GRAD_TOL = 1e-2, 5e-2
# the end-to-end adapter gradients, fused against einsum (the relative 2-norm,
# worst leaf), held where the model is well-conditioned at random weights:
# 1e-3 relative noise in the fp32 weights moves gemma-2b's fp32 adapter
# gradients by 1.3 % and rwkv6-3b's by ~100 % (CPU, full width, 4 layers).
# gemma-2b's two bf16 paths read 6.1 % worst and 6.0 % median on the H100
# (PERF.md), and a wrong dx, dA or dB is O(1): the limit is 1e-1.  rwkv6-3b's
# read 78-90 %, so its end-to-end gradients are printed and not held.
LM_GRAD_E2E_TOL = {"gemma-2b": 1e-1}
# layer-0 projections whose input is a function of frozen tensors alone (the
# embedding, norms and, in RWKV6, the token-shift mix), so autograd asks no
# dx of them, by the side that runs them (the full step runs both): dense
# wq, wk, wv; ssm time-mix wr, wk, wv, wg; the hybrid's in_proj (the MoE
# block's are the dense block's: the router's input follows the attention,
# whose output adapter needs a dx); the encoder-decoder's layer-0 wq, wk, wv
# in the encoder (over the frames) and in the decoder (over the token
# embeddings, on the server); elsewhere the server's first layer takes the
# uploaded activations, which need a dx
FROZEN_INPUT = {"dense": {"client": 3, "server": 0}, "moe": {"client": 3, "server": 0},
                "ssm": {"client": 4, "server": 0}, "hybrid": {"client": 1, "server": 0},
                "encdec": {"client": 3, "server": 3}}
# the hybrid's cohort lanes in fp32 (``hybrid_fp32_lanes``): dv and the
# worst adapter leaf's gradient against each lane's sequential step, in the
# relative 2-norm
HYBRID_FP32_LANE_TOL = 1e-3
LM_GRAD_LAYERS, LM_GRAD_BATCH, LM_GRAD_SEQ = 4, 2, 512

ROUNDS, BATCH, SEQ, LR = 2, 16, 128, 1e-3
# the event phase: the event-driven sync run against the analytic one, per
# round (simulated seconds, relative; the clock and the closed form add the
# same floats) and per-round mean loss (relative: the same kernels on the
# same inputs per client; only the order the clients' losses are averaged
# in may differ)
EVENT_TIME_RTOL, EVENT_LOSS_RTOL = 1e-12, 1e-6
# the async runs share one cell per direction of twice the nominal 100 Mbps
# link (the reference's own shared-medium tests use 2-3x); clients fade by
# Gilbert-Elliott; the clock forms chunks of up to 3 clients
EVENT_CAPACITY_MBPS, EVENT_CHUNK = 200.0, 3
VMAP_CHUNK = 6          # the cohort paths' chunk: all six clients
# [lm-train]: 2 sequences of 512 tokens, gemma-2b at its full 18 layers,
# rwkv6-3b cut to 4 and qwen3-moe-30b-a3b to 8 (of 48, for time; all at
# full width), a mid cut, three lanes at three cuts for the cohort steps,
# three split steps, two full steps
# zamba2-7b at 12 layers (two segments of 6), its sliced and scan server
# steps at cut 6 (a segment boundary: the client runs the first shared
# block) and 3 (inside one); whisper-large-v3 at 4 encoder and 4 decoder
# layers, cut 2 (encoder layers held by the client)
LM_TRAIN_LAYERS = {"gemma-2b": 18, "rwkv6-3b": 4, "qwen3-moe-30b-a3b": 8,
                   "zamba2-7b": 12, "whisper-large-v3": 4}
LM_TRAIN_CUTS = {"zamba2-7b": (6, 3), "whisper-large-v3": (2,)}
LM_TRAIN_LANE_CUTS = {"gemma-2b": (3, 9, 15), "rwkv6-3b": (1, 2, 3),
                      "qwen3-moe-30b-a3b": (2, 4, 6), "zamba2-7b": (3, 6, 9)}
LM_TRAIN_ARCHS = tuple(LM_TRAIN_LAYERS)
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 2, 512, 3
LAUNCH_ARGS = ("--mode", "central", "--arch", "granite-3-2b", "--steps", "3", "--batch", "2",
               "--seq", "512", "--log-every", "1", "--schedule", "warmup-cosine",
               "--warmup", "1", "--weight-decay", "0.01", "--grad-clip", "1.0")
# the launch layer's other entry points, each in a process of its own:
# serve.py at the reference's defaults (reduced gemma-2b, batch 4, 16
# prompt tokens, 32 new ones); the dry-run's gemma-2b prefill_32k at full
# width and depth through the flash kernel, executed at batch 1; the
# server-resume step on granite-3-2b at full width, executed at two cuts
DRYRUN_PREFILL_ARGS = ("--arch", "gemma-2b", "--shape", "prefill_32k", "--attn-impl",
                       "chunked", "--execute", "--batch", "1", "--out", "")
DRYRUN_RESUME_ARGS = ("--server-resume", "--arch", "granite-3-2b", "--batch", "4", "--seq",
                      "1024", "--execute", "--cuts", "10", "30", "--out", "")
# the dry-run's ops.flops against the analytic count of the prefill
DRYRUN_FLOPS_TOL = 0.10
# flash at gemma-2b's prefill_32k attention (B, S, H on K, D), held on its
# last FLASH_HOLD_ROWS query rows against every key (the plain version's
# scores for them are 1 x 8 x 1024 x 32768 f32, 1.07 GB)
FLASH_LONG = (1, 32768, 8, 1, 256)
FLASH_HOLD_ROWS = 1024
N_TRAIN, N_TEST = 4000, 512
SOURCES = ("lora_matmul", "grouped_lora", "quant", "flash_attention", "wkv6")
WGMMA_SOURCES = ("lora_matmul", "grouped_lora", "flash_attention")
# rwkv6-3b's adapted projections (K, N): time-mix r, k, v, g, o and
# channel-mix r at 2560 x 2560, channel-mix k and v
RWKV6_PROJECTIONS = ((2560, 2560), (2560, 8960), (8960, 2560))

# the LM slice: 4 prompts of 2048 tokens for the prefill; for the engine,
# six requests of 16-64 prompt tokens and 16 new tokens in 4 slots
LM_ARCHS = ("gemma-2b", "rwkv6-3b")
# rwkv6-3b's [lm] phase at 8 of its 32 layers (cut for time: at 32 its
# plain WKV scan, one step a token, made it 215 s of a 754 s run on one
# H100 80GB HBM3 at 700 W)
LM_PHASE_LAYERS = {"rwkv6-3b": 8}
# the MoE, VLM and dense completions (the A10 slice), at full width:
# qwen3-moe-30b-a3b at full depth (60.4 GB of bf16 weights), also served
# with one tenant; qwen1.5-4b with random qkv biases, also served on an
# int8 KV cache; internvl2-26b with 1024 random vision embeddings before
# 1024 text tokens; grok-1-314b cut to 2 of its 64 layers (the whole model
# would not fit one card)
NEW_LM_PHASES = (("qwen3-moe-30b-a3b", {"one_tenant": True}),
                 ("qwen1.5-4b", {"int8_cache": True}),
                 ("internvl2-26b", {}),
                 ("grok-1-314b", {"layers": 2}))
# the hybrid and the encoder-decoder (the second part of the slice), at full
# width and depth: zamba2-7b (81 Mamba2 layers, a shared attention block
# after each of its 14 segments; plain setting attn_impl "naive" with the
# same plain chunked SSD, which has no kernel) and whisper-large-v3 (32
# encoder and 32 decoder layers, on 4 x 1500 random frames and prompts of
# ENCDEC_PROMPT tokens, its decoder's own context)
FAMILY_LM_PHASES = ("zamba2-7b", "whisper-large-v3")
ENCDEC_PROMPT = 448
# the [build] phase: every registered config through build_model on the
# card at full width and this many layers, one forward of a prompt of
# this many tokens
BUILD_LAYERS, BUILD_SEQ = 2, 128
# the int8 KV cache's decode logits against the model-type cache's: the
# reference's bound (max |diff| over max |logit|,
# tests/test_fused_lora_integration.py)
INT8_CACHE_TOL = 5e-2
PREFILL_BATCH, PREFILL_SEQ = 4, 2048
SERVE_SLOTS, SERVE_CACHE, SERVE_NEW, SERVE_REQUESTS = 4, 128, 16, 6

# every kernel's launch counter, by the name the summary gives it: the
# wrapper and its attribute (``launches`` counts either type,
# ``launches_bf16`` the bf16 launches alone, and ``launches_wgmma`` the bf16
# launches of the wgmma tile)
COUNTERS = {"lora_matmul": (lora_matmul, "launches"),
            "lora_matmul_bf16": (lora_matmul, "launches_bf16"),
            "lora_matmul_wgmma": (lora_matmul, "launches_wgmma"),
            "grouped_lora_chunk": (grouped_lora_chunk, "launches"),
            "grouped_lora_chunk_bf16": (grouped_lora_chunk, "launches_bf16"),
            "grouped_lora_chunk_wgmma": (grouped_lora_chunk, "launches_wgmma"),
            "grouped_lora_direct": (grouped_lora_direct, "launches"),
            "grouped_lora_direct_bf16": (grouped_lora_direct, "launches_bf16"),
            "grouped_lora_direct_swept": (grouped_lora_direct, "launches_swept"),
            "quantize_rows": (quantize_rows, "launches"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention_bwd": (flash_attention_bwd, "launches"),
            "wkv6": (wkv6, "launches")}


def reset_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    # a parent checkout under --ab may predate the bf16 and wgmma counters: 0 there
    return {name: getattr(fn, attr, 0) for name, (fn, attr) in COUNTERS.items()}


def no_launches(**counts) -> dict:
    """Every counter at 0 but the ones given."""
    return {**{name: 0 for name in COUNTERS}, **counts}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


def sass_mma_by_function(name: str) -> dict:
    """Tensor-core instructions in a built library's SASS, by function (its
    mangled name) and opcode (HMMA: mma.sync; HGMMA: wgmma), from cuobjdump
    beside nvcc; None where cuobjdump is missing."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(build.BUILD_DIR / f"lib{name}.so")],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            out[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn and "MMA" in line and line.strip().startswith("/*") and len(line.split()) > 1:
            op = line.split()[1].split(".")[0]
            if op in out[fn]:
                out[fn][op] += 1
    return out


def sass_mma_counts(name: str) -> dict:
    """The library's tensor-core instructions by opcode, over its functions."""
    funcs = sass_mma_by_function(name)
    if funcs is None:
        return {"cuobjdump": "not found"}
    return {op: n for op in ("HGMMA", "HMMA")
            if (n := sum(f[op] for f in funcs.values()))}


def check_direct_sass() -> dict:
    """Every instance of direct mode's resident tiles holds tensor-core
    instructions (HGMMA in bf16's wgmma tile, HMMA in fp32's 3xTF32 tile),
    and no function of the SIMT body the port had before remains."""
    funcs = sass_mma_by_function("grouped_lora")
    if funcs is None:
        return {"cuobjdump": "not found"}
    bf16 = {f: c for f, c in funcs.items() if "grouped_lora_direct_wgmma_kernel" in f}
    f32 = {f: c for f, c in funcs.items() if "grouped_lora_direct_kernel" in f}
    out = {"bf16_instances": len(bf16), "fp32_instances": len(f32),
           "bf16_min_hgmma": min((c["HGMMA"] for c in bf16.values()), default=0),
           "fp32_min_hmma": min((c["HMMA"] for c in f32.values()), default=0),
           "simt_functions": [f for f in funcs if "grouped_lora_kernel_direct" in f]}
    if (not bf16 or not f32 or out["bf16_min_hgmma"] == 0 or out["fp32_min_hmma"] == 0
            or out["simt_functions"]):
        raise AssertionError(f"direct mode's SASS: {out}")
    return out


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = 20, attempts: int = 3) -> float:
    """Device time of one launch of the kernel whose name contains
    ``kernel``: the device time the profiler recorded for it over the
    launches it recorded.  Where a call's host side (Python, ctypes,
    allocation) takes longer than its kernel, ``cuda_ms`` measures the host
    and this the kernel.  The profiler can drop kernel records (windows of
    10 launches have shown 9, 6 and 3), and the records it keeps are whole
    launches, so windows of ``iters`` calls are profiled until ``iters``
    launches are recorded in all, up to ``attempts`` windows; a shortfall
    is printed, and no record at all raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen, total_us = [], 0.0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
        seen.append(sum(e.count for e in hits))
        total_us += sum(e.self_device_time_total for e in hits)
        if sum(seen) >= iters:
            break
    if not sum(seen):
        raise AssertionError(f"the profiler recorded no launch of {kernel} in "
                             f"{attempts} windows of {iters} calls")
    if seen[0] != iters:
        print(f"[profile] {kernel}: the profiler recorded {seen} launches in windows "
              f"of {iters} calls", flush=True)
    return total_us / sum(seen) / 1e3


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(1, max |want|)."""
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) / scale


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest, over rows (every index but the last), of a row's
    relative error |got - want| / |want| in the 2-norm over the row.
    Attention needs it: under a causal mask row i averages i + 1 value
    rows, so late rows are about sqrt(1/i) of row 0's size, and one scale
    for the whole output would let a fault confined to late key tiles pass.
    The norm over the row, and not its largest element over the row's
    largest: bf16 outputs differ by an ulp or two at single elements (one
    ulp is up to 2**-7 of the row's largest element), which the row's norm
    averages and a fault does not.  bf16 inputs are compared in f32."""
    got, want = (t if t.dtype in (torch.float32, torch.float64) else t.float()
                 for t in (got, want))
    diff = torch.linalg.vector_norm(got - want, dim=-1)
    scale = torch.linalg.vector_norm(want, dim=-1).clamp_min(torch.finfo(torch.float32).tiny)
    return float((diff / scale).max())


def tf32_split(v: torch.Tensor):
    """lora_matmul.cu's operand split, in PyTorch: big = v rounded to TF32
    (10 mantissa bits, ties away from zero: add half an ulp to the bits and
    clear the low 13), small = v - big rounded the same way."""
    def rnd(u):
        return ((u.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    big = rnd(v)
    return big, rnd(v - big)


def lora_error_sources(x, w, a, b, scale: float, y: torch.Tensor) -> dict:
    """Where the 3xTF32 kernel's error comes from, at one shape: each
    output's normalized error against exact (fp64) products of the fp32
    inputs.  ``split`` multiplies the kernel's split operands exactly
    (small*big + big*small + big*big, B unsplit as in the epilogue): the
    error of ~22-bit operands alone.  ``split_fp32`` sums those same
    products in fp32 with round-to-nearest (PyTorch's fp32 products, TF32
    off).  ``kernel_vs_split`` is what the kernel's own sums add: the
    tensor core's inside each k8 slice's products, the f32 adds across
    slices, and the epilogue's FMAs."""
    f64 = torch.float64

    def parts(p, q):
        (pb, ps), (qb, qs) = tf32_split(p), tf32_split(q)
        return ((ps, qb), (pb, qs), (pb, qb))

    def split_mm(p, q, dtype):
        return sum(u.to(dtype) @ v.to(dtype) for u, v in parts(p, q))

    at = a.t().contiguous()
    exact = x.to(f64) @ w.to(f64) + scale * (x.to(f64) @ at.to(f64)) @ b.to(f64).t()
    split = split_mm(x, w, f64) + scale * split_mm(x, at, f64) @ b.to(f64).t()
    split32 = split_mm(x, w, torch.float32) + scale * split_mm(x, at, torch.float32) @ b.t()
    return {"kernel": norm_err(y.to(f64), exact),
            "plain_fp32": norm_err(lora_matmul_ref(x, w, a, b, scale).to(f64), exact),
            "split": norm_err(split, exact),
            "split_fp32": norm_err(split32.to(f64), exact),
            "kernel_vs_split": norm_err(y.to(f64), split)}


def grouped_error_sources(x, w, a, b, sizes, scales, y: torch.Tensor) -> dict:
    """``lora_error_sources`` over each group's rows of a grouped product
    (w, a and b as the kernel was given them, views included); the worst
    group of each."""
    out, off = {}, 0
    for i, m in enumerate(sizes):
        src = lora_error_sources(x[off:off + m], w, a[i], b[i], float(scales[i]),
                                 y[off:off + m])
        for key, v in src.items():
            out[key] = max(out.get(key, 0.0), v)
        off += m
    return out


def check_lora_matmul(m: int, k: int, n: int, r: int, seed: int,
                      timed: bool = False) -> dict:
    """Kernel vs plain version, forward (contiguous operands and the
    backward's transposed views) and backward, at one shape."""
    dev = torch.device("cuda")
    rs = np.random.default_rng(seed)

    def t(*shape, std=1.0):
        return torch.from_numpy((rs.standard_normal(shape) * std)
                                .astype(np.float32)).to(dev)

    x, w = t(m, k), t(k, n, std=1 / math.sqrt(k))
    a, b = t(r, k, std=1 / math.sqrt(r)), t(n, r, std=0.1)
    g = t(m, n)
    scale = 2.0
    y = lora_matmul(x, w, a, b, scale=scale)
    y_ref = lora_matmul_ref(x, w, a, b, scale)
    # the layouts the backward passes: W, A and B as .t() views of
    # contiguous tensors (W K-contiguous, A and B read by strides)
    wv, av, bv = (v.t().contiguous().t() for v in (w, a, b))
    y_views = lora_matmul(x, wv, av, bv, scale=scale)
    torch.cuda.synchronize()
    out = {"shape": [m, k, n, r], "fwd_err": norm_err(y, y_ref),
           "views_err": norm_err(y_views, y_ref)}

    grads = {}
    for name, fn in (("kernel", fused_lora_matmul), ("plain", None)):
        xs, as_, bs = (v.clone().requires_grad_(True) for v in (x, a, b))
        if fn is None:
            yy = lora_matmul_ref(xs, w, as_, bs, scale)
        else:
            yy = fn(xs, w, as_, bs, scale=scale)
        grads[name] = torch.autograd.grad(yy, (xs, as_, bs), g)
    torch.cuda.synchronize()
    for label, got, want in zip(("dx", "da", "db"), grads["kernel"], grads["plain"]):
        out[f"{label}_err"] = norm_err(got, want)
    out["max_abs_err"] = float((y - y_ref).abs().max())
    bad = {key: v for key, v in out.items() if key.endswith("_err")
           and key != "max_abs_err" and not v <= KERNEL_RTOL}
    if bad:
        raise AssertionError(f"lora_matmul disagrees with its plain version at "
                             f"{out['shape']}: {bad} (tolerance {KERNEL_RTOL})")

    if not timed:
        return out
    flops = 2 * m * k * n + 2 * m * k * r + 2 * m * n * r
    nbytes = 4 * (m * k + k * n + r * k + n * r + m * n)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    out.update(
        error_sources=lora_error_sources(x, w, a, b, scale, y),
        ms=cuda_ms(lambda: lora_matmul(x, w, a, b, scale=scale)),
        device_ms=device_ms(lambda: lora_matmul(x, w, a, b, scale=scale),
                            "lora_matmul_kernel"),
        # the backward's dx call, on the views it passes
        dx_call_device_ms=device_ms(lambda: lora_matmul(g, w.t(), b.t(), a.t(),
                                                        scale=scale),
                                    "lora_matmul_kernel"),
        plain_ms=cuda_ms(lambda: lora_matmul_ref(x, w, a, b, scale)),
        base_matmul_ms=cuda_ms(lambda: torch.matmul(x, w)),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        # beside the fp32 bound: the same products as 3 TF32 passes on the
        # tensor cores, and the bytes alone
        bound_tf32x3_ms=3 * flops / PEAK_TF32_FLOPS * 1e3, bound_bytes_ms=t_bytes,
        gflop=flops / 1e9, mbytes=nbytes / 1e6)
    return out


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: operations over the fp32 peak or
    bytes over the HBM rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


def check_grouped(sizes, k: int, n: int, r: int, scales, mode: str, seed: int,
                  timed: bool = False) -> dict:
    """Grouped kernel vs plain version, forward and backward (dx through the
    kernel; dA, dB plain per group), at one ragged cohort shape."""
    dev = torch.device("cuda")
    rs = np.random.default_rng(seed)

    def t(*shape, std=1.0):
        return torch.from_numpy((rs.standard_normal(shape) * std)
                                .astype(np.float32)).to(dev)

    g_n, m = len(sizes), sum(sizes)
    x, w = t(m, k), t(k, n, std=1 / math.sqrt(k))
    a, b = t(g_n, r, k, std=1 / math.sqrt(r)), t(g_n, n, r, std=0.1)
    gy = t(m, n)
    y = grouped_lora(x, w, a, b, group_sizes=sizes, scales=scales, mode=mode)
    y_ref = grouped_lora_matmul_ref(x, w, a, b, sizes, scales)
    # the dx call's own layout: (g, W^T, B^T, A^T) as views of W, B and A
    views = (w.t(), b.transpose(1, 2), a.transpose(1, 2))
    dx_call = grouped_lora(gy, *views, group_sizes=sizes, scales=scales, mode=mode)
    torch.cuda.synchronize()
    out = {"mode": mode, "sizes": list(sizes), "k": k, "n": n, "r": r,
           "scales": list(scales), "fwd_err": norm_err(y, y_ref),
           "views_err": norm_err(dx_call, grouped_lora_matmul_ref(gy, *views, sizes,
                                                                  scales))}
    grads = []
    for fn in (grouped_lora_matmul, None):
        xs, as_, bs = (v.clone().requires_grad_(True) for v in (x, a, b))
        if fn is None:
            yy = grouped_lora_matmul_ref(xs, w, as_, bs, sizes, scales)
        else:
            yy = fn(xs, w, as_, bs, group_sizes=sizes, scales=scales, mode=mode)
        grads.append(torch.autograd.grad(yy, (xs, as_, bs), gy))
    torch.cuda.synchronize()
    for label, got, want in zip(("dx", "da", "db"), *grads):
        out[f"{label}_err"] = norm_err(got, want)
    out["max_abs_err"] = float((y - y_ref).abs().max())
    bad = {key: v for key, v in out.items() if key.endswith("_err")
           and key != "max_abs_err" and not v <= KERNEL_RTOL}
    if bad:
        raise AssertionError(f"grouped_lora ({mode}) disagrees with its plain version "
                             f"at {sizes}, K {k}, N {n}, r {r}: {bad} "
                             f"(tolerance {KERNEL_RTOL})")
    out["body"] = grouped_body(x, w, a, b, mode)
    out["dx_call_body"] = grouped_body(gy, *views, mode)
    if timed:
        tiles = -(-np.asarray(sizes) // 128)
        flops = 2 * m * k * n + 2 * m * k * r + 2 * m * n * r
        if mode == "direct":
            # chunk mode on the same inputs, in the same run
            out["chunk_device_ms"] = device_ms(
                lambda: grouped_lora(x, w, a, b, group_sizes=sizes, scales=scales,
                                     mode="chunk"), grouped_kernel(x, w, a, b, "chunk"))
        out.update(
            ms=cuda_ms(lambda: grouped_lora(x, w, a, b, group_sizes=sizes,
                                            scales=scales, mode=mode)),
            device_ms=device_ms(lambda: grouped_lora(x, w, a, b, group_sizes=sizes,
                                                     scales=scales, mode=mode),
                                grouped_kernel(x, w, a, b, mode)),
            # the backward's dx call, on the views it passes
            dx_call_device_ms=device_ms(lambda: grouped_lora(gy, *views, group_sizes=sizes,
                                                             scales=scales, mode=mode),
                                        grouped_kernel(gy, *views, mode)),
            plain_ms=cuda_ms(lambda: grouped_lora_matmul_ref(x, w, a, b, sizes, scales)),
            base_matmul_ms=cuda_ms(lambda: torch.matmul(x, w)),
            # errors against exact (fp64) products, forward and the dx call
            error_sources=grouped_error_sources(x, w, a, b, sizes, scales, y),
            dx_error_sources=grouped_error_sources(gy, *views, sizes, scales, dx_call),
            # beside the fp32 bound: the products as 3 TF32 passes
            bound_tf32x3_ms=3 * flops / PEAK_TF32_FLOPS * 1e3,
            **bound(flops, 4 * (m * k + k * n + g_n * (r * k + n * r) + m * n + g_n)
                    + 12 * int(tiles.sum())))
    return out


def check_grouped_single_group(seed: int) -> dict:
    """G = 1: the grouped kernel equals lora_matmul on the same input."""
    dev = torch.device("cuda")
    rs = np.random.default_rng(seed)
    x, w = (torch.from_numpy(rs.standard_normal(s).astype(np.float32) * f).to(dev)
            for s, f in (((300, 200), 1.0), ((200, 130), 1 / math.sqrt(200))))
    a = torch.from_numpy(rs.standard_normal((1, 16, 200)).astype(np.float32) / 4).to(dev)
    b = torch.from_numpy(rs.standard_normal((1, 130, 16)).astype(np.float32) / 10).to(dev)
    y = grouped_lora(x, w, a, b, group_sizes=(300,), scales=(2.0,), mode="chunk")
    want = lora_matmul(x, w, a[0], b[0], scale=2.0)
    torch.cuda.synchronize()
    err = norm_err(y, want)
    if not err <= KERNEL_RTOL:
        raise AssertionError(f"grouped_lora with G = 1 differs from lora_matmul: {err}")
    return {"sizes": [300], "k": 200, "n": 130, "r": 16, "err_vs_lora_matmul": err}


def _quantize_once(n: int, d: int, dtype, seed: int):
    """Quantize kernel vs plain version, bit for bit, on seeded rows with a
    row of exact .5 ties (x / scale = [127, 0.5, 1.5, 2.5, -0.5, ...]) and
    a zero row (scale floors at 1e-12), in ``dtype`` (both values exact in
    bf16 too)."""
    rs = np.random.default_rng(seed)
    x = (rs.standard_normal((n, d)) * 2.0).astype(np.float32)
    tie = np.array([254, 1, 3, 5, -1, -3, -5, 7], np.float32)
    x[1, :] = 0.0
    x[1, :tie.size] = tie[:d]
    x[2, :] = 0.0
    x = torch.from_numpy(x).cuda().to(dtype)
    q, s = quantize_rows(x)
    q_ref, s_ref = quantize_rows_ref(x)
    torch.cuda.synchronize()
    tie_q = q[1, :tie.size].tolist()
    out = {"shape": [n, d], "dtype": str(dtype).split(".")[-1],
           "body": "resident" if resident_loads(x) else "strided",
           "resident_loads": resident_loads(x),
           "q_mismatches": int((q != q_ref).sum()),
           "scale_mismatches": int((s != s_ref).sum()), "tie_row_q": tie_q,
           "zero_row_scale": float(s[2]),
           "max_abs_err": float((q.float() - q_ref.float()).abs().max())}
    if (out["q_mismatches"] or out["scale_mismatches"]
            or tie_q != [127, 0, 2, 2, 0, -2, -2, 4][:d]
            or s[2] != torch.tensor(1e-12, dtype=torch.float32, device=s.device)):
        raise AssertionError(f"quantize_rows is not bit-equal to its plain version: {out}")
    return x, out


def check_quantize(n: int, d: int, seed: int) -> dict:
    """The quantize kernel at the cohort path's shape in float32 and in
    bfloat16 (timed against its bytes bound, beside the plain version),
    and both bodies at a wide, unaligned d (12289) and a wide aligned one
    (4096: bf16 resident, f32 strided), each bit-equal to the plain
    version."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, c = _quantize_once(n, d, dtype, seed)
        if c["body"] != "resident":
            raise AssertionError(f"quantize_rows at the path's shape took {c['body']}")
        size = x.element_size()
        c.update(ms=cuda_ms(lambda: quantize_rows(x)),
                 device_ms=device_ms(lambda: quantize_rows(x), "quantize_rows_"),
                 plain_ms=cuda_ms(lambda: quantize_rows_ref(x)),
                 **bound(5 * n * d, size * n * d + n * d + 4 * n))
        out[c["dtype"]] = c
    out["bodies"] = [_quantize_once(nn, dd, dtype, seed + 1)[1]
                     for nn, dd in ((6, 12289), (6, 4096), (300, 7))
                     for dtype in (torch.float32, torch.bfloat16)]
    if {c["body"] for c in out["bodies"]} != {"resident", "strided"}:
        raise AssertionError(f"quantize_rows did not run both bodies: {out['bodies']}")
    # the summary's numbers are the f32 call's, as the cohort path runs it
    return {**out["float32"], "bfloat16": out["bfloat16"], "bodies": out["bodies"]}


def bf16_bound(flops: float, nbytes: float) -> dict:
    """The least time at the bf16 tensor-core peak or the HBM rate,
    whichever is larger."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_bytes_ms": t_bytes, "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


def _bf16_inputs(seed, *shapes_stds):
    dev = torch.device("cuda")
    rs = np.random.default_rng(seed)
    return [torch.from_numpy((rs.standard_normal(shape) * std).astype(np.float32))
            .to(dev).to(torch.bfloat16) for shape, std in shapes_stds]


def _grad_errs(fn, ref, x, a, b, g) -> dict:
    """dx, dA and dB of the autograd op against autograd through the plain
    version, each row over its own scale."""
    grads = []
    for f in (fn, ref):
        xs, as_, bs = (v.clone().requires_grad_(True) for v in (x, a, b))
        grads.append(torch.autograd.grad(f(xs, as_, bs), (xs, as_, bs), g))
    torch.cuda.synchronize()
    return {f"{name}_err": row_err(got.float(), want.float())
            for name, got, want in zip(("dx", "da", "db"), *grads)}


def _kernel_name(op: str, wgmma: bool) -> str:
    """The device kernel a bf16 call launches, by its tile."""
    return f"{op}_wgmma_kernel" if wgmma else f"{op}_bf16_kernel"


def grouped_kernel(x, w, a, b, mode: str) -> str:
    """The device kernel a grouped call launches, by mode, type and body:
    direct mode's resident tiles where ``direct_resident`` holds, else the
    chunk tiles (fp32 3xTF32; bf16 wgmma where ``tma_ok`` holds, else
    mma.sync)."""
    if mode == "direct" and direct_resident(x, w, a, b):
        return ("grouped_lora_direct_kernel" if x.dtype == torch.float32
                else "grouped_lora_direct_wgmma_kernel")
    if x.dtype == torch.float32:
        return "grouped_lora_kernel"
    return _kernel_name("grouped_lora", tma_ok(x, w, a, b))


def grouped_body(x, w, a, b, mode: str) -> str:
    """What a grouped call runs, by name: ``resident`` (direct mode's
    resident tile) or the chunk tiles' K sweep (``sweep``, and in bf16 the
    tile: ``sweep wgmma`` or ``sweep mma.sync``)."""
    if mode == "direct" and direct_resident(x, w, a, b):
        return "resident"
    if x.dtype == torch.float32:
        return "sweep"
    return "sweep wgmma" if tma_ok(x, w, a, b) else "sweep mma.sync"


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` whose storage starts one element past a 16-byte
    boundary: TMA cannot describe it, so an A given so sends the call to
    the mma.sync tile, which loads A by element either way."""
    out = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)[1:1 + t.numel()]
    return out.view(t.shape).copy_(t)


def check_lora_matmul_bf16(m: int, k: int, n: int, r: int, seed: int,
                           timed: bool = False) -> dict:
    """The bf16 kernel vs its plain version, forward (contiguous operands,
    the backward's transposed views, the dx call's layout) and backward, at
    one shape; with ``timed`` its time beside the plain version's and the
    bf16 base product ``x @ W``'s, the mma.sync tile's time at the same
    shape (A misaligned by one element), and its error against exact
    products, which must be within 5 % of the plain version's."""
    x, w, a, b, g = _bf16_inputs(seed, ((m, k), 1.0), ((k, n), k ** -0.5),
                                 ((r, k), r ** -0.5), ((n, r), 0.1), ((m, n), 1.0))
    scale = 2.0
    y = lora_matmul(x, w, a, b, scale=scale)
    y_ref = lora_matmul_ref(x, w, a, b, scale)
    wv, av, bv = (v.t().contiguous().t() for v in (w, a, b))
    y_views = lora_matmul(x, wv, av, bv, scale=scale)
    dx_call = lora_matmul(g, w.t(), b.t(), a.t(), scale=scale)
    torch.cuda.synchronize()
    wgmma = tma_ok(x, w, a, b)
    out = {"shape": [m, k, n, r], "dtype": "bfloat16",
           "tile": "wgmma" if wgmma else "mma.sync",
           "views_tile": "wgmma" if tma_ok(x, wv, av, bv) else "mma.sync",
           "dx_call_tile": "wgmma" if tma_ok(g, w.t(), b.t(), a.t()) else "mma.sync",
           "fwd_err": row_err(y, y_ref),
           "views_err": row_err(y_views, y_ref),
           "dx_call_err": row_err(dx_call, lora_matmul_ref(g, w.t(), b.t(), a.t(), scale)),
           **_grad_errs(lambda x_, a_, b_: fused_lora_matmul(x_, w, a_, b_, scale=scale),
                        lambda x_, a_, b_: lora_matmul_ref(x_, w, a_, b_, scale),
                        x, a, b, g),
           "max_abs_err": float((y.float() - y_ref.float()).abs().max())}
    bad = {key: v for key, v in out.items() if key.endswith("_err")
           and key != "max_abs_err" and not v <= BF16_KERNEL_TOL}
    if y.dtype != torch.bfloat16 or bad:
        raise AssertionError(f"bf16 lora_matmul disagrees with its plain version at "
                             f"{out['shape']}: {bad} (tolerance {BF16_KERNEL_TOL} per row)")
    if not timed:
        return out
    # the adapter term's intermediate x @ A^T kept in f32 (as the kernel
    # does) against rounded to bf16 before the up-projection, each against
    # exact (fp64) products of the bf16 inputs
    f64 = torch.float64
    xa = x.to(f64) @ a.to(f64).t()
    exact = x.to(f64) @ w.to(f64) + scale * xa @ b.to(f64).t()
    xa16 = (x.float() @ a.float().t()).bfloat16().to(f64)
    rounded_xa = (x.float() @ w.float()).to(f64) + scale * xa16 @ b.to(f64).t()
    out["error_vs_exact"] = {"kernel": row_err(y.to(f64), exact),
                             "plain": row_err(y_ref.to(f64), exact),
                             "xa_rounded_to_bf16": row_err(rounded_xa.bfloat16().to(f64),
                                                           exact)}
    del xa, exact, xa16, rounded_xa
    if not out["error_vs_exact"]["kernel"] <= 1.05 * out["error_vs_exact"]["plain"]:
        raise AssertionError(f"bf16 lora_matmul at {out['shape']}: error against exact "
                             f"products {out['error_vs_exact']} beyond 1.05 x the plain "
                             f"version's")
    flops = 2 * m * k * n + 2 * m * k * r + 2 * m * n * r
    a_mis = _misaligned(a)
    y_mis = lora_matmul(x, w, a_mis, b, scale=scale)
    out.update(mma_sync_err=row_err(y_mis, y_ref),
               mma_sync_max_abs_err=float((y_mis.float() - y_ref.float()).abs().max()))
    if not out["mma_sync_err"] <= BF16_KERNEL_TOL:
        raise AssertionError(f"bf16 lora_matmul's mma.sync tile at {out['shape']}: "
                             f"{out['mma_sync_err']}")
    out.update(
        ms=cuda_ms(lambda: lora_matmul(x, w, a, b, scale=scale)),
        device_ms=device_ms(lambda: lora_matmul(x, w, a, b, scale=scale),
                            _kernel_name("lora_matmul", wgmma)),
        dx_call_device_ms=device_ms(lambda: lora_matmul(g, w.t(), b.t(), a.t(), scale=scale),
                                    _kernel_name("lora_matmul", out["dx_call_tile"] == "wgmma")),
        mma_sync_ms=cuda_ms(lambda: lora_matmul(x, w, a_mis, b, scale=scale)),
        mma_sync_device_ms=device_ms(lambda: lora_matmul(x, w, a_mis, b, scale=scale),
                                     _kernel_name("lora_matmul", False)),
        plain_ms=cuda_ms(lambda: lora_matmul_ref(x, w, a, b, scale), iters=20),
        base_matmul_ms=cuda_ms(lambda: torch.matmul(x, w)),
        **bf16_bound(flops, 2 * (m * k + k * n + r * k + n * r + m * n)))
    return out


def check_grouped_bf16(sizes, k: int, n: int, r: int, scales, mode: str, seed: int,
                       timed: bool = False) -> dict:
    """The bf16 grouped kernel vs its plain version, forward, the dx call's
    views and backward, at one ragged cohort shape."""
    g_n, m = len(sizes), sum(sizes)
    x, w, a, b, gy = _bf16_inputs(seed, ((m, k), 1.0), ((k, n), k ** -0.5),
                                  ((g_n, r, k), r ** -0.5), ((g_n, n, r), 0.1),
                                  ((m, n), 1.0))
    y = grouped_lora(x, w, a, b, group_sizes=sizes, scales=scales, mode=mode)
    y_ref = grouped_lora_matmul_ref(x, w, a, b, sizes, scales)
    views = (w.t(), b.transpose(1, 2), a.transpose(1, 2))
    dx_call = grouped_lora(gy, *views, group_sizes=sizes, scales=scales, mode=mode)
    torch.cuda.synchronize()
    out = {"mode": mode, "dtype": "bfloat16", "sizes": list(sizes), "k": k, "n": n, "r": r,
           "fwd_err": row_err(y, y_ref),
           "views_err": row_err(dx_call, grouped_lora_matmul_ref(gy, *views, sizes, scales)),
           **_grad_errs(lambda x_, a_, b_: grouped_lora_matmul(
               x_, w, a_, b_, group_sizes=sizes, scales=scales, mode=mode),
               lambda x_, a_, b_: grouped_lora_matmul_ref(x_, w, a_, b_, sizes, scales),
               x, a, b, gy),
           "max_abs_err": float((y.float() - y_ref.float()).abs().max())}
    bad = {key: v for key, v in out.items() if key.endswith("_err")
           and key != "max_abs_err" and not v <= BF16_KERNEL_TOL}
    if y.dtype != torch.bfloat16 or bad:
        raise AssertionError(f"bf16 grouped_lora ({mode}) disagrees with its plain version "
                             f"at {sizes}, K {k}, N {n}, r {r}: {bad}")
    wgmma = tma_ok(x, w, a, b)
    out["tile"] = "wgmma" if wgmma else "mma.sync"
    out["body"] = grouped_body(x, w, a, b, mode)
    out["dx_call_body"] = grouped_body(gy, *views, mode)
    if timed:
        kernel = grouped_kernel(x, w, a, b, mode)
        tiles = -(-np.asarray(sizes) // 128)
        flops = 2 * m * k * n + 2 * m * k * r + 2 * m * n * r
        call = (lambda: grouped_lora(x, w, a, b, group_sizes=sizes, scales=scales,
                                     mode=mode))
        a_mis = _misaligned(a)
        call_mis = (lambda: grouped_lora(x, w, a_mis, b, group_sizes=sizes, scales=scales,
                                         mode=mode))
        if mode == "direct":
            # chunk mode on the same inputs, in the same run; the error
            # against exact (fp64) products of the bf16 inputs, held within
            # 5 % of the plain version's as chunk mode's is
            out["chunk_device_ms"] = device_ms(
                lambda: grouped_lora(x, w, a, b, group_sizes=sizes, scales=scales,
                                     mode="chunk"), grouped_kernel(x, w, a, b, "chunk"))
            f64, offs = torch.float64, np.cumsum([0, *sizes])
            exact = torch.cat([
                x[lo:hi].to(f64) @ w.to(f64) + float(scales[i])
                * (x[lo:hi].to(f64) @ a[i].to(f64).t()) @ b[i].to(f64).t()
                for i, (lo, hi) in enumerate(zip(offs[:-1], offs[1:]))])
            out["error_vs_exact"] = {"kernel": row_err(y.to(f64), exact),
                                     "plain": row_err(y_ref.to(f64), exact)}
            del exact
            if not out["error_vs_exact"]["kernel"] <= 1.05 * out["error_vs_exact"]["plain"]:
                raise AssertionError(f"bf16 grouped_lora direct: error against exact "
                                     f"products {out['error_vs_exact']} beyond 1.05 x the "
                                     f"plain version's")
        if mode == "chunk":
            y_mis = call_mis()
            out.update(mma_sync_err=row_err(y_mis, y_ref),
                       mma_sync_max_abs_err=float((y_mis.float() - y_ref.float()).abs().max()))
            if not out["mma_sync_err"] <= BF16_KERNEL_TOL:
                raise AssertionError(f"bf16 grouped_lora's mma.sync tile: {out['mma_sync_err']}")
        out.update(
            ms=cuda_ms(call), device_ms=device_ms(call, kernel),
            dx_call_device_ms=device_ms(lambda: grouped_lora(
                gy, *views, group_sizes=sizes, scales=scales, mode=mode),
                grouped_kernel(gy, *views, mode)),
            **({"mma_sync_ms": cuda_ms(call_mis),
                "mma_sync_device_ms": device_ms(call_mis, _kernel_name("grouped_lora", False))}
               if mode == "chunk" else {}),
            plain_ms=cuda_ms(lambda: grouped_lora_matmul_ref(x, w, a, b, sizes, scales),
                             iters=20),
            base_matmul_ms=cuda_ms(lambda: torch.matmul(x, w)),
            **bf16_bound(flops, 2 * (m * k + k * n + g_n * (r * k + n * r) + m * n)
                         + 4 * g_n + 12 * int(tiles.sum())))
    return out


def expected_launches(cfg, cuts, n_eval_batches: int, rounds: int) -> list:
    """Kernel launches per round on the main path (derivation in PERF.md).

    Per client and round, with T adapted projections per layer and L layers:
    client forward T*cut, client backward T*cut - 3 (dx for every adapted
    projection except wq/wk/wv of layer 0, whose input is the frozen
    embedding), server forward T*(L - cut), server backward T*(L - cut) (dx
    everywhere, down to dv) — 2*T*L - 3 whatever the cut.  The evaluation
    after the last round runs T*L forward launches per test batch.
    """
    t, nl = len(cfg.lora.targets), cfg.n_layers
    per_round = sum(2 * t * nl - 3 for _ in cuts)
    counts = [per_round] * rounds
    counts[-1] += n_eval_batches * t * nl
    return counts


def expected_cohort_launches(cfg, cuts, n_eval_batches: int, rounds: int,
                             fused: bool, impl: str = "ragged") -> list:
    """Launches per round and kernel on the cohort path (derivation in
    PERF.md).  With T adapted projections per layer and L layers:
    lora_matmul runs only on the client side, 2*T*cut - 3 per client, plus
    T*L per evaluation batch after the last round; the grouped kernel
    (chunk mode, K = 768) runs forward and dx once per projection of each
    cut group's server layers under ragged, 2*T*(L - cut) per distinct cut,
    and under vmap once per projection of EVERY layer a chunk, 2*T*L a
    chunk whatever the cuts (the masked layers run too, and dv needs dx
    through each); the quantize kernel runs twice per client (uplink
    activations, downlink gradient), fused or not."""
    t, nl = len(cfg.lora.targets), cfg.n_layers
    lm = sum(2 * t * cut - 3 for cut in cuts)
    if impl == "vmap":
        gl = 2 * t * nl * math.ceil(len(cuts) / VMAP_CHUNK)
    else:
        gl = sum(2 * t * (nl - cut) for cut in sorted(set(cuts)))
    rows = [no_launches(lora_matmul=lm if fused else 0,
                        grouped_lora_chunk=gl if fused else 0,
                        quantize_rows=2 * len(cuts))
            for _ in range(rounds)]
    if fused:
        rows[-1]["lora_matmul"] += n_eval_batches * t * nl
    return rows


def path_run(cohort: bool, fused: bool, scheme: str = "ours",
             quantize=None, impl: str = "ragged") -> FedRunConfig:
    """The main path, or with ``cohort`` the cohort path: the six clients in
    one dispatch chunk of the ``impl`` cohort step (ragged: cut-grouped;
    vmap: the masked step over every layer) and int8+EF links
    (``quantize`` overrides the links' int8); ``scheme="sl"`` the
    split-learning baseline's path."""
    engine = EngineConfig(mode="analytic", fused_lora=fused)
    if cohort:
        engine = EngineConfig(mode="analytic", fused_lora=fused, cohort_chunk=VMAP_CHUNK,
                              cohort_impl=impl)
    return FedRunConfig(scheme=scheme, rounds=ROUNDS, batch_size=BATCH,
                        seq_len=SEQ, lr=LR, seed=0, engine=engine,
                        agg=AggConfig(policy="sync", interval=2),
                        net=NetConfig(quantize=cohort if quantize is None else quantize))


def run_path(fused: bool, train, test, cohort: bool = False, scheme: str = "ours",
             tag: str = "", impl: str = "ragged") -> dict:
    cfg = REGISTRY["bert-base"]
    t0 = time.perf_counter()
    sim = Simulator(cfg, PAPER_CLIENTS, PAPER_CUTS, train, test,
                    path_run(cohort, fused, scheme, impl=impl), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rows = []
    mark = {"t": 0.0, "counts": {}}

    def on_round(rec):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = read_counts()
        rows.append({"round": rec.round, "loss": rec.mean_loss,
                     "sim_time_s": rec.sim_time_s, "accuracy": rec.accuracy,
                     "f1": rec.f1, "wall_s": now - mark["t"],
                     "launches": {k: v - mark["counts"][k] for k, v in counts.items()},
                     "max_mem_bytes": torch.cuda.max_memory_allocated()})
        mark["counts"] = counts
        torch.cuda.reset_peak_memory_stats()
        mark["t"] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()                      # just before the path runs
    mark["counts"] = read_counts()
    mark["t"] = time.perf_counter()
    sim.run_training(on_round=on_round)
    total = read_counts()               # just after
    label = (("vmap:" if impl == "vmap" else "cohort:") if cohort
             else "sl:" if scheme == "sl" else "main:") + (
        "fused" if fused else "einsum") + tag
    for row in rows:
        print(f"[{label}] round {row['round']} loss={row['loss']:.7f} "
              f"sim_time_s={row['sim_time_s']:.6f} accuracy={row['accuracy']} "
              f"wall_s={row['wall_s']:.3f} launches={json.dumps(row['launches'])} "
              f"max_mem_bytes={row['max_mem_bytes']}", flush=True)
    for row in rows:
        if not math.isfinite(row["loss"]):
            raise AssertionError(f"non-finite loss in round {row['round']}")
    acc = rows[-1]["accuracy"]
    if acc is None or not 0.0 <= acc <= 1.0:
        raise AssertionError(f"evaluation gave accuracy {acc}")
    n_eval = min(32, len(test) // BATCH)
    if cohort:
        expected = expected_cohort_launches(sim.cfg, sim.cuts, n_eval, ROUNDS, fused,
                                            impl=impl)
    else:
        # an sl round (Simulator._round_sl) runs each client's forward, its
        # server step and its backward one client after the other: the same
        # launches per client as the main path's round
        lm = expected_launches(sim.cfg, sim.cuts, n_eval, ROUNDS)
        expected = [no_launches(lora_matmul=c if fused else 0) for c in lm]
    got = [row["launches"] for row in rows]
    print(f"[{label}] setup_s={setup_s:.3f} data_sizes={sim.data_sizes} "
          f"launches={json.dumps(total)} expected={json.dumps(expected)}", flush=True)
    if got != expected:
        raise AssertionError(f"{label}: launches per round {got}, expected {expected}")
    return {"rows": rows, "launches": total, "setup_s": setup_s,
            "wall_s": sum(row["wall_s"] for row in rows),
            "memory_report": dataclasses.asdict(sim.server_memory_report())}


def compare_paths(fused: dict, plain: dict, label: str) -> None:
    """Fused and einsum runs of one path: losses within LOSS_RTOL, equal
    simulated times."""
    for rf, rp in zip(fused["rows"], plain["rows"]):
        diff = abs(rf["loss"] - rp["loss"])
        print(f"[compare:{label}] round {rf['round']} fused={rf['loss']:.7f} "
              f"einsum={rp['loss']:.7f} |diff|={diff:.3e} "
              f"sim_time_equal={rf['sim_time_s'] == rp['sim_time_s']}", flush=True)
        if not diff <= LOSS_RTOL * abs(rp["loss"]):
            raise AssertionError(f"{label}: fused and einsum losses disagree in round "
                                 f"{rf['round']}: {diff} (rtol {LOSS_RTOL})")
        if rf["sim_time_s"] != rp["sim_time_s"]:
            raise AssertionError(f"{label}: simulated times differ between the paths")


def pick(events, name: str) -> dict:
    """Launches and device ms of the profiled kernels whose name holds
    ``name``."""
    hits = [e for e in events if name in e.key]
    return {"launches": sum(e.count for e in hits),
            "device_ms": sum(e.self_device_time_total for e in hits) / 1e3}


def profile_report(prof, wall: float, label: str) -> dict:
    """Device time by kernel, host time by operator, and the device's busy
    share of ``wall``, from a finished profiler window."""
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    events.sort(key=lambda e: -e.self_device_time_total)
    top = [{"kernel": e.key[:90], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3,
            "share": e.self_device_time_total / device_us} for e in events[:12]]
    host = sorted((e for e in averages
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    host_top = [{"op": e.key[:60], "calls": e.count,
                 "host_ms": e.self_cpu_time_total / 1e3} for e in host]
    out = {"path": label, "wall_s": wall, "device_s": device_us / 1e6,
           "busy_share": device_us / 1e6 / wall, "top": top, "host_top": host_top,
           # the backward's copies (.contiguous() runs direct_copy) and the
           # adapted projections' kernels
           **{name: pick(events, name) for name in ("direct_copy", "lora_matmul_kernel",
                                                    "grouped_lora")}}
    print(f"[profile:{label}] wall_s={wall:.4f} device_s={device_us / 1e6:.4f} "
          f"busy_share={out['busy_share']:.3f} direct_copy={out['direct_copy']} "
          f"lora_matmul={out['lora_matmul_kernel']} grouped_lora={out['grouped_lora']}",
          flush=True)
    for row in top:
        print(f"[profile:{label}] device {row['share']:6.3f} {row['device_ms']:9.3f} ms "
              f"{row['calls']:6d} x {row['kernel']}", flush=True)
    for row in host_top:
        print(f"[profile:{label}] host {row['host_ms']:9.3f} ms {row['calls']:6d} x "
              f"{row['op']}", flush=True)
    return out


def profile_round(fused: bool, train, test, cohort: bool = False) -> dict:
    """One warm round (the second, with its aggregation) under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    sim = Simulator(REGISTRY["bert-base"], PAPER_CLIENTS, PAPER_CUTS, train, test,
                    path_run(cohort, fused), device="cuda")
    sim.run_round(0)                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    label = ("cohort:" if cohort else "") + ("fused" if fused else "einsum")
    return profile_report(prof, wall, label)


def profile_event(policy: str, train, test) -> dict:
    """A whole fused event-engine run (the clock has no separable warm
    round) under the profiler, after the other phases warmed the card."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        sim = Simulator(REGISTRY["bert-base"], PAPER_CLIENTS, PAPER_CUTS, train, test,
                        event_run(policy, True, None if policy == "sync" else tmp),
                        device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim.run_training()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    out = profile_report(prof, wall, f"event:{policy}")
    out["serves"] = len(sim.clock_result.serves)
    return out


def attention_pairs(s: int, t: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps, queries at 0..s-1, keys at 0..t-1."""
    q = np.arange(s)[:, None]
    rel = q - np.arange(t)[None, :]
    keep = np.ones((s, t), bool)
    if causal:
        keep &= rel >= 0
    if window is not None:
        keep &= rel < window
    return int(keep.sum())


def check_flash(b, s, t, h, kh, d, causal, window, dtype, seed, timed=False) -> dict:
    """Flash kernel vs its plain version (model layout, kv heads repeated
    for the plain one) at one shape, in bf16 both instances (the online
    one, ``err``, and the normalise-first one, ``nf_err``, whose rounding
    of p the plain version shares); with ``timed`` the kernel (and in bf16
    its normalise-first instance, ``nf_device_ms``), the plain version and
    PyTorch's scaled_dot_product_attention (the yardstick, which the port
    never calls) are timed."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, t, kh, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, t, kh, d, generator=gen, device=dev).to(dtype)
    out = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    err = row_err(out.float(), want.float())
    # err_global: one scale for the whole output, the reading before row_err
    res = {"shape": [b, s, t, h, kh, d], "causal": causal, "window": window,
           "dtype": str(dtype).replace("torch.", ""), "err": err,
           "err_global": norm_err(out.float(), want.float()),
           "max_abs_err": float((out.float() - want.float()).abs().max())}
    tol = LM_KERNEL_TOL[dtype]
    bf16 = dtype == torch.bfloat16
    if bf16:
        nf = flash_attention(q, k, v, causal=causal, window=window, normalize_first=True)
        res["nf_err"] = row_err(nf.float(), want.float())
    if not (err <= tol and res.get("nf_err", 0.0) <= tol):
        raise AssertionError(f"flash_attention disagrees with its plain version: {res} "
                             f"(tolerance {tol})")
    if timed:
        pairs = attention_pairs(s, t, causal, window)
        flops = 4 * b * h * d * pairs
        nbytes = q.element_size() * (2 * b * s * h * d + 2 * b * t * kh * d)
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        lib = sdpa()
        res.update(
            ms=cuda_ms(lambda: flash_attention(q, k, v, causal=causal, window=window),
                       iters=20),
            device_ms=device_ms(lambda: flash_attention(q, k, v, causal=causal,
                                                        window=window),
                                "flash_bf16_kernel" if dtype == torch.bfloat16
                                else "flash_f32_kernel", iters=10),
            plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v, causal, window),
                             iters=5, warmup=1),
            library_ms=cuda_ms(sdpa, iters=20),
            library_err=row_err(lib.transpose(1, 2).float(), want.float()),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            gflop=flops / 1e9, mbytes=nbytes / 1e6)
        if bf16:
            res["nf_device_ms"] = device_ms(
                lambda: flash_attention(q, k, v, causal=causal, window=window,
                                        normalize_first=True), "flash_bf16_kernel", iters=10)
    return res


def grad_row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``row_err`` of a gradient, but for the rows whose exact gradient
    vanishes: the first query under a causal mask (P is one at its one
    key, so dS = 0) and a key no query sees hold round-off alone, under a
    thousandth of the median row's norm, and have no scale of their own;
    their norm is taken as the median row's.  Every other row is held over
    its own norm."""
    diff = torch.linalg.vector_norm((got - want).float(), dim=-1)
    norm = torch.linalg.vector_norm(want.float(), dim=-1)
    med = norm.median()
    norm = torch.where(norm < 1e-3 * med, med, norm)
    return float((diff / norm.clamp_min(1e-30)).max())


def check_flash_pair(b, s, t, h, kh, d, causal, window, seed, timed=False) -> dict:
    """The flash kernel pair in bf16 against its plain versions at one
    shape: the forward's lse (f32, within 1e-5) and output of both
    instances (online, normalise-first; per row within LM_KERNEL_TOL),
    then dq, dk and dv from each instance's lse against the plain backward
    (``grad_row_err`` within LM_KERNEL_TOL, and ``rel2`` over the tensor
    within FLASH_GRAD_REL_TOL, which the plain backward with dS rounded to
    bf16 alone, the control, must exceed on dq and on dk); two backward
    calls bit-equal;
    the forward's counter one a call, the backward's two (its two
    kernels).  With ``timed``, at the normalise-first instance: the
    forward with its lse and the backward, each kernel's device ms
    (``flash_bf16_kernel``; ``flash_bwd_dq_kernel`` + ``flash_bwd_dkdv_kernel``),
    their bound at the bf16 peak (the forward's three products over the
    kept pairs, the backward's nine: ``work.flash_attention_bwd``), the
    plain backward's ms, and SDPA's backward as ``library_ms`` (the
    yardstick, which the port never calls; kv heads read by enable_gqa)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(shp, generator=gen, device=dev).to(torch.bfloat16)
                   for shp in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d), (b, s, h, d)))
    want, lse_want = flash_attention_plain(q, k, v, causal, window, with_lse=True)
    res = {"shape": [b, s, t, h, kh, d], "causal": causal, "window": window}
    tol = LM_KERNEL_TOL[torch.bfloat16]
    for label, nf in (("online", False), ("normalise_first", True)):
        f0, b0 = flash_attention.launches, flash_attention_bwd.launches
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   normalize_first=nf, return_lse=True)
        grads = flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
        again = flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
        plain = flash_attention_bwd_plain(q, k, v, out, do, lse, causal, window)
        coarse = flash_attention_bwd_plain(q, k, v, out, do, lse, causal, window,
                                           ds_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        row = {"out_err": row_err(out.float(), want.float()),
               "lse_max_abs_err": float((lse - lse_want).abs().max()),
               **{f"d{n}_err": grad_row_err(g, w) for n, g, w in zip("qkv", grads, plain)},
               **{f"d{n}_rel": rel2(g, w) for n, g, w in zip("qkv", grads, plain)},
               "bf16_ds_rel": [rel2(c, w) for c, w in zip(coarse[:2], plain[:2])],
               "bit_equal": all(torch.equal(x, y) for x, y in zip(grads, again)),
               "launches": [flash_attention.launches - f0, flash_attention_bwd.launches - b0]}
        res[label] = row
        del coarse
        if not (row["out_err"] <= tol and row["lse_max_abs_err"] <= 1e-5
                and max(row[f"d{n}_err"] for n in "qkv") <= tol
                and max(row[f"d{n}_rel"] for n in "qkv") <= FLASH_GRAD_REL_TOL
                and min(row["bf16_ds_rel"]) > FLASH_GRAD_REL_TOL and row["bit_equal"]
                and row["launches"] == [1, 4]):
            raise AssertionError(f"the flash kernel pair disagrees with its plain versions: "
                                 f"{res} (tolerances {tol}, {FLASH_GRAD_REL_TOL})")
    if timed:
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   normalize_first=True, return_lse=True)
        pairs = attention_pairs(s, t, causal, window)
        fwd_ops = 6 * b * h * d * pairs / PEAK_BF16_FLOPS * 1e3
        bwd_flops, bwd_bytes = work.flash_attention_bwd(q, k, v, causal, window)
        bwd_ops, bwd_mem = bwd_flops / PEAK_BF16_FLOPS * 1e3, bwd_bytes / PEAK_HBM_BYTES * 1e3
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        dot = do.transpose(1, 2)

        def bwd():
            return flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)

        res.update(
            forward_nf_device_ms=device_ms(
                lambda: flash_attention(q, k, v, causal=causal, window=window,
                                        normalize_first=True, return_lse=True),
                "flash_bf16_kernel", iters=10),
            forward_online_device_ms=device_ms(
                lambda: flash_attention(q, k, v, causal=causal, window=window),
                "flash_bf16_kernel", iters=10),
            forward_nf_bound_ms=fwd_ops,
            ms=cuda_ms(bwd, iters=20),
            device_ms=(device_ms(bwd, "flash_bwd_dq_kernel", iters=10)
                       + device_ms(bwd, "flash_bwd_dkdv_kernel", iters=10)),
            dq_device_ms=device_ms(bwd, "flash_bwd_dq_kernel", iters=10),
            plain_ms=cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, out, do, lse, causal,
                                                               window), iters=5, warmup=1),
            library_ms=cuda_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                                           retain_graph=True), iters=20),
            bound_ms=max(bwd_ops, bwd_mem),
            bound_by="operations" if bwd_ops >= bwd_mem else "bytes",
            gflop=bwd_flops / 1e9, mbytes=bwd_bytes / 1e6)
    return res


def check_wkv(b, t, h, d, dtype, w_dtype, seed, timed=False, fast=False) -> dict:
    """WKV6 kernel vs its plain version (the step-by-step recurrence), out
    and final state, at one shape.  Decays exp(-exp(z)) of the model's
    range: most of them slow (z ~ N(-3, 1)), or with ``fast`` z ~ N(0, 1),
    many near 0, so each step all but replaces some state rows and a fault
    in how the lanes hold the state shows at once."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = ((torch.randn(b, t, h, d, generator=gen, device=dev) * 0.3).to(dtype)
               for _ in range(3))
    z = torch.randn(b, t, h, d, generator=gen, device=dev)
    w = torch.exp(-torch.exp(z if fast else z - 3.0)).to(w_dtype)
    u = torch.randn(h, d, generator=gen, device=dev) * 0.5
    zero = torch.zeros(b, h, d, d, device=dev)
    out, state = wkv6(r, k, v, w, u)
    out_p, state_p = wkv6_ref(r, k, v, w, u, zero)
    torch.cuda.synchronize()
    res = {"shape": [b, t, h, d], "dtype": str(dtype).replace("torch.", ""),
           "w_dtype": str(w_dtype).replace("torch.", ""), "fast_decays": fast,
           "err": norm_err(out.float(), out_p.to(dtype).float()),
           "state_err": norm_err(state, state_p),
           "max_abs_err": float((out.float() - out_p.to(dtype).float()).abs().max())}
    tol = LM_KERNEL_TOL[dtype]
    if not (res["err"] <= tol and res["state_err"] <= LM_KERNEL_TOL[torch.float32]):
        raise AssertionError(f"wkv6 disagrees with its plain version: {res} "
                             f"(tolerance {tol} out, 1e-5 state)")
    if timed:
        n = b * t * h * d
        res.update(
            ms=cuda_ms(lambda: wkv6(r, k, v, w, u), iters=20),
            device_ms=device_ms(lambda: wkv6(r, k, v, w, u), "wkv6_kernel", iters=10),
            plain_ms=cuda_ms(lambda: wkv6_ref(r, k, v, w, u, zero), iters=3, warmup=1),
            **bound(7 * b * t * h * d * d,
                    4 * n * r.element_size() + n * w.element_size() + 4 * h * d
                    + 4 * b * h * d * d))
    return res


def device_time(fn, top: int = 5, find: str = ""):
    """Seconds of device time (every kernel and copy) that one call of
    ``fn`` takes, from the profiler, and its ``top`` kernels by time; with
    ``find``, also ``pick`` of the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    if total <= 0:
        raise AssertionError("the profiler recorded no device time")
    events.sort(key=lambda e: -e.self_device_time_total)
    rows = [{"kernel": e.key[:70], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3,
             "share": e.self_device_time_total / total} for e in events[:top]]
    if find:
        return total / 1e6, rows, pick(events, find)
    return total / 1e6, rows


def lm_adapters(model, gen) -> dict:
    """Two tenants' adapters, every leaf ~ N(0, 0.05) as in
    tests/test_serving.py: B is not zero, so each adapter changes the
    output."""
    adapters = {}
    for tenant in ("client-a", "client-b"):
        adapters[tenant] = model.init_lora(gen)
        for leaf in _leaves(adapters[tenant]):
            leaf.normal_(0.0, 0.05, generator=gen)
    return adapters


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class RouterLog:
    """Records the expert ids of every MoE router call while active (the
    blocks look ``_router`` up in their module at each call)."""

    def __init__(self):
        self.ids = []

    def __enter__(self):
        self._orig = blocks_module._router

        def logged(cfg, p, lora, xg):
            out = self._orig(cfg, p, lora, xg)
            self.ids.append(out[1])
            return out

        blocks_module._router = logged
        return self

    def __exit__(self, *exc):
        blocks_module._router = self._orig


class PlainAttention:
    """Inside (where ``on``), ``attention_full`` declines the flash kernels
    (``layers._flash_domain`` answers None) and runs its plain PyTorch
    forms: "naive" the materialised softmax, "chunked" the online one.  A
    "plain" setting then holds the kernels against plain PyTorch, not
    against another of their own instances."""

    def __init__(self, on: bool = True):
        self.on = on

    def __enter__(self):
        self._orig = layers_module._flash_domain
        if self.on:
            layers_module._flash_domain = lambda *args, **kwargs: None
        return self

    def __exit__(self, *exc):
        layers_module._flash_domain = self._orig


def kept_sets(cfg, eidx: torch.Tensor) -> torch.Tensor:
    """Each token's experts that keep a slot at the capacity (one dispatch
    group of ``eidx``'s tokens, the rule of ``blocks._moe_group_sorted``),
    sorted, -1 where an entry drops."""
    t, k = eidx.shape
    n, e = t * k, cfg.moe.num_experts
    cap = max(1, int(math.ceil(n / e * cfg.moe.capacity_factor)))
    flat = eidx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=e)
    start = torch.cumsum(counts, 0) - counts
    sorted_e = flat[order]
    keep = torch.empty_like(flat, dtype=torch.bool)
    keep[order] = torch.arange(n, device=flat.device) - start[sorted_e] < cap
    return torch.where(keep, flat, -1).reshape(t, k).sort(dim=-1).values


def routing_flips(cfg, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Tokens whose top-k expert set differs between two routings of one
    group, and tokens whose kept (slotted) experts differ."""
    return {"experts": int((got.sort(-1).values != want.sort(-1).values).any(-1).sum()),
            "kept": int((kept_sets(cfg, got) != kept_sets(cfg, want)).any(-1).sum()),
            "tokens": int(got.shape[0])}


def layer_err(cfg, got: torch.Tensor, want: torch.Tensor) -> float:
    """The per-layer reading held at LM_TOL: ``norm_err`` (the largest
    element's error over the largest element), or for the MoE family the
    relative 2-norm over the whole tensor: a token the two sides route to
    another expert (its router sees a bf16-rounded input) changes its
    output by O(1) of that token's, which the whole tensor's norm weighs
    as one token of thousands, as it is."""
    if cfg.family == "moe":
        return rel2(got.float(), want.float())
    return norm_err(got.float(), want.float())


def fp32_block(block, cfg, p, lo, x, ctx) -> torch.Tensor:
    """A block's prefill output in fp32 (plain attention, einsum LoRA) on
    the same bf16-valued weights, adapters and input, upcast."""
    cfg32 = cfg.with_(dtype="float32", attn_impl="naive",
                      lora=dataclasses.replace(cfg.lora, impl="einsum"))
    up = lambda t: tree_map(lambda a: a.float(), t)  # noqa: E731
    return block["prefill"](cfg32, up(p), up(lo), x.float(), ctx)[0]


class Fp32Hold:
    """The hybrid's LoRA prefills held against fp32: for every block
    application (each Mamba2 layer, each shared block), the kernel path's
    output against the fp32 output of the same block on the same inputs
    (``fp32_block``), by ``norm_err``, each held at LM_TOL; the einsum
    path's distance to fp32 is printed.  The bf16 einsum path rounds
    x @ A^T to bf16 before the up-projection, the fused kernels keep it in
    f32, and the SSD's decays exp(dt * A) carry a rounding of dt_raw
    through the whole sequence; so at random weights the two bf16 paths
    can part by more than either parts from fp32."""

    def __init__(self):
        self.kernel, self.einsum = [], []

    def add(self, yk, yp, y32) -> None:
        self.kernel.append(norm_err(yk.float(), y32))
        self.einsum.append(norm_err(yp.float(), y32))

    def readings(self) -> dict:
        return {"x_vs_fp32": max(self.kernel), "x_einsum_vs_fp32": max(self.einsum)}


def layerwise_prefill(model_k, model_p, params, lora, batch, fp32: bool = False) -> dict:
    """Every layer of the kernel model and of the plain model on the same
    input (the plain model's), worst error of each layer's output
    (``layer_err``) and cache leaves (``norm_err``), and of the last-token
    logits; the hybrid's shared block after each segment the same way; for
    the MoE family also each layer's routing flips (``routing_flips``) and
    the worst ``norm_err`` of an output; the encoder-decoder by
    ``layerwise_encdec``.  With ``fp32`` (the hybrid's LoRA prefills) the
    outputs are held against fp32 (``Fp32Hold``) and the kernel path's
    distance to the einsum path's is printed as ``x_kernel_vs_plain``.
    The plain model's attention runs in plain PyTorch (``PlainAttention``)."""
    cfg = model_p.cfg
    if cfg.family == "encdec":
        return layerwise_encdec(model_k, model_p, params, lora, batch)
    x = model_p.embed(params, batch)
    ctx = model_p.make_ctx(x.shape[1], x.device)
    worst, flips = {"x_kernel_vs_plain" if fp32 else "x": 0.0}, []
    ends = model_p._segment_ends()
    hold = Fp32Hold() if fp32 else None

    def held(block, p, lo, yk, ck, yp, cp):
        key_x = "x_kernel_vs_plain" if fp32 else "x"
        worst[key_x] = max(worst[key_x], layer_err(cfg, yk, yp))
        for key in cp:
            worst[key] = max(worst.get(key, 0.0), norm_err(ck[key].float(), cp[key].float()))
        if fp32:
            hold.add(yk, yp, fp32_block(block, cfg, p, lo, x, ctx))

    for i in range(cfg.n_layers):
        p_l, lo_l = _layer(params["layers"], i), _layer(lora.get("layers", {}), i)
        with RouterLog() as log_k:
            yk, ck, _ = model_k.block["prefill"](model_k.cfg, p_l, lo_l, x, ctx)
        with RouterLog() as log_p, PlainAttention():
            yp, cp, _ = model_p.block["prefill"](cfg, p_l, lo_l, x, ctx)
        held(model_p.block, p_l, lo_l, yk, ck, yp, cp)
        if cfg.family == "moe":
            worst["x_norm_err"] = max(worst.get("x_norm_err", 0.0),
                                      norm_err(yk.float(), yp.float()))
            flips.append(routing_flips(cfg, log_k.ids[0], log_p.ids[0]))
        x = yp
        if i in ends:       # the hybrid's shared block after the segment
            p_s, lo_s = params["shared"], lora.get("shared")
            yk, ck, _ = blocks_module.dense_prefill(model_k.cfg, p_s, lo_s, x, ctx)
            with PlainAttention():
                yp, cp, _ = blocks_module.dense_prefill(cfg, p_s, lo_s, x, ctx)
            held(blocks_module.DENSE, p_s, lo_s, yk, ck, yp, cp)
            x = yp
    worst["logits"] = layer_err(cfg, model_k.unembed(params, yk[:, -1:]),
                                model_p.unembed(params, yp[:, -1:]))
    if flips:
        worst["routing_flips_by_layer"] = flips
    if fp32:
        worst.update(hold.readings())
    return worst


def _enc_ctx(t: int, device) -> dict:
    return {"positions": torch.arange(t, dtype=torch.int32, device=device), "causal": False,
            "window": None, "arange": True, "moe_groups": 1, "moe_dense_fallback": False}


def layerwise_encdec(model_k, model_p, params, lora, batch) -> dict:
    """``layerwise_prefill`` of the encoder-decoder: every encoder layer of
    both models on the same input (the plain model's), then every decoder
    layer against the plain model's encoder output: worst error of the
    encoder's and the decoder's outputs, of the decoder's self- and
    cross-attention K/V, and of the last-token logits.  The plain model's
    attention runs in plain PyTorch (``PlainAttention``)."""
    cfg = model_p.cfg
    x = batch["frames"].to(torch_dtype(cfg.dtype)) + params["enc_pos"][:batch["frames"].shape[1]][None]
    ctx = _enc_ctx(x.shape[1], x.device)
    worst = {"enc_x": 0.0, "dec_x": 0.0}
    lo_enc, lo_dec = lora.get("enc_layers", {}), lora.get("dec_layers", {})
    for i in range(cfg.n_encoder_layers):
        p_l = _layer(params["enc_layers"], i)
        yk, _ = blocks_module.dense_train(model_k.cfg.with_(causal=False), p_l,
                                          _layer(lo_enc, i), x, ctx)
        with PlainAttention():
            yp, _ = blocks_module.dense_train(cfg.with_(causal=False), p_l,
                                              _layer(lo_enc, i), x, ctx)
        worst["enc_x"] = max(worst["enc_x"], norm_err(yk.float(), yp.float()))
        x = yp
    from repro_torch.models.layers import apply_norm
    enc = apply_norm(cfg, params["enc_norm"], x)
    h = model_p._dec_embed(params, batch["tokens"])
    ctxd = model_p._dec_ctx(h.shape[1], h.device)
    for i in range(cfg.n_layers):
        p_l, lo_l = _layer(params["dec_layers"], i), _layer(lo_dec, i)
        yk, ck = model_k._dec_layer(p_l, lo_l, h, enc, ctxd)
        with PlainAttention():
            yp, cp = model_p._dec_layer(p_l, lo_l, h, enc, ctxd)
        worst["dec_x"] = max(worst["dec_x"], norm_err(yk.float(), yp.float()))
        for key in cp:
            worst[key] = max(worst.get(key, 0.0), norm_err(ck[key].float(), cp[key].float()))
        h = yp
    worst["logits"] = norm_err(model_k._unembed(params, yk[:, -1:]).float(),
                               model_p._unembed(params, yp[:, -1:]).float())
    return worst


# readings of ``layerwise_prefill`` printed and not held
PRINTED_READINGS = ("x_norm_err", "routing_flips_by_layer", "x_kernel_vs_plain",
                    "x_einsum_vs_fp32")


def held_values(worst: dict) -> list:
    """The readings of ``layerwise_prefill`` held at LM_TOL."""
    return [v for key, v in worst.items() if key not in PRINTED_READINGS]


def layerwise_decode(model, params, lora, prompt):
    """For each layer: its prefill on the prompt's input to that layer, and
    its decode of the same input token by token from an empty cache of
    SERVE_CACHE slots; worst error of the outputs (``layer_err``).  The
    hybrid's shared block after each segment the same way, and for the
    hybrid also (worst error of the outputs, worst of each cache leaf after
    the decode against the prefill's: every Mamba2 layer's conv history and
    state, every segment's K/V).  The
    MoE block's decode computes every expert for every token (the
    reference's dense fallback), so its prefill here does the same
    (``moe_dense_fallback``): the prefill's capacity drops, which a
    40-token prompt meets, are the dispatch's, not the cache's
    (``lm_phase`` prints that reading too)."""
    cfg = model.cfg
    x = model.embed(params, {"tokens": prompt})
    ctx = dict(model.make_ctx(x.shape[1], x.device), moe_dense_fallback=True)
    worst, worst_cache = 0.0, {}
    ends = model._segment_ends()

    def one(block, p_l, lo_l, x):
        """The block's prefill and its token-by-token decode of ``x``."""
        nonlocal worst
        y, c_pre, _ = block["prefill"](cfg, p_l, lo_l, x, ctx)
        cache = block["init_cache"](cfg, x.shape[0], SERVE_CACHE, x.device)
        outs = []
        for t in range(x.shape[1]):
            pos = torch.full((1,), t, dtype=torch.int32, device=x.device)
            y_t, cache = block["decode"](cfg, p_l, lo_l, x[:, t:t + 1], cache, t,
                                         model.make_ctx(1, x.device, positions=pos))
            outs.append(y_t)
        worst = max(worst, layer_err(cfg, torch.cat(outs, dim=1), y))
        if ends:            # the hybrid's caches: conv/state, and K/V of the prompt's slots
            for key, want in c_pre.items():
                got = cache[key][:, :x.shape[1]] if key in ("k", "v") else cache[key]
                worst_cache[key] = max(worst_cache.get(key, 0.0),
                                       norm_err(got.float(), want.float()))
        return y

    for i in range(cfg.n_layers):
        x = one(model.block, _layer(params["layers"], i), _layer(lora.get("layers", {}), i), x)
        if i in ends:
            x = one(blocks_module.DENSE, params["shared"], lora.get("shared"), x)
    return (worst, worst_cache) if ends else worst


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def seq_kernel(cfg) -> str:
    """The sequence kernel of a family's prefill: WKV6 for RWKV6, flash
    attention for every attention family (the hybrid's shared block, the
    encoder-decoder's encoder)."""
    return "wkv6" if cfg.family == "ssm" else "flash_attention"


def lm_batch(cfg, seed: int) -> dict:
    """The prefill's input: PREFILL_BATCH prompts of PREFILL_SEQ tokens; for
    the VLM, n_vision_tokens random vision embeddings (N(0, 1) in the
    model's type) and PREFILL_SEQ - n_vision_tokens text tokens."""
    rs = np.random.default_rng(seed)
    n_text = PREFILL_SEQ - (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    batch = {"tokens": torch.from_numpy(rs.integers(0, cfg.vocab_size,
                                                    (PREFILL_BATCH, n_text))
                                        .astype(np.int32)).cuda()}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(rs.standard_normal(
            (PREFILL_BATCH, cfg.n_vision_tokens, cfg.vision_embed_dim))
            .astype(np.float32)).to(torch_dtype(cfg.dtype)).cuda()
    return batch


def random_biases(params, gen) -> int:
    """qkv biases ~ N(0, 0.5) in place (they are zero at init): a check
    with zero biases would not see them.  Returns how many were drawn."""
    n = 0
    for key in ("bq", "bk", "bv"):
        leaf = params["layers"].get("attn", {}).get(key)
        if leaf is not None:
            leaf.normal_(0.0, 0.5, generator=gen)
            n += leaf.numel()
    return n


def serve_requests(cfg, seed: int, tenants) -> list:
    """SERVE_REQUESTS greedy requests of 16-64 prompt tokens and SERVE_NEW
    new tokens, round-robin over ``tenants``."""
    rs = np.random.default_rng(seed)
    return [Request(uid=i, tenant=tenants[i % len(tenants)],
                    prompt=rs.integers(2, cfg.vocab_size,
                                       size=int(rs.integers(16, 65))).astype(np.int32),
                    max_new_tokens=SERVE_NEW) for i in range(SERVE_REQUESTS)]


def run_engine(cfg, params, adapters, reqs, seed: int, record: bool = False) -> dict:
    """One ServingEngine run over ``reqs``: wall, stats, launches (counted
    from just before ``run`` to just after), peak bytes; with ``record``
    each step's token column and logits (on the host)."""
    engine = ServingEngine(cfg, params, adapters, slots=SERVE_SLOTS, cache_len=SERVE_CACHE,
                           seed=seed)
    steps = []
    if record:
        inner = engine._step

        def step(params_, lora_, cache_, tok_, pos_):
            logits, cache_ = inner(params_, lora_, cache_, tok_, pos_)
            steps.append((tok_.cpu(), logits[:, -1].float().cpu()))
            return logits, cache_

        engine._step = step
    for r in reqs:
        engine.submit(r)
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()                                  # just before the path runs
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()                          # just after
    # each tenant's requests drain in batches of SERVE_SLOTS, in order; a
    # batch takes its longest prompt's steps and SERVE_NEW - 1 more
    tenants = sorted({r.tenant for r in reqs})
    queues = [[r for r in reqs if r.tenant == t] for t in tenants]
    want_stats = {"decode_steps": sum(max(len(r.prompt) for r in q[i:i + SERVE_SLOTS])
                                      + SERVE_NEW - 1
                                      for q in queues for i in range(0, len(q), SERVE_SLOTS)),
                  "adapter_switches": len(tenants), "completed": len(reqs)}
    out = {"wall_s": wall, "stats": engine.stats, "launches": counts,
           "tenants": len(tenants), "new_tokens": SERVE_NEW * len(done),
           "prompt_tokens": sum(len(r.prompt) for r in reqs),
           "tokens_per_s": SERVE_NEW * len(done) / wall,
           "steps_per_s": engine.stats["decode_steps"] / wall,
           "max_mem_bytes": torch.cuda.max_memory_allocated()}
    if counts != {name: 0 for name in COUNTERS}:
        raise AssertionError(f"{cfg.name} decode launched a kernel: {counts}")
    if engine.stats != want_stats:
        raise AssertionError(f"{cfg.name} engine stats {engine.stats}, expected {want_stats}")
    if sorted(r.uid for r in done) != sorted(r.uid for r in reqs) or any(
            r.output is None or len(r.output) != SERVE_NEW
            or not ((r.output >= 0) & (r.output < cfg.vocab_size)).all() for r in done):
        raise AssertionError(f"{cfg.name}: not every request completed with "
                             f"{SERVE_NEW} tokens")
    out["outputs"] = {r.uid: r.output.tolist() for r in done}
    if record:
        out["steps"] = steps
    return out


def int8_cache_gap(fp: dict, q: dict) -> dict:
    """The int8-cache engine against the model-type cache engine on the same
    requests: each step's logits gap (max |diff| over the float logits'
    max |value|, the reference's reading in
    tests/test_fused_lora_integration.py), over the steps whose token
    column both engines fed alike (after the first greedy disagreement the
    two decode different tokens); and greedy agreement."""
    gaps, same = [], 0
    for (tok_f, lf), (tok_q, lq) in zip(fp["steps"], q["steps"]):
        if not torch.equal(tok_f, tok_q):
            break
        same += 1
        gaps.append(float((lf - lq).abs().max() / lf.abs().max().clamp_min(1e-9)))
    agree = [sum(int(a == b) for a, b in zip(fp["outputs"][uid], q["outputs"][uid]))
             for uid in fp["outputs"]]
    return {"steps_compared": same, "steps": len(fp["steps"]), "max_gap": max(gaps),
            "mean_gap": sum(gaps) / len(gaps),
            "greedy_tokens_agreeing": sum(agree),
            "greedy_tokens": SERVE_NEW * len(agree), "tolerance": INT8_CACHE_TOL}


def lm_phase(arch: str, seed: int, layers: Optional[int] = None,
             one_tenant: bool = False, int8_cache: bool = False) -> dict:
    """Prefill and serving of one decoder LM at full width (and depth, unless
    ``layers`` cuts it) in its published bf16, random weights from
    ``seed`` (qkv biases drawn too); with ``one_tenant`` also an engine
    run with one tenant's requests, and with ``int8_cache`` the two-tenant
    run again on an int8 KV cache against the model-type one."""
    base = REGISTRY[arch]
    if layers is not None:
        base = base.with_(n_layers=layers)
    if base.family == "encdec":
        return lm_phase_encdec(base, seed)
    kernels_cfg = base.with_(attn_impl="chunked", wkv_impl="chunked")
    # the hybrid's SSD has no kernel: both settings run its plain chunked form
    plain_cfg = base.with_(attn_impl="naive",
                           wkv_impl="chunked" if base.family == "hybrid" else "scan")
    expect = no_launches(**{seq_kernel(base): seq_launches(base)})
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(kernels_cfg)                    # on the card by default
    params = model.init_params(gen)
    biases = random_biases(params, gen)
    adapters = lm_adapters(model, gen)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    out = {"arch": arch, "family": base.family, "dtype": base.dtype,
           "layers": base.n_layers, "published_layers": REGISTRY[arch].n_layers,
           "d_model": base.d_model, "vocab": base.vocab_size, "params": n_params,
           "param_bytes": sum(x.numel() * x.element_size() for x in _leaves(params)),
           "qkv_bias_values": biases, "init_s": time.perf_counter() - t0,
           "init_peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"[lm:{arch}] {json.dumps(out)}", flush=True)

    batch = lm_batch(base, seed)
    lora = adapters["client-a"]
    runs, prefill_rows = {}, {}
    for label, cfg in (("kernels", kernels_cfg), ("plain", plain_cfg)):
        m = build_model(cfg)
        with torch.no_grad(), PlainAttention(label == "plain"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()                              # just before the path runs
            t0 = time.perf_counter()
            logits, cache = m.prefill(params, lora, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()                      # just after
            peak = torch.cuda.max_memory_allocated()
            dev_s, top = device_time(lambda: m.prefill(params, lora, batch))
        want = expect if label == "kernels" else no_launches()
        row = {"wall_s": wall, "device_s": dev_s, "busy_share": dev_s / wall,
               "max_mem_bytes": peak, "launches": counts,
               "tokens_per_s": PREFILL_BATCH * PREFILL_SEQ / wall, "top": top}
        print(f"[lm:{arch}] prefill {label} ({cfg.attn_impl}/{cfg.wkv_impl}) "
              f"{json.dumps(row)}", flush=True)
        if counts != want:
            raise AssertionError(f"{arch} prefill {label}: launches {counts}, expected {want}")
        if not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"{arch} prefill {label}: non-finite logits")
        if tuple(logits.shape) != (PREFILL_BATCH, 1, base.vocab_size):
            raise AssertionError(f"{arch} prefill {label}: logits {tuple(logits.shape)}")
        runs[label] = (logits, cache, row)
        prefill_rows[label] = row
    (lk, ck, _), (lp, cp, _) = runs["kernels"], runs["plain"]
    free = {"logits_err": norm_err(lk.float(), lp.float()),
            "logits_rel2": rel2(lk.float(), lp.float()),
            "cache_err": {name: norm_err(a.float(), b.float()) for name, a, b in
                          zip(_leaf_names(ck), tree_leaves(ck), tree_leaves(cp))},
            "argmax_equal": int((lk.argmax(-1) == lp.argmax(-1)).sum())}
    del runs, lk, ck, lp, cp, logits, cache
    with torch.no_grad():
        held = layerwise_prefill(build_model(kernels_cfg), build_model(plain_cfg),
                                 params, lora, batch)
    cmp = {"free_running": free, "per_layer": held, "tolerance": LM_TOL}
    print(f"[lm:{arch}] prefill kernels vs plain {json.dumps(cmp)}", flush=True)
    if not max(held_values(held)) <= LM_TOL:
        raise AssertionError(f"{arch}: the kernel prefill and the plain prefill disagree "
                             f"layer by layer: {held}")
    out["prefill"] = {"kernels": prefill_rows["kernels"], "plain": prefill_rows["plain"],
                      **cmp}
    if base.family == "hybrid":
        out["ssd"] = ssd_share(model, params, lora, batch,
                               prefill_rows["kernels"]["device_s"])
        print(f"[lm:{arch}] the plain SSD's share of the prefill's device time "
              f"{json.dumps(out['ssd'])}", flush=True)
    out["lora_kernels"] = lm_lora_prefill(kernels_cfg, params, adapters, batch)

    # serving: six greedy requests over two tenants (and over one)
    tenants = ("client-a", "client-b")
    reqs = serve_requests(base, seed + 1, tenants)
    serve = run_engine(kernels_cfg, params, adapters, reqs, seed, record=int8_cache)
    with torch.no_grad():
        serve_dev_s, serve_top = device_time(
            lambda: model.serve_step(params, adapters["client-a"],
                                     model.init_cache(SERVE_SLOTS, SERVE_CACHE),
                                     torch.ones((SERVE_SLOTS, 1), dtype=torch.int32,
                                                device="cuda"), 0))
        t1 = time.perf_counter()
        model.serve_step(params, adapters["client-a"],
                         model.init_cache(SERVE_SLOTS, SERVE_CACHE),
                         torch.ones((SERVE_SLOTS, 1), dtype=torch.int32, device="cuda"), 0)
        torch.cuda.synchronize()
        step_wall = time.perf_counter() - t1
    serve["one_step"] = {"wall_s": step_wall, "device_s": serve_dev_s,
                         "busy_share": serve_dev_s / step_wall, "top": serve_top}
    steps = serve.pop("steps", None)
    outputs = serve.pop("outputs")
    print(f"[lm:{arch}] serve {json.dumps(serve)}", flush=True)
    print(f"[lm:{arch}] outputs " + json.dumps({uid: o[:8] for uid, o in outputs.items()}),
          flush=True)
    out["serve"] = serve
    if one_tenant:      # one batch of SERVE_SLOTS - 1 requests of one tenant
        solo = run_engine(kernels_cfg, params, adapters,
                          serve_requests(base, seed + 2, ("client-a",))[:SERVE_SLOTS - 1],
                          seed)
        solo.pop("outputs")
        print(f"[lm:{arch}] serve one tenant {json.dumps(solo)}", flush=True)
        out["serve_one_tenant"] = solo
    if int8_cache:
        q_cfg = kernels_cfg.with_(kv_cache_dtype="int8")
        q = run_engine(q_cfg, params, adapters, serve_requests(base, seed + 1, tenants),
                       seed, record=True)
        gap = int8_cache_gap({"steps": steps, "outputs": outputs}, q)
        q.pop("steps")
        q.pop("outputs")
        gap["engine"] = q
        gap["cache_bytes"] = {
            dt: sum(x.numel() * x.element_size() for x in _leaves(
                build_model(c).init_cache(SERVE_SLOTS, SERVE_CACHE)))
            for dt, c in (("model", kernels_cfg), ("int8", q_cfg))}
        print(f"[lm:{arch}] serve int8 KV cache vs {base.dtype} cache {json.dumps(gap)}",
              flush=True)
        if not gap["max_gap"] < INT8_CACHE_TOL:
            raise AssertionError(f"{arch}: the int8 KV cache's logits leave the reference's "
                                 f"bound: {gap}")
        out["int8_cache"] = gap

    # the reference's invariant, decode == the parallel forward: for one
    # request's prompt, through the entry points (reported) and layer by
    # layer from shared inputs (held)
    req = reqs[0]
    prompt = torch.from_numpy(req.prompt[None]).cuda()
    lora = adapters[req.tenant]
    with torch.no_grad():
        pre, _ = model.prefill(params, lora, {"tokens": prompt})
        cache = model.init_cache(1, SERVE_CACHE)
        for i in range(prompt.shape[1]):
            dec, cache = model.serve_step(params, lora, cache, prompt[:, i:i + 1], i)
        held = layerwise_decode(model, params, lora, prompt)
    torch.cuda.synchronize()
    held, held_cache = held if isinstance(held, tuple) else (held, {})
    inv = {"prompt_len": int(prompt.shape[1]),
           "free_running": {"logits_err": norm_err(dec.float(), pre.float()),
                            "argmax_equal": bool(dec.argmax(-1) == pre.argmax(-1))},
           "per_layer_err": held, "tolerance": LM_TOL}
    if held_cache:
        inv["per_layer_cache_err"] = held_cache
    print(f"[lm:{arch}] decode vs prefill {json.dumps(inv)}", flush=True)
    if not max([held, *held_cache.values()]) <= LM_TOL:
        raise AssertionError(f"{arch}: decode and prefill of one prompt disagree "
                             f"layer by layer: {inv}")
    out["decode_vs_prefill"] = inv
    del model, params, adapters, lora, cache, pre, dec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ssd_share(model, params, lora, batch, prefill_device_s: float) -> dict:
    """The plain SSD's share of a hybrid prefill's device time: the device
    time of one ``ssd_apply`` call on layer 0's own inputs (captured from
    that layer's prefill), times the layers, over the whole prefill's."""
    cfg = model.cfg
    seen = []
    orig = blocks_module.ssd_apply

    def capture(*args):
        seen.append(args)
        return orig(*args)

    with torch.no_grad():
        x = model.embed(params, batch)
        blocks_module.ssd_apply = capture
        try:
            model.block["prefill"](cfg, _layer(params["layers"], 0),
                                   _layer(lora["layers"], 0), x,
                                   model.make_ctx(x.shape[1], x.device))
        finally:
            blocks_module.ssd_apply = orig
        one, _ = device_time(lambda: orig(*seen[0]))
    return {"ssd_device_s_one_layer": one, "ssd_device_s_all_layers": one * cfg.n_layers,
            "prefill_device_s": prefill_device_s,
            "share": one * cfg.n_layers / prefill_device_s}


def encdec_batch(cfg, seed: int) -> dict:
    """The encoder-decoder's prefill input: PREFILL_BATCH clips of
    ``encoder_seq`` random frames (N(0, 1) in the model's type; the conv
    frontend is the reference's stub) and prompts of ENCDEC_PROMPT tokens."""
    rs = np.random.default_rng(seed)
    frames = rs.standard_normal((PREFILL_BATCH, cfg.encoder_seq, cfg.d_model))
    return {"frames": torch.from_numpy(frames.astype(np.float32))
            .to(torch_dtype(cfg.dtype)).cuda(),
            "tokens": torch.from_numpy(rs.integers(0, cfg.vocab_size,
                                                   (PREFILL_BATCH, ENCDEC_PROMPT))
                                       .astype(np.int32)).cuda()}


def encdec_decode_check(model, params, lora, batch) -> dict:
    """The encoder-decoder's decode against its teacher-forced forward on
    one clip and prompt.  The prefill's cache holds the prompt's length and
    cannot be decoded into, so a fresh ``init_cache`` takes the prefill's
    cross-attention K/V and the prompt is fed token by token through
    ``serve_step``; every step's logits are held against the teacher-forced
    logits at that position (``norm_err`` over all of them, LM_TOL)."""
    one = _rows(batch, 0, 1)
    tokens = one["tokens"]
    s = tokens.shape[1]
    with torch.no_grad():
        enc = model.encode(params, lora, one["frames"])
        teacher = model.decode_train(params, lora, tokens, enc)
        _, pre = model.prefill(params, lora, one)
        cache = model.init_cache(1, s)
        cache["xk"].copy_(pre["xk"])
        cache["xv"].copy_(pre["xv"])
        steps = []
        for i in range(s):
            lg, cache = model.serve_step(params, lora, cache, tokens[:, i:i + 1], i)
            steps.append(lg)
        dec = torch.cat(steps, dim=1)
    torch.cuda.synchronize()
    return {"prompt_len": s, "logits_err": norm_err(dec.float(), teacher.float()),
            "logits_rel2": rel2(dec.float(), teacher.float()),
            "argmax_equal": int((dec.argmax(-1) == teacher.argmax(-1)).sum()),
            "tolerance": LM_TOL}


def lm_phase_encdec(base, seed: int) -> dict:
    """``lm_phase`` for the encoder-decoder (whisper-large-v3) at full width
    and depth in bf16, random weights from ``seed``, on ``encdec_batch``:
    the prefill under attn_impl "chunked" (the encoder's 32 non-causal
    attentions through the flash kernel's online instance, the decoder's
    64 self- and cross-attentions, "naive" in the reference, through its
    normalise-first one; launches asserted) and "naive" in plain PyTorch
    (``PlainAttention``: no launch), held layer by layer
    (``layerwise_encdec``); the fused and
    the two-tenant grouped LoRA prefills (``lm_lora_prefill``: one bf16
    launch per adapted projection, 4 an encoder layer and 8 a decoder
    layer, every one on the wgmma tile); and the decode check
    (``encdec_decode_check``: every step's logits against the
    teacher-forced ones).  No ServingEngine run: the engine serves
    token streams and has no frames to encode, as in the reference."""
    arch = base.name
    kernels_cfg = base.with_(attn_impl="chunked")
    plain_cfg = base.with_(attn_impl="naive")
    expect = no_launches(**{seq_kernel(base): seq_launches(base)})
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(kernels_cfg)                    # on the card by default
    params = model.init_params(gen)
    adapters = lm_adapters(model, gen)
    torch.cuda.synchronize()
    out = {"arch": arch, "family": base.family, "dtype": base.dtype,
           "layers": base.n_encoder_layers + base.n_layers,
           "published_layers": REGISTRY[arch].n_encoder_layers + REGISTRY[arch].n_layers,
           "encoder_layers": base.n_encoder_layers, "decoder_layers": base.n_layers,
           "d_model": base.d_model, "vocab": base.vocab_size,
           "frames": [PREFILL_BATCH, base.encoder_seq], "prompt": ENCDEC_PROMPT,
           "params": sum(x.numel() for x in _leaves(params)),
           "param_bytes": sum(x.numel() * x.element_size() for x in _leaves(params)),
           "init_s": time.perf_counter() - t0,
           "init_peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"[lm:{arch}] {json.dumps(out)}", flush=True)
    batch = encdec_batch(base, seed)
    lora = adapters["client-a"]
    runs, rows = {}, {}
    for label, cfg in (("kernels", kernels_cfg), ("plain", plain_cfg)):
        m = build_model(cfg)
        with torch.no_grad(), PlainAttention(label == "plain"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()                              # just before the path runs
            t0 = time.perf_counter()
            logits, cache = m.prefill(params, lora, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()                      # just after
            peak = torch.cuda.max_memory_allocated()
            dev_s, top = device_time(lambda: m.prefill(params, lora, batch))
        row = {"wall_s": wall, "device_s": dev_s, "busy_share": dev_s / wall,
               "max_mem_bytes": peak, "launches": counts,
               "tokens_per_s": PREFILL_BATCH * (ENCDEC_PROMPT + base.encoder_seq) / wall,
               "top": top}
        print(f"[lm:{arch}] prefill {label} ({cfg.attn_impl}) {json.dumps(row)}", flush=True)
        want = expect if label == "kernels" else no_launches()
        if counts != want:
            raise AssertionError(f"{arch} prefill {label}: launches {counts}, expected {want}")
        if tuple(logits.shape) != (PREFILL_BATCH, 1, base.vocab_size) or not bool(
                torch.isfinite(logits.float()).all()):
            raise AssertionError(f"{arch} prefill {label}: logits {tuple(logits.shape)}, "
                                 f"finite {bool(torch.isfinite(logits.float()).all())}")
        runs[label], rows[label] = (logits, cache), row
    (lk, ck), (lp, cp) = runs["kernels"], runs["plain"]
    free = {"logits_err": norm_err(lk.float(), lp.float()),
            "logits_rel2": rel2(lk.float(), lp.float()),
            "cache_err": {key: norm_err(ck[key].float(), cp[key].float()) for key in ck},
            "argmax_equal": int((lk.argmax(-1) == lp.argmax(-1)).sum())}
    del runs, lk, ck, lp, cp, logits, cache
    with torch.no_grad():
        held = layerwise_encdec(build_model(kernels_cfg), build_model(plain_cfg), params,
                                lora, batch)
    cmp = {"free_running": free, "per_layer": held, "tolerance": LM_TOL}
    print(f"[lm:{arch}] prefill kernels vs plain {json.dumps(cmp)}", flush=True)
    if not max(held.values()) <= LM_TOL:
        raise AssertionError(f"{arch}: the kernel prefill and the plain prefill disagree "
                             f"layer by layer: {held}")
    out["prefill"] = {"kernels": rows["kernels"], "plain": rows["plain"], **cmp}
    out["lora_kernels"] = lm_lora_prefill(kernels_cfg, params, adapters, batch)
    inv = encdec_decode_check(model, params, lora, batch)
    print(f"[lm:{arch}] decode vs teacher-forced {json.dumps(inv)}", flush=True)
    if not inv["logits_err"] <= LM_TOL:
        raise AssertionError(f"{arch}: decode and the teacher-forced decoder disagree: "
                             f"{inv}")
    out["decode_vs_teacher_forced"] = inv
    del model, params, adapters, lora
    gc.collect()
    torch.cuda.empty_cache()
    return out


def build_phase() -> dict:
    """Every registered config (all twelve, of every family) through
    ``build_model`` on the card at full width and BUILD_LAYERS layers (the
    encoder-decoder: that many encoder and decoder layers) in their
    published types, random weights, one forward without grad of BUILD_SEQ
    tokens (the encoder-decoder: its ``encoder_seq`` random frames, side
    "full"), whose hidden states must be finite."""
    out = {}
    for name, cfg in REGISTRY.items():
        # the per-layer hybrid keeps both of its mixers
        cut = cfg.with_(n_layers=min(cfg.n_layers, BUILD_LAYERS),
                        n_encoder_layers=min(cfg.n_encoder_layers, BUILD_LAYERS),
                        layer_types=("mamba", "attention")[:BUILD_LAYERS] if cfg.layer_types
                        else ())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cut)
        params = model.init_params(torch.Generator(device="cuda").manual_seed(90))
        gen = torch.Generator(device="cuda").manual_seed(91)
        batch = {"tokens": torch.randint(0, cut.vocab_size, (1, BUILD_SEQ), device="cuda",
                                         generator=gen)}
        seq = BUILD_SEQ
        if cfg.family == "encdec":
            seq = cfg.encoder_seq
            batch["frames"] = torch.randn((1, seq, cfg.d_model), device="cuda",
                                          generator=gen).to(torch_dtype(cfg.dtype))
        with torch.no_grad():
            h, _ = model.forward_hidden(params, None, batch, side="full")
        torch.cuda.synchronize()
        row = {"family": cfg.family, "dtype": cfg.dtype, "layers": cut.n_layers,
               "encoder_layers": cut.n_encoder_layers,
               "d_model": cfg.d_model, "params": sum(x.numel() for x in _leaves(params)),
               "wall_s": time.perf_counter() - t0,
               "peak_bytes": torch.cuda.max_memory_allocated()}
        if tuple(h.shape) != (1, seq, cfg.d_model) or not bool(
                torch.isfinite(h.float()).all()):
            raise AssertionError(f"{name}: forward on the card gave {tuple(h.shape)}, "
                                 f"finite {bool(torch.isfinite(h.float()).all())}")
        out[name] = row
        del model, params, h
        torch.cuda.empty_cache()
    print(f"[build-models] {json.dumps(out)}", flush=True)
    return out


def lora_projections(lora) -> int:
    """The adapted projections a pass over each layer once applies: one per
    {a, b} pair of the model's LoRA tree, times the layers the tree stacks
    (an unstacked pair, the hybrid's shared block's, counts once)."""
    if "a" in lora and not isinstance(lora["a"], dict):
        return int(lora["a"].shape[0]) if lora["a"].dim() == 3 else 1
    return sum(lora_projections(v) for v in lora.values() if isinstance(v, dict))


def n_segments(cfg) -> int:
    """The hybrid's segments: one shared-block application after each."""
    return -(-cfg.n_layers // cfg.shared_attn_every) if cfg.family == "hybrid" else 0


def prefill_projections(cfg, lora) -> int:
    """The adapted projections one prefill applies: the shared block's
    once a segment."""
    n = lora_projections(lora)
    if "shared" in lora:
        n += (n_segments(cfg) - 1) * lora_projections(lora["shared"])
    return n


def seq_launches(cfg) -> int:
    """Launches of the sequence kernel in one prefill: one a layer; the
    hybrid's flash one a segment (its Mamba2 SSD has no kernel); the
    encoder-decoder's one an encoder layer and two a decoder layer (its
    decoder's self- and cross-attention are "naive", which on the card in
    bf16 runs the flash kernel's normalise-first instance)."""
    if cfg.family == "hybrid":
        return n_segments(cfg)
    if cfg.family == "encdec":
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def stack_tenants(loras) -> dict:
    """Tenants' adapters as one cohort-grouped tree: a layer stack's leaves
    (L, G, ...), the hybrid's shared block's (G, ...)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=1 if xs[0].dim() == 3 else 0), *loras)


def router_projections(cfg) -> int:
    """The f32 adapted projections a layer applies: the MoE router, when
    the adapters target it (``wr_router``); every other adapted
    projection is in the model's type."""
    return int(cfg.family == "moe" and "wr_router" in cfg.lora.targets)


def _prefill_counted(model, params, lora, batch) -> tuple:
    """One prefill, its wall time and the launches of every kernel in it."""
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()                                  # just before the path runs
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, lora, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()                          # just after
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{model.cfg.name} prefill: non-finite logits")
    return logits, wall, counts


def _rows(batch, lo: int, hi: int) -> dict:
    return {key: v[lo:hi] for key, v in batch.items()}


def layerwise_grouped(model_g, model_p, params, lora_g, loras, batch) -> list:
    """Every layer of the grouped model on the two tenants' prompts
    concatenated (tenant i's adapters on rows of half i; for the MoE family
    each half its own dispatch group, ``moe_groups=2``, as each tenant's
    prefill alone has) against each tenant's layer of the plain model on
    its half, from the same inputs (the plain model's): worst error
    (``layer_err``) of each half."""
    cfg = model_p.cfg
    if cfg.family == "encdec":
        return layerwise_grouped_encdec(model_g, model_p, params, lora_g, loras, batch)
    h = batch["tokens"].shape[0] // 2
    xs = [model_p.embed(params, _rows(batch, i * h, (i + 1) * h)) for i in range(2)]
    seq = xs[0].shape[1]
    ctx = model_p.make_ctx(seq, xs[0].device)
    ctx_g = model_g.make_ctx(seq, xs[0].device, moe_groups=2)
    worst = [0.0, 0.0]
    ends = model_p._segment_ends()
    # the hybrid is held against fp32, as its one-tenant prefill (Fp32Hold)
    holds = [Fp32Hold(), Fp32Hold()] if ends else None

    def held(block, p, los, yg, ys):
        for half in range(2):
            got = yg[half * h:(half + 1) * h]
            worst[half] = max(worst[half], layer_err(cfg, got, ys[half]))
            if holds:
                holds[half].add(got, ys[half],
                                fp32_block(block, cfg, p, los[half], xs[half], ctx))

    for i in range(cfg.n_layers):
        p_l = _layer(params["layers"], i)
        los = [_layer(lo["layers"], i) for lo in loras]
        yg, _, _ = model_g.block["prefill"](model_g.cfg, p_l, _layer(lora_g["layers"], i),
                                            torch.cat(xs), ctx_g)
        ys = [model_p.block["prefill"](cfg, p_l, lo, x, ctx)[0] for lo, x in zip(los, xs)]
        held(model_p.block, p_l, los, yg, ys)
        xs = ys
        if i in ends:       # the shared block, its adapters grouped (G, r, K)
            los = [lo["shared"] for lo in loras]
            yg, _, _ = blocks_module.dense_prefill(model_g.cfg, params["shared"],
                                                   lora_g["shared"], torch.cat(xs), ctx_g)
            ys = [blocks_module.dense_prefill(cfg, params["shared"], lo, x, ctx)[0]
                  for lo, x in zip(los, xs)]
            held(blocks_module.DENSE, params["shared"], los, yg, ys)
            xs = ys
    if holds:
        return {"kernel_vs_plain": worst, "vs_fp32": [hd.readings() for hd in holds]}
    return worst


def layerwise_grouped_encdec(model_g, model_p, params, lora_g, loras, batch) -> list:
    """``layerwise_grouped`` of the encoder-decoder: every encoder layer and
    then every decoder layer (against each tenant's plain encoder output)
    of the grouped model on the two tenants' rows concatenated, against
    each tenant's layer of the plain model on its half."""
    cfg = model_p.cfg
    enc_cfg_g, enc_cfg_p = model_g.cfg.with_(causal=False), cfg.with_(causal=False)
    h = batch["tokens"].shape[0] // 2
    halves = [_rows(batch, i * h, (i + 1) * h) for i in range(2)]
    t = batch["frames"].shape[1]
    xs = [b_["frames"].to(torch_dtype(cfg.dtype)) + params["enc_pos"][:t][None]
          for b_ in halves]
    ctx = _enc_ctx(t, xs[0].device)
    worst = [0.0, 0.0]

    def held(yg, ys):
        for half in range(2):
            worst[half] = max(worst[half], norm_err(yg[half * h:(half + 1) * h].float(),
                                                    ys[half].float()))

    for i in range(cfg.n_encoder_layers):
        p_l = _layer(params["enc_layers"], i)
        yg, _ = blocks_module.dense_train(enc_cfg_g, p_l, _layer(lora_g["enc_layers"], i),
                                          torch.cat(xs), ctx)
        ys = [blocks_module.dense_train(enc_cfg_p, p_l, _layer(lo["enc_layers"], i), x, ctx)[0]
              for lo, x in zip(loras, xs)]
        held(yg, ys)
        xs = ys
    from repro_torch.models.layers import apply_norm
    encs = [apply_norm(cfg, params["enc_norm"], x) for x in xs]
    hs = [model_p._dec_embed(params, b_["tokens"]) for b_ in halves]
    ctxd = model_p._dec_ctx(hs[0].shape[1], hs[0].device)
    for i in range(cfg.n_layers):
        p_l = _layer(params["dec_layers"], i)
        yg, _ = model_g._dec_layer(p_l, _layer(lora_g["dec_layers"], i), torch.cat(hs),
                                   torch.cat(encs), ctxd)
        ys = [model_p._dec_layer(p_l, _layer(lo["dec_layers"], i), h_, e_, ctxd)[0]
              for lo, h_, e_ in zip(loras, hs, encs)]
        held(yg, ys)
        hs = ys
    return worst


def lm_lora_prefill(kernels_cfg, params, adapters, batch) -> dict:
    """The bf16 LoRA kernels on an LM's prefill (4 x 2048 tokens, attention
    or WKV through its kernel): ``LoRAConfig(impl="fused")`` with one
    tenant's adapters (lora_matmul, bf16; the MoE router's adapter fp32)
    and with two tenants' adapters stacked into a (G = 2, ...) group per
    layer, prompts 0-1 to the first and 2-3 to the second (grouped_lora
    chunk, bf16; the router fp32); each held layer by layer against the
    einsum prefill (per tenant for the group)."""
    arch = kernels_cfg.name
    fused_cfg = kernels_cfg.with_(lora=dataclasses.replace(kernels_cfg.lora, impl="fused"))
    lora = adapters["client-a"]
    n_proj = prefill_projections(kernels_cfg, lora)
    n_f32 = router_projections(kernels_cfg) * kernels_cfg.n_layers
    n_bf16 = n_proj - n_f32
    seq = {seq_kernel(kernels_cfg): seq_launches(kernels_cfg)}
    fused_model, einsum_model = build_model(fused_cfg), build_model(kernels_cfg)
    out = {"adapted_projections": n_proj, "f32_projections": n_f32}

    _, wall_e, counts_e = _prefill_counted(einsum_model, params, lora, batch)
    logits_f, wall_f, counts_f = _prefill_counted(fused_model, params, lora, batch)
    # every bf16 launch on the wgmma tile
    want = no_launches(lora_matmul=n_proj, lora_matmul_bf16=n_bf16, lora_matmul_wgmma=n_bf16,
                       **seq)
    if counts_f != want:
        raise AssertionError(f"{arch} fused prefill: launches {counts_f}, expected {want}")
    hybrid = kernels_cfg.family == "hybrid"
    with torch.no_grad():
        held = layerwise_prefill(fused_model, einsum_model, params, lora, batch, fp32=hybrid)
        dev_f, top_f = device_time(lambda: fused_model.prefill(params, lora, batch))
        dev_e, top_e = device_time(lambda: einsum_model.prefill(params, lora, batch))
    out["fused"] = {"wall_s": wall_f, "einsum_wall_s": wall_e, "device_s": dev_f,
                    "einsum_device_s": dev_e, "top": top_f, "einsum_top": top_e,
                    "launches": counts_f, "per_layer": held, "tolerance": LM_TOL}
    print(f"[lm:{arch}] prefill fused LoRA vs einsum {json.dumps(out['fused'])}", flush=True)
    if not max(held_values(held)) <= LM_TOL:
        raise AssertionError(f"{arch}: the fused-LoRA prefill and the einsum prefill "
                             f"disagree layer by layer: {held}")

    loras = (adapters["client-a"], adapters["client-b"])
    grouped = stack_tenants(loras)
    logits_g, wall_g, counts_g = _prefill_counted(fused_model, params, grouped, batch)
    want = no_launches(grouped_lora_chunk=n_proj, grouped_lora_chunk_bf16=n_bf16,
                       grouped_lora_chunk_wgmma=n_bf16, **seq)
    if counts_g != want:
        raise AssertionError(f"{arch} grouped prefill: launches {counts_g}, expected {want}")
    with torch.no_grad():
        halves = layerwise_grouped(fused_model, einsum_model, params, grouped, loras, batch)
        dev_g, _ = device_time(lambda: fused_model.prefill(params, grouped, batch))
    out["grouped"] = {"wall_s": wall_g, "device_s": dev_g, "launches": counts_g,
                      "per_layer_per_tenant": halves, "tolerance": LM_TOL}
    print(f"[lm:{arch}] prefill 2-tenant grouped LoRA vs each tenant's einsum "
          f"{json.dumps(out['grouped'])}", flush=True)
    if hybrid:
        halves = [hd["x_vs_fp32"] for hd in halves["vs_fp32"]]
    if not max(halves) <= LM_TOL:
        raise AssertionError(f"{arch}: the grouped prefill and the tenants' einsum prefills "
                             f"disagree layer by layer: {halves}")
    return out


def _rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def _leaf_names(tree, prefix: str = "") -> list:
    """The key path of each leaf, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _leaf_names(v, f"{prefix}/{k}")]
    return [prefix.lstrip("/")]


def layerwise_grads(model_f, model_e, model_32, params, lora, batch) -> tuple:
    """Each layer's adapter gradients from shared inputs: the einsum run's
    input to the layer (detached) and the gradient of the einsum run's loss
    at the layer's output, through the fused and the einsum bf16 layer and
    the fp32 layer (the same bf16-valued weights and inputs, upcast).
    Returns, per layer, the worst relative 2-norm error of each bf16 path
    against fp32 over its held leaves (those where the einsum path is within
    LM_GRAD_TOL of fp32) and over all its leaves; the held leaves where the
    fused path is beyond LM_GRAD_TOL; the ill-conditioned leaves left out,
    with both readings; the layers with no held leaf; and the kernel
    launches of the per-layer runs."""
    cfg = model_e.cfg
    # a leaf that asks for a gradient, so every layer's output has one
    x = model_e.embed(params, batch).detach().requires_grad_(True)
    ctx = model_e.make_ctx(x.shape[1], x.device)
    lora_layers = lora["layers"]
    names = _leaf_names(lora_layers)
    ins, outs = [], []
    for i in range(cfg.n_layers):
        ins.append(x.detach())
        x, _ = model_e.block["train"](cfg, _layer(params["layers"], i),
                                      _layer(lora_layers, i), x, ctx)
        x.retain_grad()
        outs.append(x)
    softmax_xent(model_e.unembed(params, x), batch["targets"]).backward()
    params32 = tree_map(lambda t: t.float(), params)
    worst = {"held_fused_vs_fp32": [], "held_einsum_vs_fp32": [], "held_leaves": [],
             "fused_vs_fp32": [], "einsum_vs_fp32": [], "fused_vs_einsum": []}
    off, left_out, no_held = [], [], []
    reset_counts()                                      # just before the layer runs
    for i in range(cfg.n_layers):
        grads = {}
        for label, m, p, dt in (("fused", model_f, params, None),
                                ("einsum", model_e, params, None),
                                ("fp32", model_32, params32, torch.float32)):
            lo = tree_map(lambda t: t[i].detach().clone().requires_grad_(True), lora_layers)
            xin, gout = ins[i], outs[i].grad
            if dt is not None:
                xin, gout = xin.to(dt), gout.to(dt)
            y, _ = m.block["train"](m.cfg, _layer(p["layers"], i), lo, xin, ctx)
            grads[label] = torch.autograd.grad(y, tree_leaves(lo), gout)
        ef = [_rel(g, t) for g, t in zip(grads["fused"], grads["fp32"])]
        ee = [_rel(g, t) for g, t in zip(grads["einsum"], grads["fp32"])]
        held = [j for j, e in enumerate(ee) if e <= LM_GRAD_TOL]
        worst["held_fused_vs_fp32"].append(max((ef[j] for j in held), default=None))
        worst["held_einsum_vs_fp32"].append(max((ee[j] for j in held), default=None))
        worst["held_leaves"].append(f"{len(held)}/{len(ee)}")
        worst["fused_vs_fp32"].append(max(ef))
        worst["einsum_vs_fp32"].append(max(ee))
        worst["fused_vs_einsum"].append(max(_rel(g, t) for g, t in zip(grads["fused"],
                                                                       grads["einsum"])))
        off += [{"layer": i, "leaf": names[j], "fused": ef[j], "einsum": ee[j]}
                for j in held if not ef[j] <= LM_GRAD_TOL]
        left_out += [{"layer": i, "leaf": names[j], "fused": ef[j], "einsum": ee[j]}
                     for j in range(len(ee)) if j not in held]
        if not held:
            no_held.append(i)
    torch.cuda.synchronize()
    return worst, off, left_out, no_held, read_counts()  # just after


def lm_backward(arch: str, seed: int) -> dict:
    """The gradient of a token cross-entropy with respect to the adapters,
    through an LM at full width and LM_GRAD_LAYERS layers in bf16 under
    attn_impl / wkv_impl="chunked" (under grad the plain chunked forms run,
    no flash or WKV6 launch), fused LoRA (the bf16 lora_matmul kernel
    forward and, on the backward's views, for dx) against einsum: end to
    end (the loss held; the gradients held where LM_GRAD_E2E_TOL names the
    model, else printed) and layer by layer (the held leaves)."""
    base = REGISTRY[arch].with_(n_layers=LM_GRAD_LAYERS, attn_impl="chunked",
                                wkv_impl="chunked")
    fused_cfg = base.with_(lora=dataclasses.replace(base.lora, impl="fused"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = build_model(base)
    params = model.init_params(gen)
    lora = lm_adapters(model, gen)["client-a"]
    rs = np.random.default_rng(seed)
    batch = {key: torch.from_numpy(rs.integers(0, base.vocab_size,
                                               (LM_GRAD_BATCH, LM_GRAD_SEQ))
                                   .astype(np.int32)).cuda() for key in ("tokens", "targets")}
    n_proj = lora_projections(lora)
    per_layer = n_proj // base.n_layers
    frozen = FROZEN_INPUT[base.family]["client"]
    models = {"fused": build_model(fused_cfg), "einsum": model}
    res = {}
    for label, m in models.items():
        lo = tree_map(lambda t: t.detach().clone().requires_grad_(True), lora)
        torch.cuda.synchronize()
        reset_counts()                                  # just before the path runs
        t0 = time.perf_counter()
        loss = m.loss(params, lo, batch)[0]
        grads = torch.autograd.grad(loss, tree_leaves(lo))
        torch.cuda.synchronize()
        res[label] = {"loss": float(loss.detach()), "grads": grads,
                      "wall_s": time.perf_counter() - t0, "launches": read_counts()}
    held, off, left_out, no_held, layer_launches = layerwise_grads(
        models["fused"], model, build_model(base.with_(dtype="float32")), params, lora, batch)
    # end to end: every projection forward, dx for all but layer 0's
    # frozen-input ones; per layer (a detached input each): the same less
    # the frozen-input ones of every layer; every one on the wgmma tile
    n_e2e, n_layer = 2 * n_proj - frozen, base.n_layers * (2 * per_layer - frozen)
    want = {"fused": no_launches(lora_matmul=n_e2e, lora_matmul_bf16=n_e2e,
                                 lora_matmul_wgmma=n_e2e),
            "einsum": no_launches(),
            "per_layer": no_launches(lora_matmul=n_layer, lora_matmul_bf16=n_layer,
                                     lora_matmul_wgmma=n_layer)}
    f, e = res["fused"], res["einsum"]
    free = [_rel(gf, ge) for gf, ge in zip(f["grads"], e["grads"])]
    out = {"arch": arch, "layers": LM_GRAD_LAYERS, "batch": [LM_GRAD_BATCH, LM_GRAD_SEQ],
           "loss": {"fused": f["loss"], "einsum": e["loss"]},
           "loss_rel": abs(f["loss"] - e["loss"]) / abs(e["loss"]),
           "free_running_grad_err": {"max": max(free), "median": sorted(free)[len(free) // 2]},
           "per_layer_grad_err": held, "per_layer_off": off,
           "per_layer_ill_conditioned": left_out, "per_layer_none_held": no_held,
           "finite": all(bool(torch.isfinite(g).all()) for g in f["grads"]),
           "wall_s": {"fused": f["wall_s"], "einsum": e["wall_s"]},
           "launches": {"fused": f["launches"], "einsum": e["launches"],
                        "per_layer": layer_launches},
           "tolerance": {"loss_rel": LM_GRAD_LOSS_RTOL,
                         "per_layer_held_fused_vs_fp32": LM_GRAD_TOL,
                         "end_to_end": LM_GRAD_E2E_TOL.get(arch)}}
    print(f"[lm-grad:{arch}] {json.dumps(out)}", flush=True)
    for label, got in out["launches"].items():
        if got != want[label]:
            raise AssertionError(f"{arch} backward {label}: launches {got}, "
                                 f"expected {want[label]}")
    e2e_ok = arch not in LM_GRAD_E2E_TOL or max(free) <= LM_GRAD_E2E_TOL[arch]
    if not (out["finite"] and out["loss_rel"] <= LM_GRAD_LOSS_RTOL and e2e_ok) \
            or off or no_held:
        raise AssertionError(f"{arch}: the fused and einsum LM backward disagree: {out}")
    del model, models, params, lora, res, f, e
    gc.collect()
    torch.cuda.empty_cache()
    return out


class _GradsOnly:
    """An optimizer whose update hands back the gradients as the new
    parameters: a server step built on it returns its adapter and head
    gradients, before any AdamW step."""

    def update(self, grads, state, params):
        return grads, state


def _flat(tree) -> torch.Tensor:
    return torch.cat([leaf.reshape(-1).float() for leaf in tree_leaves(tree)])


def cohort_step_gap(train, test) -> dict:
    """Where the cohort path's fused-against-einsum loss gap starts, in
    round 1 at full width.  First the clients: each client's activations
    from a fused and an einsum model on the same batch, and the int8 codes
    the uplink would send for each (``quantize``, without the error
    feedback, which starts at zero).  Then one cut-grouped ragged server
    step over the six clients, run by a fused and an einsum model on
    identical inputs (the state before round 1, the einsum clients'
    activations and batches; the step takes v directly, so the int8 links
    play no part).  Compared: the per-client losses, ``dv`` and the adapter
    and head gradients before the optimizer, then the adapters after
    AdamW's first step, where an element whose gradient is near zero can
    move by about lr either way (a flip)."""
    from repro_torch.comm import quantize
    from repro_torch.core.splitfl import make_client_step, make_server_step_cls_batched

    sim = Simulator(REGISTRY["bert-base"], PAPER_CLIENTS, PAPER_CUTS, train, test,
                    path_run(True, False), device="cuda")
    fused_cfg = sim.cfg.with_(lora=dataclasses.replace(sim.cfg.lora, impl="fused"))
    models = {"fused": build_model(fused_cfg), "einsum": sim.model}
    grp = list(range(sim.u))
    batches, acts, client = [], [], {"v_err": 0.0, "int8_codes_differing": 0,
                                     "int8_codes": 0, "int8_scales_differing": 0}
    with torch.no_grad():
        for u in grp:
            batches.append(sim._batch(u))
            v = {label: make_client_step(m, sim.opt, sim.cuts[u])[0](
                sim.client_params[u], sim.client_lora[u], batches[u])[0]
                for label, m in models.items()}
            acts.append(v["einsum"])
            qf, qe = quantize(v["fused"]), quantize(v["einsum"])
            client["v_err"] = max(client["v_err"], norm_err(v["fused"], v["einsum"]))
            client["int8_codes_differing"] += int((qf.q != qe.q).sum())
            client["int8_codes"] += qf.q.numel()
            client["int8_scales_differing"] += int((qf.scale != qe.scale).sum())
    args = (sim.params, lora_lib.stack_trees([sim.server_lora[u] for u in grp]),
            torch.stack([sim.heads[u] for u in grp]),
            lora_lib.stack_trees([sim.server_opt[u] for u in grp]), torch.stack(acts),
            lora_lib.stack_trees(batches), [sim.cuts[u] for u in grp])
    res, launches = {}, {}
    for label, model in models.items():
        reset_counts()
        grads = make_server_step_cls_batched(model, _GradsOnly(), impl="ragged")(*args)
        adam = make_server_step_cls_batched(model, sim.opt, impl="ragged")(*args)
        torch.cuda.synchronize()
        launches[label] = read_counts()["grouped_lora_chunk"]
        res[label] = {"loss": grads[0].double(), "dv": grads[4], "lora_grad": _flat(grads[1]),
                      "head_grad": grads[2], "lora_new": _flat(adam[1])}
    f, e = res["fused"], res["einsum"]
    diff = (f["lora_new"] - e["lora_new"]).abs()
    out = {"loss_rel": float(((f["loss"] - e["loss"]).abs() / e["loss"].abs()).max()),
           "dv_err": norm_err(f["dv"], e["dv"]),
           "lora_grad_err": norm_err(f["lora_grad"], e["lora_grad"]),
           "head_grad_err": norm_err(f["head_grad"], e["head_grad"]),
           "adam_max_abs_diff": float(diff.max()), "lr": LR,
           "adam_flips": int((diff > 0.5 * LR).sum()), "adapter_elements": diff.numel(),
           "grouped_launches": launches, "client": client}
    if launches["fused"] == 0 or launches["einsum"] != 0:
        raise AssertionError(f"cohort step: grouped-kernel launches {launches}")
    print(f"[cohort-step] {json.dumps(out)}", flush=True)
    return out


def cohort_round_gaps(train, test) -> dict:
    """The cohort path's per-round mean loss, fused against einsum, with the
    int8 links on (the path as it runs) and off on both sides: whether the
    gap comes through the uplink quantizer (ROADMAP Queue C.1)."""
    out = {}
    for quantize in (True, False):
        losses = {}
        for fused in (True, False):
            sim = Simulator(REGISTRY["bert-base"], PAPER_CLIENTS, PAPER_CUTS, train, test,
                            path_run(True, fused, quantize=quantize), device="cuda")
            losses["fused" if fused else "einsum"] = [sim.run_round(r).mean_loss
                                                      for r in range(ROUNDS)]
            del sim
        out["int8" if quantize else "fp32_links"] = {
            **losses, "gap": [abs(f - e) for f, e in zip(losses["fused"], losses["einsum"])]}
    print(f"[cohort-gap] {json.dumps(out)}", flush=True)
    return out


def lm_prefill_time(arch: str, cfg_kw: dict, kernel: str, seed: int,
                    fused: bool = False) -> dict:
    """One prefill of 4 x 2048 tokens through a model's kernel: wall s
    after one unmeasured prefill; device s and the kernel's share under the
    profiler.  ``fused``: with LoRAConfig(impl="fused") (the bf16 LoRA
    kernel in every adapted projection)."""
    dev = torch.device("cuda")
    cfg = REGISTRY[arch].with_(**cfg_kw)
    if fused:
        cfg = cfg.with_(lora=dataclasses.replace(cfg.lora, impl="fused"))
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(gen)
    lora = lm_adapters(model, gen)["client-a"]
    rs = np.random.default_rng(seed)
    tokens = torch.from_numpy(rs.integers(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))
                              .astype(np.int32)).to(dev)
    with torch.no_grad():
        model.prefill(params, lora, {"tokens": tokens})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, lora, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dev_s, _, hit = device_time(lambda: model.prefill(params, lora, {"tokens": tokens}),
                                    find=kernel)
    del model, params, lora
    gc.collect()
    torch.cuda.empty_cache()
    return {"wall_s": wall, "device_s": dev_s, kernel: hit,
            "share": hit["device_ms"] / 1e3 / dev_s}


def ab_measure() -> dict:
    """What ``--ab`` compares, on the port this process imported: the
    kernels at their paths' shapes (ms a call by CUDA events, device ms a
    launch by the profiler); one warm fused main round and one
    warm cohort round under the profiler (``profile_round``); the cohort
    server step fused against einsum (``cohort_step_gap``); the cohort
    path's round losses fused against einsum with the int8 links on and
    off (``cohort_round_gaps``); and one
    gemma-2b and one rwkv6-3b prefill of 4 x 2048 tokens through their
    kernels (``lm_prefill_time``), the rwkv6-3b one also with fused bf16
    LoRA."""
    dev = torch.device("cuda")
    rs = np.random.default_rng(0)

    def t(*shape, std=1.0):
        return torch.from_numpy((rs.standard_normal(shape) * std)
                                .astype(np.float32)).to(dev)

    x, w, a, b = t(2048, 768), t(768, 768, std=768 ** -0.5), t(16, 768, std=0.25), \
        t(768, 16, std=0.1)
    xg = t(4096, 768)
    ag, bg = t(2, 16, 768, std=0.25), t(2, 768, 16, std=0.1)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(4, 2048, 8, 256, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(4, 2048, 1, 256, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    wr, wk, wv = ((torch.randn(4, 2048, 40, 64, generator=gen, device=dev) * 0.3).bfloat16()
                  for _ in range(3))
    ww = torch.exp(-torch.exp(torch.randn(4, 2048, 40, 64, generator=gen, device=dev) - 3.0))
    wu = torch.randn(40, 64, generator=gen, device=dev) * 0.5
    # bf16 at gemma-2b's q-projection, alone and over two tenants' groups;
    # the int8 link quantizer at the cohort path's shape
    xq, wq, aq, bq = (v.bfloat16() for v in (t(8192, 2048), t(2048, 2048, std=2048 ** -0.5),
                                             t(16, 2048, std=0.25), t(2048, 16, std=0.1)))
    aqg, bqg = torch.stack([aq, aq]), torch.stack([bq, bq])
    xr = t(2048, 768)
    # direct mode at its timed shapes (K 128): fp32 over the cohort's two
    # groups of 2048 rows, bf16 over two tenants' groups of 4096
    xd = t(4096, 128)
    wd, ad, bd = t(128, 768, std=128 ** -0.5), t(2, 16, 128, std=0.25), t(2, 768, 16, std=0.1)
    xdb, wdb, adb, bdb = (v.bfloat16() for v in (
        t(8192, 128), t(128, 2048, std=128 ** -0.5), t(2, 16, 128, std=0.25),
        t(2, 2048, 16, std=0.1)))
    extra = []
    if resident_loads is not None:
        # bf16 quantize: a parent whose kernel takes f32 alone raises on it
        xrb = xr.bfloat16()
        extra.append(("quantize_rows_bf16", lambda: quantize_rows(xrb), "quant", 20))
    out = {"root": str(PORT_ROOT)}
    for name, fn, kernel, iters in (
            ("lora_matmul", lambda: lora_matmul(x, w, a, b, scale=2.0),
             "lora_matmul_kernel", 20),
            # the parent's bf16 kernel and this tree's are both named lora_matmul_*
            ("lora_matmul_bf16", lambda: lora_matmul(xq, wq, aq, bq, scale=2.0),
             "lora_matmul_", 20),
            ("grouped_lora_chunk_bf16",
             lambda: grouped_lora(xq, wq, aqg, bqg, group_sizes=(4096, 4096),
                                  scales=(2.0, 2.0), mode="chunk"), "grouped_lora_", 20),
            ("quantize_rows", lambda: quantize_rows(xr), "quant", 20),
            ("grouped_lora_chunk",
             lambda: grouped_lora(xg, w, ag, bg, group_sizes=(2048, 2048), scales=(2.0, 2.0),
                                  mode="chunk"), "grouped_lora_kernel", 20),
            ("flash_attention", lambda: flash_attention(q, k, v, causal=True), "flash", 10),
            ("wkv6", lambda: wkv6(wr, wk, wv, ww, wu), "wkv6_kernel", 10),
            ("grouped_lora_direct",
             lambda: grouped_lora(xd, wd, ad, bd, group_sizes=(2048, 2048), scales=(2.0, 2.0),
                                  mode="direct"), "grouped_lora_", 20),
            ("grouped_lora_direct_bf16",
             lambda: grouped_lora(xdb, wdb, adb, bdb, group_sizes=(4096, 4096),
                                  scales=(2.0, 2.0), mode="direct"), "grouped_lora_", 20),
            *extra):
        out[name] = {"ms": cuda_ms(fn, iters=2 * iters),
                     "device_ms": device_ms(fn, kernel, iters=iters)}
    del x, w, a, b, xg, ag, bg, q, k, v, wr, wk, wv, ww, wu, xq, wq, aq, bq, aqg, bqg, xr
    del xd, wd, ad, bd, xdb, wdb, adb, bdb, extra

    train = make_emotion_dataset(N_TRAIN, seq_len=SEQ, vocab_size=30_522, seed=0)
    test = make_emotion_dataset(N_TEST, seq_len=SEQ, vocab_size=30_522, seed=1)
    for label, cohort in (("main_round", False), ("cohort_round", True)):
        prof = profile_round(True, train, test, cohort=cohort)
        out[label] = {key: prof[key] for key in ("wall_s", "device_s", "busy_share",
                                                 "lora_matmul_kernel", "grouped_lora",
                                                 "direct_copy")}
    out["cohort_step"] = cohort_step_gap(train, test)
    out["cohort_round_gaps"] = cohort_round_gaps(train, test)
    del train, test
    gc.collect()
    torch.cuda.empty_cache()

    out["gemma_prefill"] = lm_prefill_time("gemma-2b", {"attn_impl": "chunked"}, "flash", 13)
    out["rwkv6_prefill"] = lm_prefill_time("rwkv6-3b", {"wkv_impl": "chunked"}, "wkv6", 14)
    out["rwkv6_prefill_fused"] = lm_prefill_time("rwkv6-3b", {"wkv_impl": "chunked"},
                                                 "lora_matmul", 14, fused=True)
    return out


# ---------------------------------------------------------------------------
# [event] phase: the federation clock on the main path
# ---------------------------------------------------------------------------

def event_run(policy: str, fused: bool, trace_dir=None) -> FedRunConfig:
    """``policy="sync"``: the main path under the event clock (barrier
    waves, sync FedAvg every 2 rounds).  Otherwise the reference example's
    event setting: async ``buffered`` or ``staleness`` commits with two
    local rounds in flight, Gilbert-Elliott links on one shared cell with
    plane-routed adapter syncs, int8 links, clock-formed ragged chunks of up
    to EVENT_CHUNK clients, and every obs sink on."""
    if policy == "sync":
        return FedRunConfig(rounds=ROUNDS, batch_size=BATCH, seq_len=SEQ, lr=LR, seed=0,
                            engine=EngineConfig(mode="event", fused_lora=fused),
                            agg=AggConfig(policy="sync", interval=2))
    return FedRunConfig(
        rounds=ROUNDS, batch_size=BATCH, seq_len=SEQ, lr=LR, seed=0,
        engine=EngineConfig(mode="event", fused_lora=fused, cohort_chunk=EVENT_CHUNK,
                            cohort_impl="ragged"),
        agg=AggConfig(policy=policy, interval=1, max_inflight=2, transport="plane"),
        net=NetConfig(link_model="gilbert", shared=True,
                      capacity_mbps=EVENT_CAPACITY_MBPS, quantize=True),
        obs=ObsConfig(trace=True, metrics=True, memory_ledger=True, trace_dir=trace_dir))


def launch_rule(cfg, serves, serve_cuts, n_evals: int, n_eval_batches: int,
                impl: str = "ragged") -> dict:
    """Kernel launches of a whole event-engine run, from the clock's served
    ``ServeEvent``s (or a population round's ``ServiceRecord``s) at the cuts
    in force at each (``serve_cuts``) and the
    evaluations.  With T adapted projections per layer and L layers, each
    client u of a serve event runs its forward and backward at its cut:
    2*T*cut_u - 3 ``lora_matmul`` (no dx into the frozen embedding) and,
    under int8 links, 2 ``quantize_rows`` (uplink activations, downlink
    gradient).  The server side of an event of one client is the sequential
    step, 2*T*(L - cut) ``lora_matmul`` (forward and dx); of a chunk, the
    ragged step, one ``grouped_lora`` chunk-mode launch forward and one for
    dx per projection of each distinct cut's layers, 2*T*(L - cut) per
    distinct cut, or the vmap step (``impl="vmap"``), one launch forward and
    one for dx per projection of every layer, 2*T*L a chunk whatever the
    cuts.  Each evaluation runs T*L ``lora_matmul`` per test batch,
    whatever the cuts."""
    t, nl = len(cfg.lora.targets), cfg.n_layers
    lm = gl = q = 0
    for ev, cuts in zip(serves, serve_cuts):
        lm += sum(2 * t * cuts[u] - 3 for u in ev.uids)
        if len(ev.uids) == 1:
            lm += 2 * t * (nl - cuts[ev.uids[0]])
        elif impl == "vmap":
            gl += 2 * t * nl
        else:
            gl += sum(2 * t * (nl - c) for c in {cuts[u] for u in ev.uids})
        q += 2 * len(ev.uids)
    lm += n_evals * n_eval_batches * t * nl
    return {"lora_matmul": lm, "grouped_lora_chunk": gl, "quantize_rows": q}


def expected_event_launches(cfg, cuts, serves, n_evals: int, n_eval_batches: int,
                            fused: bool, quantized: bool, serve_cuts=None) -> dict:
    """Launches of a whole event-engine run by ``launch_rule`` (derivation
    in its docstring), from the clock's served ``ServeEvent``s at ``cuts``
    throughout the run, or at ``serve_cuts``, the cuts in force at each
    serve event where a control plane moves them between commits.  The
    einsum run launches neither LoRA kernel; ``quantize_rows`` runs under
    int8 links, fused or not."""
    if serve_cuts is None:
        serve_cuts = [cuts] * len(serves)
    n = launch_rule(cfg, serves, serve_cuts, n_evals, n_eval_batches)
    return no_launches(lora_matmul=n["lora_matmul"] if fused else 0,
                       grouped_lora_chunk=n["grouped_lora_chunk"] if fused else 0,
                       quantize_rows=n["quantize_rows"] if quantized else 0)


def time_simulator_work(sim) -> dict:
    """Host seconds the run spends in the Simulator's work (each serve
    event's math, the commits' aggregation, the evaluations, the trace
    export), counted at the outermost call: the rest of the run's wall time
    is the clock's (its event loop, the network plane's integrators, the
    obs recorders) and the Simulator's bookkeeping around the callbacks.  The
    wrapped methods are instance attributes, which the clock's callbacks
    look up at each call."""
    acc = {"s": 0.0, "depth": 0}

    def timed(fn):
        def call(*args, **kwargs):
            acc["depth"] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc["depth"] -= 1
                if acc["depth"] == 0:
                    acc["s"] += time.perf_counter() - t0
        return call

    for name in ("_serve_group", "_commit_sync", "_commit_async", "evaluate", "write_trace"):
        setattr(sim, name, timed(getattr(sim, name)))
    return acc


def run_event(policy: str, fused: bool, train, test, trace_dir=None) -> dict:
    """One event-engine run at the main path's full width, every counter
    set to 0 just before ``run_training`` and read just after."""
    cfg = REGISTRY["bert-base"]
    label = f"event:{policy}:" + ("fused" if fused else "einsum")
    t0 = time.perf_counter()
    sim = Simulator(cfg, PAPER_CLIENTS, PAPER_CUTS, train, test,
                    event_run(policy, fused, trace_dir), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    work = time_simulator_work(sim)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                      # just before the path runs
    t0 = time.perf_counter()
    sim.run_training()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()              # just after
    res = sim.clock_result
    n_evals = sum(r.accuracy is not None for r in sim.history)
    n_eval = min(32, len(test) // BATCH)
    serves = list(res.serves)
    expected = expected_event_launches(sim.cfg, sim.cuts, serves, n_evals, n_eval, fused,
                                       sim.run.net.quantize)
    out = {"label": label, "history": [dataclasses.astuple(r) for r in sim.history],
           "loss_events": sim.loss_events, "discarded": sim.discarded_updates,
           "chunk_sizes": [len(ev.uids) for ev in serves], "commits": len(res.commits),
           "clock_events": len(res.events), "launches": counts, "expected": expected,
           "n_evals": n_evals, "setup_s": setup_s, "wall_s": wall_s,
           "clock_host_s": wall_s - work["s"],
           "events_per_clock_host_s": len(res.events) / (wall_s - work["s"]),
           "launches_per_serve": {k: v / len(serves) for k, v in counts.items() if v},
           "max_mem_bytes": torch.cuda.max_memory_allocated(), "sim": sim}
    for rec in sim.history:
        print(f"[{label}] record {rec.round} loss={rec.mean_loss:.7f} "
              f"sim_time_s={rec.sim_time_s!r} accuracy={rec.accuracy}", flush=True)
    print(f"[{label}] setup_s={setup_s:.3f} wall_s={wall_s:.3f} "
          f"clock_host_s={out['clock_host_s']:.4f} serves={len(serves)} "
          f"chunk_sizes={out['chunk_sizes']} commits={out['commits']} "
          f"clock_events={out['clock_events']} events_per_clock_host_s="
          f"{out['events_per_clock_host_s']:.1f} discarded={sim.discarded_updates} "
          f"launches={json.dumps(counts)} expected={json.dumps(expected)} "
          f"launches_per_serve={json.dumps(out['launches_per_serve'])} "
          f"max_mem_bytes={out['max_mem_bytes']}", flush=True)
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts}, expected {expected}")
    # every served client's loss is finite (a record's mean is nan only
    # where no serve fell between two async commits)
    if not sim.loss_events or not all(math.isfinite(e[3]) for e in sim.loss_events):
        raise AssertionError(f"{label}: loss events {sim.loss_events}")
    acc = sim.history[-1].accuracy
    if acc is None or not 0.0 <= acc <= 1.0:
        raise AssertionError(f"{label}: evaluation gave accuracy {acc}")
    return out


def final_state(sim) -> dict:
    """What a killed and resumed run must reproduce bit for bit: the
    clock's state_dict JSON, the run log (history, loss events, discards),
    the control decisions and cuts, the obs outputs (Chrome trace, metrics,
    ledger) and copies of the final global adapters and head."""
    out = {"clock": json.dumps(sim._clock.state_dict(), sort_keys=True),
           "history": json.dumps([dataclasses.astuple(r) for r in sim.history]),
           "loss_events": list(sim.loss_events), "discarded": list(sim.discarded_updates),
           "decisions": [dataclasses.asdict(d) for d in sim.control_events],
           "cuts": list(sim.cuts),
           "global_full": tree_map(torch.clone, sim._global_full),
           "global_head": tree_map(torch.clone, sim._global_head)}
    if sim.obs is not None:
        out["obs"] = [json.dumps(sim.obs.tracer.to_chrome(), sort_keys=True),
                      sim.obs.metrics.to_json(),
                      json.dumps(sim.obs.ledger.report(), sort_keys=True)]
    return out


def check_event_sync(event: dict, analytic: dict) -> dict:
    """The event-driven sync run against the analytic run of the same
    config.  The clock serves each barrier wave by the online form of the
    scheduler (Alg. 2's priority among the clients whose activations have
    arrived), which may differ from the analytic engine's fixed Alg. 2
    order: so each round's simulated time is held (EVENT_TIME_RTOL) against
    the analytic engine's closed form over the order the clock served
    (``cost_model.makespan`` plus the nominal aggregation charge), and the
    analytic run's own times are printed beside it.  Losses are held
    against the analytic run (EVENT_LOSS_RTOL): each client's math is the
    same whatever the order."""
    sim = event["sim"]
    times = sim._adjusted_times()
    commit = 2 * max(sim.link.transfer_s(lora_upload_bytes(sim.cfg, c)) for c in sim.cuts)
    clock, out = 0.0, {"rounds": []}
    for rnd, (res, rec, arow) in enumerate(zip(sim.clock_result.round_results, sim.history,
                                               analytic["rows"])):
        span, _, _ = makespan(times, res.order)
        clock += span + (commit if (rnd + 1) % sim.run.agg.interval == 0 else 0.0)
        t_gap = abs(rec.sim_time_s - clock) / clock
        loss_gap = abs(rec.mean_loss - arow["loss"]) / abs(arow["loss"])
        row = {"round": rnd, "event_order": res.order, "sim_time_s": rec.sim_time_s,
               "closed_form_s": clock, "time_rel_gap": t_gap,
               "analytic_sim_time_s": arow["sim_time_s"], "loss": rec.mean_loss,
               "analytic_loss": arow["loss"], "loss_rel_gap": loss_gap}
        out["rounds"].append(row)
        print(f"[event:sync] {json.dumps(row)}", flush=True)
        if not t_gap <= EVENT_TIME_RTOL:
            raise AssertionError(f"event sync round {rnd}: {rec.sim_time_s} s against the "
                                 f"closed form's {clock} s")
        if not loss_gap <= EVENT_LOSS_RTOL:
            raise AssertionError(f"event sync round {rnd}: loss {rec.mean_loss} against the "
                                 f"analytic run's {arow['loss']}")
    if len(sim.history) != len(analytic["rows"]):
        raise AssertionError("event sync and analytic runs recorded different rounds")
    out["max_loss_rel_gap"] = max(r["loss_rel_gap"] for r in out["rounds"])
    return out


def check_event_async(fused: dict, plain: dict) -> dict:
    """The async fused run against the einsum run of the same config: the
    simulated timeline is the clock's and does not depend on the kernels,
    so loss events (time, uid, round), discards and every record's time are
    equal exactly; per-commit losses within LOSS_RTOL (the cohort path's
    limit, which allows for the int8 quantizer's whole-code steps)."""
    keys = lambda run: [e[:3] for e in run["loss_events"]]  # noqa: E731
    if keys(fused) != keys(plain):
        raise AssertionError("async fused and einsum runs differ in their loss events")
    if fused["discarded"] != plain["discarded"]:
        raise AssertionError("async fused and einsum runs discarded different updates")
    if [h[1] for h in fused["history"]] != [h[1] for h in plain["history"]]:
        raise AssertionError("async fused and einsum runs differ in simulated times")
    gaps = []
    for f, p in zip(fused["history"], plain["history"]):
        if math.isnan(p[2]) or math.isnan(f[2]):
            if not (math.isnan(p[2]) and math.isnan(f[2])):
                raise AssertionError(f"commit {f[0]}: loss {f[2]} against {p[2]}")
            continue
        gaps.append(abs(f[2] - p[2]) / abs(p[2]))
        if not gaps[-1] <= LOSS_RTOL:
            raise AssertionError(f"async commit {f[0]}: fused loss {f[2]} against "
                                 f"einsum {p[2]} (rtol {LOSS_RTOL})")
    out = {"commits": len(fused["history"]), "max_loss_rel_gap": max(gaps),
           "loss_events": len(fused["loss_events"]), "discarded": fused["discarded"]}
    print(f"[event:async] fused vs einsum {json.dumps(out)}", flush=True)
    return out


def trace_summary(run: dict) -> dict:
    """The written Chrome trace, loaded with json: spans by track kind, the
    metrics counters, and the memory ledger's modelled peaks beside the
    run's measured peak device memory."""
    from repro_torch.obs import TRACK_PIDS

    sim = run["sim"]
    path = Path(sim.run.obs.trace_dir) / "trace.json"
    with open(path) as fh:
        doc = json.load(fh)
    kind_of = {pid: kind for kind, pid in TRACK_PIDS.items()}
    spans = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X":
            kind = kind_of.get(ev["pid"], str(ev["pid"]))
            spans[kind] = spans.get(kind, 0) + 1
    report = doc["otherData"]["memory"]
    counters = doc["otherData"]["metrics"]["counters"]
    out = {"trace_bytes": path.stat().st_size, "spans_by_track": spans,
           "counters": counters, "stale_discard": counters.get("stale_discard", 0.0),
           "modelled_worst_client_peak_bytes": report["worst_client_peak_bytes"],
           "modelled_server_peak_bytes": report["server_peak_bytes"],
           "modelled_fleet_peak_bytes": report["fleet_peak_bytes"],
           "measured_max_mem_bytes": run["max_mem_bytes"]}
    print(f"[event:trace] {run['label']} {json.dumps(out)}", flush=True)
    if not spans or out["stale_discard"] != len(run["discarded"]):
        raise AssertionError(f"{run['label']}: trace {spans}, stale_discard "
                             f"{out['stale_discard']} against {len(run['discarded'])}")
    return out


def event_launches(event: dict, name: str) -> dict:
    """A kernel's launches in each run of the event phase."""
    return {key: run["launches"][name] for key, run in event.items() if "launches" in run}


def event_phase(fused_main: dict, train, test, finals: dict) -> dict:
    """[event]: the event-driven sync run (fused) against the analytic
    main run; the paper example's async event setting, buffered fused and
    einsum and staleness fused, with the obs plane on; at least one local
    update must lose its race to a commit.  The buffered fused run's
    ``final_state`` goes into ``finals`` for the [resume] phase."""
    sync = run_event("sync", True, train, test)
    sync_check = check_event_sync(sync, fused_main)
    # each run's peak memory is read from a clean card (the simulator and
    # its clock refer to each other, so only the collector frees them)
    del sync["sim"]
    gc.collect()
    if sync["launches"]["lora_matmul"] != fused_main["launches"]["lora_matmul"]:
        raise AssertionError("event sync and analytic runs launched lora_matmul "
                             f"{sync['launches']['lora_matmul']} and "
                             f"{fused_main['launches']['lora_matmul']} times")
    # wall time, analytic against event, in turns on a warm card (the main
    # run above was the process's first full-width run)
    walls = {"analytic": [fused_main["wall_s"]], "event": [sync["wall_s"]]}
    for _ in range(2):
        walls["analytic"].append(run_path(True, train, test, tag=":repeat")["wall_s"])
        walls["event"].append(run_event("sync", True, train, test)["wall_s"])
        gc.collect()
    print(f"[event:sync] wall_s {json.dumps(walls)} (analytic: the first is the "
          f"process's first full-width run)", flush=True)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for policy, fused in (("buffered", True), ("buffered", False), ("staleness", True)):
            key = f"{policy}:{'fused' if fused else 'einsum'}"
            runs[key] = run_event(policy, fused, train, test, trace_dir=f"{tmp}/{key}")
            runs[key]["trace"] = trace_summary(runs[key])
            if key == "buffered:fused":
                finals["event:buffered"] = final_state(runs[key]["sim"])
            del runs[key]["sim"]
            gc.collect()
    async_check = check_event_async(runs["buffered:fused"], runs["buffered:einsum"])
    if not any(run["discarded"] for run in runs.values()):
        raise AssertionError("no async run discarded a local update")
    keep = ("history", "discarded", "chunk_sizes", "commits", "clock_events", "launches",
            "n_evals", "setup_s", "wall_s", "clock_host_s", "events_per_clock_host_s",
            "launches_per_serve", "max_mem_bytes", "trace")
    out = {"sync": {"check": sync_check, "walls": walls,
                    **{k: sync[k] for k in keep if k in sync}},
           "async": async_check,
           **{key: {k: run[k] for k in keep if k in run} for key, run in runs.items()}}
    print(f"[event] {json.dumps(out)}", flush=True)
    return out


# [control] phase: the control plane on the cohort path
# ---------------------------------------------------------------------------

# the sync run cuts client 4's memory budget (cut 3) to between its
# footprints at cuts 2 and 3: the memory trigger sheds one layer at the
# first commit, whatever the predicted gain, and round 2 serves the client
# in a chunk with clients 5 and 1, where the launch counts depend on its
# cut (shed to cut 1 it would arrive alone, and a single client's serve
# launches 2*T*L - 3 whatever its cut).  The buffered run fades client 4's
# link from 100 to 4 Mbps at FADE_AT simulated seconds, inside the first
# commit's window; the fade trigger re-plans it at the first commit it
# contributes to.  Client 0, the reference tests' faded client, stands at
# the loop's min_cut 1, from which no fade can move it
SHED_CLIENT, FADE_CLIENT, FADE_AT, CONTROL_HYSTERESIS, CONTROL_CHUNK = 4, 4, 0.3, 0.25, 3


def control_run(kind: str, fused: bool = True, trace_dir=None) -> FedRunConfig:
    """The cohort path under the event clock with a reactive controller:
    ``kind="sync"`` barrier rounds with a commit after each, ``"buffered"``
    async commits of three uploads with one local round in flight and
    plane-routed adapter syncs over caller-supplied links.  Chunks of up to
    CONTROL_CHUNK clients on the ragged step, int8 links, every obs sink on."""
    engine = EngineConfig(mode="event", fused_lora=fused, cohort_chunk=CONTROL_CHUNK,
                          cohort_impl="ragged")
    obs = ObsConfig(trace=True, metrics=True, memory_ledger=True, trace_dir=trace_dir)
    if kind == "sync":
        return FedRunConfig(rounds=ROUNDS, batch_size=BATCH, seq_len=SEQ, lr=LR, seed=0,
                            engine=engine, agg=AggConfig(policy="sync", interval=1),
                            net=NetConfig(quantize=True),
                            control=ControlConfig(policy="reactive"), obs=obs)
    return FedRunConfig(rounds=ROUNDS, batch_size=BATCH, seq_len=SEQ, lr=LR, seed=0,
                        engine=engine,
                        agg=AggConfig(policy="buffered", interval=1, max_inflight=1,
                                      transport="plane"),
                        net=NetConfig(link_model="custom", quantize=True),
                        control=ControlConfig(policy="reactive",
                                              hysteresis=CONTROL_HYSTERESIS),
                        obs=obs)


def control_links() -> list:
    """The buffered run's links: 100 Mbps each, client FADE_CLIENT's fading
    to 4 Mbps at FADE_AT simulated seconds."""
    links = [ConstantLink(100.0)] * len(PAPER_CLIENTS)
    links[FADE_CLIENT] = TraceLink([0.0, FADE_AT], [100.0, 4.0])
    return links


def shed_budget() -> float:
    """A memory budget between the shed client's footprints at cuts 2 and 3."""
    full = REGISTRY["bert-base"]
    return (client_memory(full, 2, BATCH, SEQ) + client_memory(full, 3, BATCH, SEQ)) / 2


def control_simulator(kind: str, cfg, train, test, device: str, fused: bool = True,
                      trace_dir=None, **knobs) -> Simulator:
    """One of the phase's two runs, built and primed (the sync run's
    memory-pressure event), not yet run; ``knobs`` (the snapshot, resume
    and preemption fields of ``FedRunConfig``) go into its config."""
    sim = Simulator(cfg, PAPER_CLIENTS, PAPER_CUTS, train, test,
                    dataclasses.replace(control_run(kind, fused, trace_dir), **knobs),
                    links=None if kind == "sync" else control_links(), device=device)
    if kind == "sync":
        # another app took part of the RAM: negative headroom at the first commit
        sim._control.telemetry.set_mem_budget(SHED_CLIENT, shed_budget())
    return sim


def cuts_at_serves(cuts0, serves, decisions) -> tuple:
    """The cuts in force at each serve event (the initial cuts with every
    applied decision of an earlier commit), and the cuts after the last
    decision.  A client migrates only with no round in flight, so each of
    its later serves starts after the commit."""
    cuts, out, applied = list(cuts0), [], [d for d in decisions if d.applied]
    for ev in serves:
        while applied and applied[0].time < ev.start:
            for u, (_old, new) in applied.pop(0).cut_changes.items():
                cuts[u] = new
        out.append(list(cuts))
    for d in applied:
        for u, (_old, new) in d.cut_changes.items():
            cuts[u] = new
    return out, cuts


def full_width_timing() -> None:
    """Point every quantity the control, resume and population phases'
    timelines read at bert-base's full width, whatever the width of the
    model that runs: the Simulator's ``client_step_times`` and
    ``lora_upload_bytes``, the int8 transport ratio at d 768, the control
    loop's model, and the population clock's ``step_time_arrays`` and the
    clock's and the trainer's ``lora_upload_bytes``."""
    from repro_torch.comm import transport_bytes
    from repro_torch.control import ControlLoop
    from repro_torch.core.cost_model import dtype_nbytes
    from repro_torch.fed import population as pop_mod
    from repro_torch.fed import population_training as pop_train_mod
    from repro_torch.fed import simulator as sim_mod

    full = REGISTRY["bert-base"]
    step_times, upload_bytes = sim_mod.client_step_times, sim_mod.lora_upload_bytes
    sim_mod.client_step_times = lambda cfg, *a, **k: step_times(full, *a, **k)
    sim_mod.lora_upload_bytes = lambda cfg, *a, **k: upload_bytes(full, *a, **k)
    sim_mod.ControlLoop = lambda cfg, *a, **k: ControlLoop(full, *a, **k)
    arrays = pop_mod.step_time_arrays
    pop_mod.step_time_arrays = lambda cfg, *a, **k: arrays(full, *a, **k)
    pop_mod.lora_upload_bytes = sim_mod.lora_upload_bytes
    pop_train_mod.lora_upload_bytes = sim_mod.lora_upload_bytes

    def ratio(self) -> float:
        shape, nb = (BATCH, SEQ, full.d_model), dtype_nbytes(full.dtype)
        return transport_bytes(shape, True, nb) / transport_bytes(shape, False, nb)
    Simulator._transport_ratio = ratio


def predict_control(kind: str, train, test) -> dict:
    """One control run's timeline on the CPU (``--predict-control``).  The
    control loop's decisions read only the network plane's rates at
    simulated instants, the cost and memory models and the controller's
    own state: no loss and no tensor.  So the decision log, the simulated
    times, the served events, the loss-event keys and the discards follow
    from the port's pinned clock, plane, cost model and control loop alone,
    whatever device runs the model.  The run replays with the model cut to
    a 12-layer bert-base of width 64 (the depth, and so every cut the loop
    may choose, is bert-base's) under ``full_width_timing``."""
    from repro_torch.configs import reduced

    full = REGISTRY["bert-base"]
    small = reduced(full, n_layers=full.n_layers, d_model=64).with_(
        vocab_size=full.vocab_size, max_position=SEQ)
    sim = control_simulator(kind, small, train, test, "cpu")
    sim.run_training()
    serves = sim.clock_result.serves
    serve_cuts, _ = cuts_at_serves(PAPER_CUTS, serves, sim.control_events)
    n_evals = sum(r.accuracy is not None for r in sim.history)
    n_eval_batches = min(32, len(test) // BATCH)
    counters = sim.obs.metrics.summary()["counters"]
    return {
        "decisions": [sim._control._enc_decision(d) for d in sim.control_events],
        "sim_times": [r.sim_time_s for r in sim.history],
        "loss_event_keys": [list(e[:3]) for e in sim.loss_events],
        "discarded": [list(d) for d in sim.discarded_updates],
        "chunk_sizes": [len(ev.uids) for ev in serves],
        "serve_cuts": serve_cuts,
        "final_cuts": list(sim.cuts),
        "n_evals": n_evals,
        "reassign_spans": sum(s.name == "reassign" for s in sim.obs.tracer.spans()),
        "counters": {k: v for k, v in counters.items() if k.startswith("migration")},
        "launches": launch_rule(full, serves, serve_cuts, n_evals, n_eval_batches),
        "launches_at_initial_cuts": launch_rule(full, serves, [PAPER_CUTS] * len(serves),
                                                n_evals, n_eval_batches),
    }


# the keys of each run that the card's runs are held to
PINNED_CONTROL_KEYS = ("decisions", "sim_times", "loss_event_keys", "discarded",
                       "chunk_sizes", "final_cuts")


def predict_control_phase() -> None:
    """``--predict-control``: both control runs on the CPU, each printed as
    one ``[predict:KIND]`` line, then ``PREDICTED_CONTROL`` in the literal
    form this file holds, ready to paste over it."""
    torch.set_num_threads(4)
    full_width_timing()
    full = REGISTRY["bert-base"]
    train = make_emotion_dataset(N_TRAIN, seq_len=SEQ, vocab_size=full.vocab_size, seed=0)
    test = make_emotion_dataset(N_TEST, seq_len=SEQ, vocab_size=full.vocab_size, seed=1)
    pinned = {}
    for kind in ("sync", "buffered"):
        pred = predict_control(kind, train, test)
        print(f"[predict:{kind}] {json.dumps(pred)}", flush=True)
        pinned[kind] = {k: pred[k] for k in PINNED_CONTROL_KEYS}
    print("PREDICTED_CONTROL = " + pprint.pformat(pinned, sort_dicts=False), flush=True)


# the decision logs and timelines of the phase's two runs, computed on the
# CPU by ``python3 chip_smoke.py --predict-control`` before any chip run:
# the decisions read no tensor, so the device cannot change them.  A change
# to the clock, the plane, the cost or memory model, the control loop or the
# settings above changes them: rerun that command and paste its last line
PREDICTED_CONTROL = {'sync': {'decisions': [{'time': 0.9739208179203868,
                         'version': 1,
                         'trigger': 'memory',
                         'cut': [[4, 3, 2]],
                         'rank': [],
                         'batch': [],
                         'gain': 0.0,
                         'mig': [[4, 0.03145728000000003]],
                         'applied': True}],
          'sim_times': [1.1941217779203868, 2.3605924861947964],
          'loss_event_keys': [[0.23617270728255313, 3, 0],
                              [0.3123017354020934, 5, 0],
                              [0.3123017354020934, 1, 0],
                              [0.3846245531676106, 4, 0],
                              [0.3846245531676106, 2, 0],
                              [0.4264952775814037, 0, 0],
                              [1.43029448520294, 3, 1],
                              [1.54448802738225, 4, 1],
                              [1.54448802738225, 5, 1],
                              [1.54448802738225, 1, 1],
                              [1.6244232658558135, 0, 1],
                              [1.6244232658558135, 2, 1]],
          'discarded': [],
          'chunk_sizes': [1, 2, 2, 1, 1, 3, 2],
          'final_cuts': [1, 1, 2, 2, 2, 3]},
 'buffered': {'decisions': [{'time': 6.183653671677159,
                             'version': 4,
                             'trigger': 'fade',
                             'cut': [[4, 3, 1]],
                             'rank': [],
                             'batch': [],
                             'gain': 0.27000869780150083,
                             'mig': [[4, 1.572864]],
                             'applied': True}],
              'sim_times': [0.7018680869446917,
                            1.3151595141554775,
                            2.1163820178422457,
                            7.756517671677159,
                            15.834286955345728],
              'loss_event_keys': [[0.23617270728255313, 3, 0],
                                  [0.3123017354020934, 5, 0],
                                  [0.3123017354020934, 1, 0],
                                  [0.3846245531676106, 4, 0],
                                  [0.3846245531676106, 2, 0],
                                  [0.4264952775814037, 0, 0],
                                  [0.9763738722908157, 1, 1],
                                  [1.014438386350586, 3, 1],
                                  [1.048696690056333, 5, 1],
                                  [1.6602572780909137, 2, 1],
                                  [1.725442528738762, 0, 1],
                                  [11.793202582509211, 4, 1]],
              'discarded': [],
              'chunk_sizes': [1, 2, 2, 1, 1, 1, 1, 1, 1, 1],
              'final_cuts': [1, 1, 2, 2, 1, 3]}}


def run_control(kind: str, fused: bool, train, test, trace_dir: str) -> dict:
    """One controlled run at the main path's full width, every counter set
    to 0 just before ``run_training`` and read just after.  Launches are
    held against ``expected_event_launches`` at the cuts in force at each
    serve event; the decision log, the records' simulated times, the loss
    events' keys and the discards against the CPU prediction."""
    label = f"control:{kind}:" + ("fused" if fused else "einsum")
    t0 = time.perf_counter()
    sim = control_simulator(kind, REGISTRY["bert-base"], train, test, "cuda",
                            fused=fused, trace_dir=trace_dir)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                      # just before the path runs
    t0 = time.perf_counter()
    sim.run_training()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()              # just after
    serves = list(sim.clock_result.serves)
    serve_cuts, derived_cuts = cuts_at_serves(PAPER_CUTS, serves, sim.control_events)
    n_evals = sum(r.accuracy is not None for r in sim.history)
    n_eval = min(32, len(test) // BATCH)
    expected = expected_event_launches(sim.cfg, None, serves, n_evals, n_eval, fused, True,
                                       serve_cuts=serve_cuts)
    # the same rule at the initial cuts: where it differs, the counters saw
    # the migration
    at_initial_cuts = expected_event_launches(sim.cfg, PAPER_CUTS, serves, n_evals, n_eval,
                                              fused, True)
    with open(Path(trace_dir) / "trace.json") as fh:
        doc = json.load(fh)
    counters = doc["otherData"]["metrics"]["counters"]
    out = {"label": label,
           "decisions": [sim._control._enc_decision(d) for d in sim.control_events],
           "history": [dataclasses.astuple(r) for r in sim.history],
           "sim_times": [r.sim_time_s for r in sim.history],
           "loss_event_keys": [list(e[:3]) for e in sim.loss_events],
           "discarded": [list(d) for d in sim.discarded_updates],
           "chunk_sizes": [len(ev.uids) for ev in serves], "final_cuts": list(sim.cuts),
           "serve_cuts": serve_cuts, "launches": counts, "expected": expected,
           "expected_at_initial_cuts": at_initial_cuts,
           "setup_s": setup_s, "wall_s": wall_s,
           "max_mem_bytes": torch.cuda.max_memory_allocated(),
           "migration_accepted": counters.get("migration_accepted", 0.0),
           "migration_rejected": counters.get("migration_rejected", 0.0),
           "reassign_spans": sum(ev["name"] == "reassign" for ev in doc["traceEvents"])}
    for rec in sim.history:
        print(f"[{label}] record {rec.round} loss={rec.mean_loss:.7f} "
              f"sim_time_s={rec.sim_time_s!r} accuracy={rec.accuracy}", flush=True)
    print(f"[{label}] setup_s={setup_s:.3f} wall_s={wall_s:.3f} "
          f"max_mem_bytes={out['max_mem_bytes']} decisions={json.dumps(out['decisions'])} "
          f"migration_accepted={out['migration_accepted']} "
          f"migration_rejected={out['migration_rejected']} "
          f"reassign_spans={out['reassign_spans']} chunk_sizes={out['chunk_sizes']} "
          f"serve_cuts={json.dumps(serve_cuts)} launches={json.dumps(counts)} "
          f"expected={json.dumps(expected)} "
          f"expected_at_initial_cuts={json.dumps(at_initial_cuts)}", flush=True)
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts}, expected {expected}")
    if not any(d.applied and d.cut_changes for d in sim.control_events):
        raise AssertionError(f"{label}: no cut change was applied")
    # the migrated clients' frozen prefixes and steps follow the live cuts
    for u, cut in enumerate(sim.cuts):
        depth = tree_leaves(sim.client_params[u]["layers"])[0].shape[0]
        if depth != cut or cut not in sim._cli_steps or cut not in sim._srv_steps:
            raise AssertionError(f"{label}: client {u} at cut {cut} holds {depth} layers "
                                 f"(steps at cuts {sorted(sim._cli_steps)})")
    if derived_cuts != sim.cuts:
        raise AssertionError(f"{label}: the decision log gives cuts {derived_cuts}, "
                             f"the run holds {sim.cuts}")
    for key, want in PREDICTED_CONTROL[kind].items():
        if out[key] != want:
            raise AssertionError(f"{label}: {key} {out[key]} against the CPU prediction "
                                 f"{want} (if the model of the run changed, rerun "
                                 f"`python3 chip_smoke.py --predict-control` and paste "
                                 f"its PREDICTED_CONTROL)")
    if out["reassign_spans"] != len(sim.control_events) or \
            out["migration_accepted"] + out["migration_rejected"] != out["reassign_spans"]:
        raise AssertionError(f"{label}: {out['reassign_spans']} reassign spans for "
                             f"{len(sim.control_events)} decisions")
    if not sim.loss_events or not all(math.isfinite(e[3]) for e in sim.loss_events):
        raise AssertionError(f"{label}: loss events {sim.loss_events}")
    acc = sim.history[-1].accuracy
    if acc is None or not 0.0 <= acc <= 1.0:
        raise AssertionError(f"{label}: evaluation gave accuracy {acc}")
    if fused:                           # the [resume] phase resumes the fused runs
        out["final"] = final_state(sim)
    del sim
    gc.collect()
    return out


def check_control(fused: dict, plain: dict) -> dict:
    """Fused against einsum: the decision log, simulated times, loss-event
    keys and discards equal (each run already equals the CPU prediction);
    per-record losses within LOSS_RTOL, the cohort path's limit, which
    allows for the int8 quantizer's whole-code steps."""
    for key in ("decisions", "sim_times", "loss_event_keys", "discarded"):
        if fused[key] != plain[key]:
            raise AssertionError(f"{fused['label']}: {key} differ from the einsum run's")
    gaps = []
    for f, p in zip(fused["history"], plain["history"]):
        if math.isnan(p[2]) or math.isnan(f[2]):
            if not (math.isnan(p[2]) and math.isnan(f[2])):
                raise AssertionError(f"record {f[0]}: loss {f[2]} against {p[2]}")
            continue
        gaps.append(abs(f[2] - p[2]) / abs(p[2]))
        if not gaps[-1] <= LOSS_RTOL:
            raise AssertionError(f"{fused['label']} record {f[0]}: fused loss {f[2]} "
                                 f"against einsum {p[2]} (rtol {LOSS_RTOL})")
    out = {"records": len(fused["history"]), "max_loss_rel_gap": max(gaps)}
    print(f"[control] {fused['label']} vs einsum {json.dumps(out)}", flush=True)
    return out


def control_phase(train, test, finals: dict) -> dict:
    """[control]: the two controlled runs, fused and einsum each; each
    fused run's ``final_state`` goes into ``finals`` for the [resume]
    phase."""
    keep = ("decisions", "sim_times", "chunk_sizes", "serve_cuts", "final_cuts",
            "launches", "expected_at_initial_cuts", "setup_s", "wall_s", "max_mem_bytes",
            "migration_accepted", "migration_rejected", "reassign_spans")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("sync", "buffered"):
            runs = {fused: run_control(kind, fused, train, test,
                                       f"{tmp}/{kind}-{'fused' if fused else 'einsum'}")
                    for fused in (True, False)}
            finals[f"control:{kind}"] = runs[True].pop("final")
            out[kind] = {"check": check_control(runs[True], runs[False]),
                         **{("fused" if f else "einsum"): {k: run[k] for k in keep}
                            for f, run in runs.items()}}
    if all(out[kind]["fused"]["launches"] == out[kind]["fused"]["expected_at_initial_cuts"]
           for kind in out):
        raise AssertionError("no control run's launches depend on the migrated cuts")
    print(f"[control] {json.dumps(out)}", flush=True)
    return out


def control_launches(control: dict, name: str) -> dict:
    """A kernel's launches in each run of the control phase."""
    return {f"{kind}:{path}": runs[path]["launches"][name]
            for kind, runs in control.items() for path in ("fused", "einsum")}


# [resume] phase: kill and resume on the card
# ---------------------------------------------------------------------------

# each run's snapshot cadence and preemption instant (simulated seconds),
# chosen on the CPU from the runs' timelines at bert-base's full-width
# timing (``--predict-resume``; PERF.md §6).  The buffered event run
# snapshots at 0.2 and 0.4 s, the second after the first serve (one
# client's error-feedback residual, five rounds in flight), and is killed at
# the first tick past 0.5 s, after two more serves, the chunks of two and
# three, which the resumed run replays.  The controlled sync run snapshots
# and is killed at its round-1 barrier, past the 0.974 s shed of client 4.
# The controlled buffered run snapshots past the 6.18 s fade migration of
# client 4 and at its next round start (one round in flight), and is
# killed before that round's serve and the last record at 15.83 s
RESUME_KNOBS = {"event:buffered": (0.2, 0.5), "control:sync": (1.0, 1.1),
                "control:buffered": (4.0, 10.0)}


def resume_simulator(key: str, cfg, train, test, device: str, **knobs) -> Simulator:
    """The fused run ``key`` of the [event] or [control] phase, with the
    snapshot, resume or preemption ``knobs`` in its config."""
    family, policy = key.split(":")
    if family == "event":
        run = dataclasses.replace(event_run(policy, True), **knobs)
        return Simulator(cfg, PAPER_CLIENTS, PAPER_CUTS, train, test, run, device=device)
    return control_simulator(policy, cfg, train, test, device, **knobs)


def snapshot_leaf_bytes(tree) -> int:
    """The bytes a loaded snapshot's leaves hold, from their shapes and
    dtypes (what the file must carry beside its header and padding)."""
    if isinstance(tree, dict):
        return sum(snapshot_leaf_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(snapshot_leaf_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return np.asarray(tree).nbytes


def kill_and_resume(key: str, cfg, train, test, device: str, snap_dir: str) -> dict:
    """Run ``key`` with periodic snapshots into ``snap_dir`` until its
    preemption (RESUME_KNOBS), read the snapshot the resume will take, then
    resume it in a fresh Simulator, every counter set to 0 just before the
    resumed ``run_training`` and read just after.  ``info`` holds what the
    clock decides (no tensor enters it, so the CPU predicts it): the
    snapshot instants, the resumed snapshot's instant, cuts, in-flight pulls,
    residuals and serves, the serves the resumed run replays, and the
    launches ``launch_rule`` gives over the serves after the snapshot at the
    cuts in force at each."""
    every, kill = RESUME_KNOBS[key]
    killed = resume_simulator(key, cfg, train, test, device, snapshot_every=every,
                              snapshot_dir=snap_dir, preempt_at=kill)
    saves = []                          # (instant, save wall s, file bytes)
    save_one = killed._snapshotter.maybe_save

    def timed_save(now, state_fn):
        t0 = time.perf_counter()
        path = save_one(now, state_fn)
        if path is not None:
            saves.append((now, time.perf_counter() - t0, os.path.getsize(path)))
        return path
    killed._snapshotter.maybe_save = timed_save
    killed.run_training()
    if not killed.clock_result.preempted or not saves:
        raise AssertionError(f"[resume:{key}] the run was not preempted after a snapshot")
    kill_time, killed_serves = killed._clock.now, len(killed.clock_result.serves)
    del killed
    gc.collect()

    t0 = time.perf_counter()
    snap = load_snapshot(snap_dir, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    clock = unpack_json(snap["des"])["clock"]
    n_snap = len(clock["serves"])
    info = {"snapshot_times": [t for t, _, _ in saves], "snapshot_time": clock["now"],
            "kill_time": kill_time, "cuts": [int(c) for c in snap["cuts"]],
            "round_pulls": len(snap["round_pull"]), "ef_residuals": len(snap["ef_residual"]),
            "snapshot_serves": n_snap, "replayed_serves": killed_serves - n_snap}
    measured = {"snapshot_bytes": saves[-1][2], "leaf_bytes": snapshot_leaf_bytes(snap),
                "save_s": [s for _, s, _ in saves], "load_s": load_s}
    del snap

    resumed = resume_simulator(key, cfg, train, test, device, resume_from=snap_dir)
    evals = {"n": 0}
    evaluate = resumed.evaluate

    def counted(*args, **kwargs):
        evals["n"] += 1
        return evaluate(*args, **kwargs)
    resumed.evaluate = counted
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()                      # just before the path runs
    t0 = time.perf_counter()
    resumed.run_training()
    if device == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()              # just after
    serves = list(resumed.clock_result.serves)
    serve_cuts, _ = cuts_at_serves(PAPER_CUTS, serves, resumed.control_events)
    n_eval_batches = min(32, len(test) // BATCH)
    info["resume_launches"] = launch_rule(REGISTRY["bert-base"], serves[n_snap:],
                                          serve_cuts[n_snap:], evals["n"], n_eval_batches)
    measured.update(wall_s=wall_s, evaluations=evals["n"])
    if device == "cuda":
        measured["max_mem_bytes"] = torch.cuda.max_memory_allocated()
    return {"info": info, "measured": measured, "launches": counts, "sim": resumed}


def check_resumed(key: str, run: dict, whole: dict) -> None:
    """The resumed run against the uninterrupted one (``final_state``), bit
    for bit; its clock's decisions against the CPU prediction; its launches
    against the rule."""
    got = final_state(run["sim"])
    for field in ("clock", "history", "loss_events", "discarded", "decisions", "cuts", "obs"):
        if got.get(field) != whole.get(field):
            raise AssertionError(f"[resume:{key}] {field} differs from the uninterrupted run's")
    for field in ("global_full", "global_head"):
        pairs = list(zip(tree_leaves(got[field]), tree_leaves(whole[field])))
        if len(pairs) != len(tree_leaves(whole[field])) or not all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"[resume:{key}] {field} differs from the uninterrupted run's")
    if run["info"] != PREDICTED_RESUME[key]:
        raise AssertionError(f"[resume:{key}] {run['info']} against the CPU prediction "
                             f"{PREDICTED_RESUME[key]} (if the run's settings changed, rerun "
                             f"`python3 chip_smoke.py --predict-resume` and paste its "
                             f"PREDICTED_RESUME)")
    expected = no_launches(**run["info"]["resume_launches"])
    if run["launches"] != expected:
        raise AssertionError(f"[resume:{key}] launches {run['launches']}, expected {expected}")
    if not (run["launches"]["lora_matmul"] > 0 and run["launches"]["quantize_rows"] > 0):
        raise AssertionError(f"[resume:{key}] the resumed run launched {run['launches']}")


def resume_phase(train, test, finals: dict) -> dict:
    """[resume]: each run of ``finals`` (the buffered event run and both
    controlled runs, fused) killed after a snapshot and resumed in a fresh
    Simulator, held bit for bit against its uninterrupted run."""
    out, t0 = {}, time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for key in RESUME_KNOBS:
            run = kill_and_resume(key, REGISTRY["bert-base"], train, test, "cuda",
                                  f"{tmp}/{key.replace(':', '-')}")
            check_resumed(key, run, finals[key])
            del run["sim"]
            gc.collect()
            out[key] = {k: run[k] for k in ("info", "measured", "launches")}
            print(f"[resume:{key}] {json.dumps(out[key])}", flush=True)
    # the snapshot instants read no tensor; the chunked kernel must have run
    # after some resume (the controlled buffered run serves single clients
    # after its migration, so it launches none there)
    if not any(run["launches"]["grouped_lora_chunk"] for run in out.values()):
        raise AssertionError("no resumed run launched grouped_lora")
    print(f"[resume] {gpu_line()} phase_s={time.perf_counter() - t0:.3f} "
          f"{json.dumps(out)}", flush=True)
    return out


def resume_launches(resume: dict, name: str) -> dict:
    """A kernel's launches in each resumed run of the [resume] phase."""
    return {key: run["launches"][name] for key, run in resume.items()}


def predict_resume_phase() -> None:
    """``--predict-resume``: the [resume] phase's three kills and resumes on
    the CPU at bert-base's full-width timing (as ``predict_control``: the
    model cut to width 64, its depth and every simulated time bert-base's),
    each printed as one ``[predict:resume:KEY]`` line, then
    ``PREDICTED_RESUME`` in the literal form this file holds."""
    from repro_torch.configs import reduced

    torch.set_num_threads(4)
    full_width_timing()
    full = REGISTRY["bert-base"]
    small = reduced(full, n_layers=full.n_layers, d_model=64).with_(
        vocab_size=full.vocab_size, max_position=SEQ)
    train = make_emotion_dataset(N_TRAIN, seq_len=SEQ, vocab_size=full.vocab_size, seed=0)
    test = make_emotion_dataset(N_TEST, seq_len=SEQ, vocab_size=full.vocab_size, seed=1)
    pinned = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key in RESUME_KNOBS:
            run = kill_and_resume(key, small, train, test, "cpu",
                                  f"{tmp}/{key.replace(':', '-')}")
            print(f"[predict:resume:{key}] {json.dumps(run['info'])}", flush=True)
            pinned[key] = run["info"]
    print("PREDICTED_RESUME = " + pprint.pformat(pinned, sort_dicts=False), flush=True)


# the [resume] phase's snapshot instants, restored state and launches after
# the resume, computed on the CPU by ``python3 chip_smoke.py
# --predict-resume`` before any chip run (no tensor enters them).  A change
# to RESUME_KNOBS, the runs' settings, the clock, the plane, the cost model
# or the control loop changes them: rerun that command and paste its last
# line
PREDICTED_RESUME = {'event:buffered': {'snapshot_times': [0.21047053016949152, 0.4054796992086564],
                    'snapshot_time': 0.4054796992086564,
                    'kill_time': 0.5958022695075069,
                    'cuts': [1, 1, 2, 2, 3, 3],
                    'round_pulls': 5,
                    'ef_residuals': 1,
                    'snapshot_serves': 1,
                    'replayed_serves': 2,
                    'resume_launches': {'lora_matmul': 2159,
                                        'grouped_lora_chunk': 400,
                                        'quantize_rows': 22}},
 'control:sync': {'snapshot_times': [1.1941217779203868],
                  'snapshot_time': 1.1941217779203868,
                  'kill_time': 1.1941217779203868,
                  'cuts': [1, 1, 2, 2, 2, 3],
                  'round_pulls': 0,
                  'ef_residuals': 6,
                  'snapshot_serves': 4,
                  'replayed_serves': 0,
                  'resume_launches': {'lora_matmul': 1686,
                                      'grouped_lora_chunk': 408,
                                      'quantize_rows': 12}},
 'control:buffered': {'snapshot_times': [7.756517671677159, 8.54294967167716],
                      'snapshot_time': 8.54294967167716,
                      'kill_time': 11.75133185809542,
                      'cuts': [1, 1, 2, 2, 1, 3],
                      'round_pulls': 1,
                      'ef_residuals': 6,
                      'snapshot_serves': 9,
                      'replayed_serves': 0,
                      'resume_launches': {'lora_matmul': 1629,
                                          'grouped_lora_chunk': 0,
                                          'quantize_rows': 2}}}


# [population] phase: FleetSpec fleets, sampled cohorts, stragglers and edge
# cells in the Simulator, and the cohort-resident PopulationTrainer
# ---------------------------------------------------------------------------

# the three fleets: the Simulator's sampled fleet, the exact trainer's twin
# below the population threshold, and the scale fleet of 10^4 clients, each
# holding POP_SCALE_PER_CLIENT examples (one batch)
POP_SIM_SPEC = dict(n=24, seed=0, link_model="constant")
POP_EXACT_SPEC = dict(n=12, seed=3, link_model="constant")
POP_SCALE_SPEC = dict(n=10_000, seed=0, link_model="constant")
POP_SCALE_ROUNDS, POP_SCALE_PER_CLIENT = 3, 16
POP_KEYS = ("sim", "exact:sync", "exact:async", "scale")


def population_run(key: str, fused: bool = True) -> FedRunConfig:
    """The phase's runs, all fp32 at bert-base's path shapes (batch 16, seq
    128) under the event clock.  ``sim``: the Simulator on POP_SIM_SPEC,
    sync FedAvg each round, Pareto cohorts of half the fleet, stragglers at
    0.3, three k-means edge cells, ragged chunks of up to 6, int8 links.
    ``exact:sync``: Pareto cohorts of 0.6, the vmap step in chunks of up
    to 3, two k-means cells; ``exact:async``: buffered commits of half the
    fleet, two local rounds in flight, the ragged step; both on one server
    slot, where arrivals queue into chunks.
    ``scale``: Pareto cohorts of 0.003 (30 clients of 10^4) over four
    k-means cells, ragged chunks of 8 on four slots, vectorized rounds
    (threshold 20), an evaluation after the last round."""
    base = dict(batch_size=BATCH, seq_len=SEQ, lr=LR, seed=0)
    if key == "sim":
        return FedRunConfig(
            **base, rounds=ROUNDS,
            engine=EngineConfig(mode="event", fused_lora=fused, cohort_chunk=6,
                                cohort_impl="ragged"),
            agg=AggConfig(policy="sync", interval=1),
            net=NetConfig(link_model="custom", quantize=True),
            fleet=FleetConfig(sampling="pareto", rate=0.5, straggler_prob=0.3,
                              edge_cells=3, cell_assignment="kmeans"))
    if key == "exact:sync":
        return FedRunConfig(
            **base, rounds=ROUNDS, eval_every=ROUNDS,
            engine=EngineConfig(mode="event", fused_lora=fused, cohort_chunk=3,
                                cohort_impl="vmap"),
            agg=AggConfig(policy="sync", interval=1), net=NetConfig(link_model="custom"),
            fleet=FleetConfig(sampling="pareto", rate=0.6, edge_cells=2,
                              cell_assignment="kmeans"))
    if key == "exact:async":
        return FedRunConfig(
            **base, rounds=ROUNDS, eval_every=ROUNDS,
            engine=EngineConfig(mode="event", fused_lora=fused, cohort_chunk=3,
                                cohort_impl="ragged"),
            agg=AggConfig(policy="buffered", interval=1, max_inflight=2),
            net=NetConfig(link_model="custom"))
    return FedRunConfig(
        **base, rounds=POP_SCALE_ROUNDS, eval_every=POP_SCALE_ROUNDS,
        engine=EngineConfig(mode="event", fused_lora=fused, slots=4, cohort_chunk=8,
                            cohort_impl="ragged"),
        agg=AggConfig(policy="sync", interval=1),
        fleet=FleetConfig(sampling="pareto", rate=0.003, edge_cells=4,
                          cell_assignment="kmeans", population_threshold=20))


def measured(fn, device):
    """``fn()``'s result with its wall s, peak bytes and launches, every
    counter set to 0 just before it and read just after."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, {"wall_s": time.perf_counter() - t0, "launches": read_counts(),
                 "max_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None}


def record_draws(sim) -> dict:
    """Each round's straggling clients and sampled cohort, read from the
    round stream's two draws (instance attributes: the wave planner and
    the analytic loop look them up at each call)."""
    rec = {"stragglers": [], "cohorts": []}
    adjusted, sample = sim._adjusted_times, sim._sample_cohort

    def adjusted_times():
        out = adjusted()
        rec["stragglers"].append([u for u, (st, base) in enumerate(zip(out, sim.times))
                                  if st.t_f != base.t_f])
        return out

    def sample_cohort():
        sample()
        rec["cohorts"].append(list(sim._active))

    sim._adjusted_times, sim._sample_cohort = adjusted_times, sample_cohort
    return rec


def pop_timeline(drv, serves, cuts, impl: str, cohorts) -> dict:
    """What the card's run is held to: cohorts, simulated times, loss-event
    keys, chunk sizes and the launches ``launch_rule`` gives at bert-base's
    full width over the card's N_TEST examples (``quantize_rows`` under
    int8 links only).  None of it reads a tensor."""
    n_evals = sum(r.accuracy is not None for r in drv.history)
    launches = launch_rule(REGISTRY["bert-base"], serves, [cuts] * len(serves), n_evals,
                           min(32, N_TEST // BATCH), impl=impl)
    if not drv.run.net.quantize:
        launches["quantize_rows"] = 0
    return {"cohorts": cohorts, "sim_times": [r.sim_time_s for r in drv.history],
            "loss_event_keys": [list(e[:3]) for e in drv.loss_events],
            "chunk_sizes": [len(ev.uids) for ev in serves], "launches": launches}


def hist_rows(drv) -> list:
    """History rows, a nan mean loss (a commit with no serve since the
    last) as None so that equal rows compare equal."""
    return [(r.round, r.sim_time_s, None if math.isnan(r.mean_loss) else r.mean_loss,
             r.accuracy, r.f1) for r in drv.history]


def pop_sim(cfg, train, test, device, fused: bool) -> dict:
    """[population:sim]: the Simulator on a sampled fleet with stragglers
    and k-means edge cells."""
    sim = Simulator(cfg, fleet=FleetSpec(**POP_SIM_SPEC), train=train, test=test,
                    run=population_run("sim", fused), device=device)
    draws = record_draws(sim)
    _, m = measured(sim.run_training, device)
    serves = list(sim.clock_result.serves)
    tl = pop_timeline(sim, serves, sim.cuts, "ragged", draws["cohorts"])
    tl.update(stragglers=draws["stragglers"],
              edge_cells=[list(c) for c in sim._edges.cells])
    return {"timeline": tl, "losses": [e[3] for e in sim.loss_events],
            "accuracy": sim.history[-1].accuracy, **m}


def pop_exact(kind: str, cfg, train, test, device) -> dict:
    """[population:exact]: ``train_population`` and the Simulator on one
    fleet below the threshold, the same seeds: loss events, history rows,
    every global-adapter leaf and the makespan bit for bit."""
    spec, run = FleetSpec(**POP_EXACT_SPEC), population_run(f"exact:{kind}")
    sim = Simulator(cfg, fleet=spec, train=train, test=test, run=run, device=device)
    _, m_sim = measured(sim.run_training, device)
    tr, m_tr = measured(lambda: train_population(cfg, spec.population(), run, train, test,
                                                 device=device), device)
    label = f"population:exact:{kind}"
    checks = {"loss_events": tr.loss_events == sim.loss_events,
              "history": hist_rows(tr) == hist_rows(sim),
              "discarded": tr.discarded_updates == sim.discarded_updates,
              "makespan": tr.clock_result.makespan == sim.sim_clock,
              "global_full": all(torch.equal(a, b) for a, b in
                                 zip(tree_leaves(tr.store.global_full),
                                     tree_leaves(sim._global_full))),
              "global_head": torch.equal(tr.store.global_head, sim._global_head)}
    if not all(checks.values()):
        first = next((i for i, (a, b) in enumerate(zip(tr.loss_events, sim.loss_events))
                      if a != b), None)
        raise AssertionError(f"{label}: trainer and Simulator differ: {checks}; first "
                             f"loss event apart: {first}")
    if m_tr["launches"] != m_sim["launches"]:
        raise AssertionError(f"{label}: trainer and Simulator launch apart")
    serves = list(sim.clock_result.serves)
    cohorts = [sorted(u for rec in r.service for u in rec.uids)
               for r in tr.clock_result.round_results]
    tl = pop_timeline(sim, serves, sim.cuts, run.engine.cohort_impl, cohorts)
    tl["discarded"] = [list(d) for d in sim.discarded_updates]
    return {"timeline": tl, "checks": checks, "launches": m_tr["launches"],
            "simulator": m_sim, "trainer": m_tr, "losses": [e[3] for e in tr.loss_events],
            "accuracy": tr.history[-1].accuracy, "modes": tr.clock_result.modes}


def pop_scale(cfg, test, device) -> dict:
    """[population:scale]: ``train_population`` on a 10^4-client fleet,
    every commit's cohort-resident slots and bytes read just before it; the
    train set's sequences as long as the test set's."""
    t0 = time.perf_counter()
    train = make_emotion_dataset(POP_SCALE_SPEC["n"] * POP_SCALE_PER_CLIENT,
                                 seq_len=test.tokens.shape[1], vocab_size=cfg.vocab_size,
                                 seed=2)
    fleet = FleetSpec(**POP_SCALE_SPEC).population()
    data_s = time.perf_counter() - t0
    seen = []
    commit = PopulationTrainer.commit_sync

    def watched(self):
        seen.append((len(self.store.touched()), self.store.resident_nbytes()))
        return commit(self)

    PopulationTrainer.commit_sync = watched
    try:
        tr, m = measured(lambda: train_population(cfg, fleet, population_run("scale"),
                                                  train, test, device=device), device)
    finally:
        PopulationTrainer.commit_sync = commit
    res = tr.clock_result
    services = [rec for r in res.round_results for rec in r.service]
    cohorts = [sorted(u for rec in r.service for u in rec.uids) for r in res.round_results]
    label = "population:scale"
    losses = [e[3] for e in tr.loss_events]
    if set(res.modes) != {"vectorized"} or not losses or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: modes {res.modes}, losses {losses}")
    if len(seen) != POP_SCALE_ROUNDS or max(n for n, _ in seen) > max(res.cohort_sizes):
        raise AssertionError(f"{label}: resident slots {seen} beyond the largest cohort "
                             f"{max(res.cohort_sizes)}")
    tl = pop_timeline(tr, services, [int(c) for c in fleet.cuts], "ragged", cohorts)
    return {"timeline": tl, "data_s": data_s, "slots": [n for n, _ in seen],
            "resident_bytes": [b for _, b in seen], "cohort_sizes": res.cohort_sizes,
            "losses": losses, "accuracy": tr.history[-1].accuracy,
            "exact": tr.exact, **m}


def population_runs(cfg, train, test, device, einsum: bool) -> dict:
    """Every run of the phase (the sim run also on the einsum path where
    ``einsum``), each freed before the next."""
    out = {"sim": pop_sim(cfg, train, test, device, True)}
    if einsum:
        out["sim:einsum"] = pop_sim(cfg, train, test, device, False)
    for kind in ("sync", "async"):
        out[f"exact:{kind}"] = pop_exact(kind, cfg, train, test, device)
        gc.collect()
    out["scale"] = pop_scale(cfg, test, device)
    return out


# the keys of each run's timeline that the card's runs are held to
PINNED_POPULATION_KEYS = ("cohorts", "stragglers", "edge_cells", "sim_times",
                          "loss_event_keys", "chunk_sizes", "discarded", "launches")


def predict_population_phase() -> None:
    """``--predict-population``: the phase's runs on the CPU at bert-base's
    full-width timing (as ``predict_control``: the model cut to width 64,
    its depth and every simulated time bert-base's; the exact runs' trainer
    held against the Simulator bit for bit here too).  No timeline reads a
    tensor, so the replay also cuts the data: sequences of 16 tokens (the
    runs' ``seq_len``, which the cost model reads, stays 128) and one test
    batch.  Each timeline is printed as one ``[predict:population:KEY]``
    line, then ``PREDICTED_POPULATION`` in the literal form this file
    holds."""
    from repro_torch.configs import reduced

    torch.set_num_threads(1)      # small ops: more threads only contend
    full_width_timing()
    full = REGISTRY["bert-base"]
    small = reduced(full, n_layers=full.n_layers, d_model=64).with_(
        vocab_size=full.vocab_size, max_position=SEQ)
    train = make_emotion_dataset(N_TRAIN, seq_len=16, vocab_size=full.vocab_size, seed=0)
    test = make_emotion_dataset(BATCH, seq_len=16, vocab_size=full.vocab_size, seed=1)
    runs = population_runs(small, train, test, "cpu", einsum=False)
    pinned = {}
    for key in POP_KEYS:
        tl = runs[key]["timeline"]
        print(f"[predict:population:{key}] {json.dumps(tl)}", flush=True)
        pinned[key] = {k: tl[k] for k in PINNED_POPULATION_KEYS if k in tl}
    print("PREDICTED_POPULATION = " + pprint.pformat(pinned, sort_dicts=False, compact=True),
          flush=True)


# the [population] phase's cohorts, straggler draws, edge cells, simulated
# times, loss-event keys, chunks and launches, computed on the CPU by
# ``python3 chip_smoke.py --predict-population`` before any chip run (no
# tensor enters them).  A change to the runs' settings, the clock, the
# sampler, the cost model or the topology changes them: rerun that command
# and paste its last line
PREDICTED_POPULATION = {'sim': {'cohorts': [[0, 1, 2, 3, 4, 5, 10, 14, 17, 21, 22, 23],
                     [0, 1, 4, 5, 11, 14, 16, 17, 19, 21, 22, 23]],
         'stragglers': [[4, 6, 10, 12, 19, 23], [4, 9, 10, 11, 13, 15, 21, 23]],
         'edge_cells': [[3, 7, 8, 12, 13, 16, 19, 21, 22],
                        [0, 1, 4, 5, 6, 14, 20],
                        [2, 9, 10, 11, 15, 17, 18, 23]],
         'sim_times': [1.7041345350059656, 3.4356021557045713],
         'loss_event_keys': [[0.2055604183728335, 5, 0],
                             [0.24031443917771037, 17, 0],
                             [0.32024967765127355, 14, 0],
                             [0.32024967765127355, 1, 0],
                             [0.472507733890354, 0, 0],
                             [0.472507733890354, 22, 0],
                             [0.472507733890354, 3, 0],
                             [0.472507733890354, 21, 0],
                             [0.6133471590673655, 2, 0],
                             [0.6133471590673655, 4, 0],
                             [0.6133471590673655, 10, 0],
                             [0.6133471590673655, 23, 0],
                             [1.909694953378799, 5, 1],
                             [1.944448974183676, 17, 1],
                             [2.1005132407767793, 16, 1],
                             [2.1005132407767793, 14, 1],
                             [2.1005132407767793, 1, 1],
                             [2.1005132407767793, 19, 1],
                             [2.2109005726020667, 0, 1],
                             [2.2109005726020667, 22, 1],
                             [2.2109005726020667, 23, 1],
                             [2.283223390367584, 4, 1],
                             [2.283223390367584, 21, 1],
                             [2.317481694073331, 11, 1]],
         'chunk_sizes': [1, 1, 2, 4, 4, 1, 1, 4, 3, 2, 1],
         'launches': {'lora_matmul': 2272,
                      'grouped_lora_chunk': 1112,
                      'quantize_rows': 48}},
 'exact:sync': {'cohorts': [[2, 3, 5, 7, 9, 10, 11], [0, 1, 3, 5, 7, 10, 11]],
                'sim_times': [1.8993428936866188, 4.341557724928403],
                'loss_event_keys': [[0.5665616391080164, 2, 0],
                                    [0.6046261531677865, 3, 0],
                                    [0.6388844568735336, 11, 0],
                                    [0.6731427605792807, 5, 0],
                                    [0.7195102966393513, 10, 0],
                                    [0.7643084063950599, 7, 0],
                                    [0.80237292045483, 9, 0],
                                    [2.48587492978273, 3, 1],
                                    [2.520133233488477, 11, 1],
                                    [2.554391537194224, 5, 1],
                                    [2.6249274273602214, 1, 1],
                                    [2.701056455479762, 10, 1],
                                    [2.701056455479762, 7, 1],
                                    [2.8765304814959536, 0, 1]],
                'chunk_sizes': [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 1],
                'discarded': [],
                'launches': {'lora_matmul': 2678,
                             'grouped_lora_chunk': 96,
                             'quantize_rows': 0}},
 'exact:async': {'cohorts': [],
                 'sim_times': [1.7458058245903583, 2.374801065197937,
                               3.3596824424134493, 4.741518424439722],
                 'loss_event_keys': [[0.5665616391080164, 2, 0],
                                     [0.6426906672275566, 8, 0],
                                     [0.6426906672275566, 3, 0],
                                     [0.7112072746390509, 5, 0],
                                     [0.7112072746390509, 11, 0],
                                     [0.7873363027585911, 10, 0],
                                     [0.7873363027585911, 1, 0],
                                     [0.9091422656459475, 6, 0],
                                     [0.9091422656459475, 7, 0],
                                     [0.9091422656459475, 9, 0],
                                     [0.9434005693516946, 4, 0],
                                     [0.9852712937654877, 0, 0],
                                     [1.763854371140958, 2, 1],
                                     [1.8464876695379495, 3, 1],
                                     [1.8845521835977197, 8, 1],
                                     [1.993052801958756, 11, 1],
                                     [2.0559962363718496, 5, 1],
                                     [2.338892680905696, 10, 1],
                                     [2.471390358263961, 1, 1],
                                     [2.5132610826777544, 7, 1],
                                     [2.5513255967375246, 9, 1],
                                     [2.6085548237235936, 6, 1],
                                     [2.8308008311813095, 4, 1],
                                     [3.3519886530072722, 0, 1]],
                 'chunk_sizes': [1, 2, 2, 2, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                 1, 1, 1],
                 'discarded': [[2, 1], [3, 1], [8, 1], [11, 1], [5, 1], [10, 1],
                               [7, 1], [9, 1], [6, 1], [4, 1]],
                 'launches': {'lora_matmul': 4584,
                              'grouped_lora_chunk': 480,
                              'quantize_rows': 0}},
 'scale': {'cohorts': [[77, 275, 335, 941, 1139, 2189, 2717, 2769, 2837, 3179,
                        3425, 3587, 4397, 4973, 5649, 5747, 6605, 6761, 6803,
                        6839, 6983, 8027, 8117, 8339, 8405, 8637, 9101, 9839,
                        9862, 9929],
                       [734, 1019, 1943, 2123, 2717, 2879, 2933, 3179, 3269,
                        3587, 4133, 4175, 4367, 4805, 6839, 6893, 6944, 6983,
                        7001, 7071, 7967, 8291, 8405, 8423, 8925, 8975, 9101,
                        9327, 9923, 9987],
                       [77, 497, 1247, 1763, 1931, 2057, 2123, 2181, 3029, 3171,
                        3503, 3587, 4055, 4307, 4505, 4973, 5232, 5745, 6839,
                        6983, 7565, 8027, 8405, 8459, 8849, 8973, 9149, 9305,
                        9503, 9761]],
           'sim_times': [1.7511224220756532, 3.7464163380581454,
                         6.211425676102216],
           'loss_event_keys': [[0.489093259614815, 3587, 0],
                               [0.4891391356941319, 6983, 0],
                               [0.4893517995140226, 8405, 0],
                               [0.4895819530472367, 9929, 0],
                               [0.7631596892607919, 6605, 0],
                               [0.7631596892607919, 335, 0],
                               [0.7631596892607919, 2717, 0],
                               [0.7631596892607919, 8117, 0],
                               [0.7631596892607919, 8339, 0],
                               [0.7631596892607919, 6803, 0],
                               [0.7631596892607919, 1139, 0],
                               [0.7631596892607919, 4973, 0],
                               [0.7632055653401089, 9839, 0],
                               [0.7632055653401089, 9101, 0],
                               [0.7632055653401089, 275, 0],
                               [0.7632055653401089, 4397, 0],
                               [0.7632055653401089, 2837, 0],
                               [0.7632055653401089, 8027, 0],
                               [0.7632055653401089, 3425, 0],
                               [0.7632055653401089, 3179, 0],
                               [0.6682557387508041, 77, 0],
                               [0.6682557387508041, 6761, 0],
                               [0.6682557387508041, 6839, 0],
                               [0.6682557387508041, 8637, 0],
                               [0.6682557387508041, 2769, 0],
                               [0.5374411956665796, 5747, 0],
                               [0.5716994993723267, 941, 0],
                               [0.6439743112906643, 2189, 0],
                               [0.6782326149964114, 9862, 0],
                               [0.7210914994777161, 5649, 0],
                               [2.240215681690468, 3587, 1],
                               [2.2402615577697853, 6983, 1],
                               [2.240474221589676, 8405, 1],
                               [2.240685685493507, 2123, 1],
                               [2.518088321690468, 734, 1],
                               [2.518088321690468, 6893, 1],
                               [2.518088321690468, 2717, 1],
                               [2.518088321690468, 4175, 1],
                               [2.518088321690468, 8423, 1],
                               [2.518088321690468, 9923, 1],
                               [2.518088321690468, 2933, 1],
                               [2.518088321690468, 8291, 1],
                               [2.445811380004268, 7001, 1],
                               [2.445811380004268, 9101, 1],
                               [2.445811380004268, 2879, 1],
                               [2.445811380004268, 3179, 1],
                               [2.445811380004268, 6839, 1],
                               [2.445811380004268, 4367, 1],
                               [2.2808366753088283, 8925, 1],
                               [2.2807109800098044, 4133, 1],
                               [2.387292101481069, 6944, 1],
                               [2.387292101481069, 4805, 1],
                               [2.387292101481069, 7967, 1],
                               [2.3190436797929084, 1943, 1],
                               [2.3533019834986555, 1019, 1],
                               [2.3875602872044026, 3269, 1],
                               [2.459614919246586, 8975, 1],
                               [2.459614919246586, 9987, 1],
                               [2.4593523575718605, 9327, 1],
                               [2.5886400659977076, 7071, 1],
                               [4.233799632349997, 2181, 2],
                               [4.234539141648591, 8973, 2],
                               [4.23550959767296, 3587, 2],
                               [4.235555473752277, 6983, 2],
                               [4.507866061995974, 9761, 2],
                               [4.507866061995974, 1931, 2],
                               [4.507866061995974, 8849, 2],
                               [4.507866061995974, 3503, 2],
                               [4.507866061995974, 4973, 2],
                               [4.507866061995974, 3029, 2],
                               [4.507866061995974, 7565, 2],
                               [4.507866061995974, 1247, 2],
                               [4.516217992002614, 497, 2],
                               [4.516217992002614, 8027, 2],
                               [4.516217992002614, 77, 2],
                               [4.516217992002614, 6839, 2],
                               [4.516217992002614, 2123, 2],
                               [4.516217992002614, 8405, 2],
                               [4.516217992002614, 3171, 2],
                               [4.516217992002614, 5745, 2],
                               [4.274379359353603, 9503, 2],
                               [4.294507107839108, 9305, 2],
                               [4.313352997233875, 9149, 2],
                               [4.328765411544855, 1763, 2],
                               [4.347611300939622, 4307, 2],
                               [4.431540322662096, 4505, 2],
                               [4.431540322662096, 4055, 2],
                               [4.431540322662096, 8459, 2],
                               [4.381869604645369, 2057, 2],
                               [4.733789392955503, 5232, 2]],
           'chunk_sizes': [1, 1, 1, 1, 8, 8, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 8, 6,
                           1, 1, 3, 1, 1, 1, 2, 1, 1, 1, 1, 1, 1, 8, 8, 1, 1, 1,
                           1, 1, 3, 1, 1],
           'launches': {'lora_matmul': 5602,
                        'grouped_lora_chunk': 1120,
                        'quantize_rows': 0}}}


def population_phase(train, test) -> dict:
    """[population]: the sim run fused and einsum (losses within
    LOSS_RTOL, timelines equal), the exact runs (trainer against Simulator
    bit for bit), the scale run; every run's timeline and launches against
    PREDICTED_POPULATION."""
    t0 = time.perf_counter()
    runs = population_runs(REGISTRY["bert-base"], train, test, "cuda", einsum=True)
    fused, plain = runs["sim"], runs["sim:einsum"]
    if plain["timeline"] != fused["timeline"]:
        raise AssertionError("population:sim: the einsum run's timeline differs")
    gaps = [abs(a - b) / abs(b) for a, b in zip(fused["losses"], plain["losses"])]
    if not max(gaps) <= LOSS_RTOL:
        raise AssertionError(f"population:sim: fused and einsum losses apart by {max(gaps)}")
    if any(plain["launches"][k] for k in ("lora_matmul", "grouped_lora_chunk")):
        raise AssertionError("population:sim: the einsum run launched a LoRA kernel")
    out = {}
    for key in (*POP_KEYS, "sim:einsum"):
        run = runs[key]
        tl = run["timeline"]
        want = PREDICTED_POPULATION[key.split(":einsum")[0]]
        got = {k: tl[k] for k in want}
        if got != want:
            bad = [k for k in want if got[k] != want[k]]
            raise AssertionError(f"population:{key}: {bad} differ from PREDICTED_POPULATION")
        counts = run["launches"]
        expect = dict(tl["launches"])
        if key == "sim:einsum":
            expect.update(lora_matmul=0, grouped_lora_chunk=0)
        if {k: counts[k] for k in expect} != expect or \
                any(v for k, v in counts.items() if k not in expect):
            raise AssertionError(f"population:{key}: launches {counts}, expected {expect}")
        out[key] = {k: v for k, v in run.items() if k not in ("timeline", "losses")}
        out[key].update(n_loss_events=len(tl["loss_event_keys"]), sim_times=tl["sim_times"],
                        loss_range=[min(run["losses"]), max(run["losses"])])
        print(f"[population:{key}] {gpu_line()} {json.dumps(out[key])}", flush=True)
    out["sim"]["fused_vs_einsum_max_rel_gap"] = max(gaps)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[population] phase_s={out['phase_s']:.1f} "
          f"sim fused_vs_einsum_max_rel_gap={max(gaps):.3e} "
          f"scale wall_s={runs['scale']['wall_s']:.3f} "
          f"max_mem_bytes={runs['scale']['max_mem_bytes']} "
          f"resident_bytes={runs['scale']['resident_bytes']}", flush=True)
    return out


def population_launches(population: dict, name: str) -> dict:
    """A kernel's launches in each run of the [population] phase."""
    return {key: run["launches"][name] for key, run in population.items()
            if isinstance(run, dict)}


def vmap_phase(train, test, ragged: dict) -> dict:
    """The cohort path on the vmap cohort step (all six clients in one
    masked dispatch a round), fused and einsum: launches by
    ``expected_cohort_launches(impl="vmap")`` (asserted in ``run_path``),
    the fused run's losses against the einsum run's, and each run's losses
    against the ragged run of the same kernel setting within LOSS_RTOL,
    simulated times equal; wall time and peak memory beside the ragged
    run's (vmap keeps every lane's activations of all L layers)."""
    runs = {"fused": run_path(True, train, test, cohort=True, impl="vmap"),
            "einsum": run_path(False, train, test, cohort=True, impl="vmap")}
    compare_paths(runs["fused"], runs["einsum"], "vmap")
    out = {}
    for label, run in runs.items():
        rows = []
        for rv, rr in zip(run["rows"], ragged[label]["rows"]):
            gap = abs(rv["loss"] - rr["loss"]) / abs(rr["loss"])
            rows.append({"round": rv["round"], "vmap_loss": rv["loss"],
                         "ragged_loss": rr["loss"], "rel_gap": gap,
                         "vmap_wall_s": rv["wall_s"], "ragged_wall_s": rr["wall_s"],
                         "vmap_max_mem_bytes": rv["max_mem_bytes"],
                         "ragged_max_mem_bytes": rr["max_mem_bytes"]})
            if not gap <= LOSS_RTOL:
                raise AssertionError(f"vmap {label}: round {rv['round']} loss "
                                     f"{rv['loss']} against ragged {rr['loss']}")
            if rv["sim_time_s"] != rr["sim_time_s"]:
                raise AssertionError(f"vmap {label}: simulated time differs from ragged")
        out[label] = {"rounds": rows, "launches": run["launches"],
                      "ragged_launches": ragged[label]["launches"]}
        print(f"[vmap:{label}] {json.dumps(out[label])}", flush=True)
    if out["einsum"]["launches"]["grouped_lora_chunk"] or \
            out["einsum"]["launches"]["lora_matmul"]:
        raise AssertionError("vmap einsum launched a LoRA kernel")
    return out


def lm_train_model(arch: str, seed: int):
    """An LM at full width, LM_TRAIN_LAYERS deep (the encoder-decoder: that
    many encoder and decoder layers), bf16, fused LoRA, random weights and
    adapters (every leaf ~ N(0, 0.05)), and a maker of batches of
    LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens (the encoder-decoder's with
    ``encoder_seq`` random frames a sequence)."""
    layers = LM_TRAIN_LAYERS[arch]
    base = REGISTRY[arch].with_(n_layers=layers, attn_impl="chunked", wkv_impl="chunked")
    if base.family == "encdec":
        base = base.with_(n_encoder_layers=layers)
    cfg = base.with_(lora=dataclasses.replace(base.lora, impl="fused"))
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_params(gen)
    lora = model.init_lora(gen)
    for leaf in _leaves(lora):
        leaf.normal_(0.0, 0.05, generator=gen)
    rs = np.random.default_rng(seed)

    def batch():
        out = {key: torch.from_numpy(rs.integers(0, cfg.vocab_size,
                                                 (LM_TRAIN_BATCH, LM_TRAIN_SEQ))
                                     .astype(np.int32)).cuda()
               for key in ("tokens", "targets")}
        if cfg.family == "encdec":
            out["frames"] = torch.from_numpy(rs.standard_normal(
                (LM_TRAIN_BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(
                torch_dtype(cfg.dtype)).cuda()
        return out

    return model, params, lora, batch


def counted(fn, profile: bool = False):
    """One call of ``fn``: its result, wall s (host clock to a synchronize),
    peak bytes and the launches of every kernel in it; with ``profile``,
    the device s of a second call under the profiler (its launches not
    counted)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                  # just before the path runs
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    row = {"wall_s": time.perf_counter() - t0,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": read_counts()}               # just after
    if profile:
        row["device_s"] = device_time(fn, top=1)[0]
    return out, row


def _server_part(lora, cut: int):
    _, s_part = lora_lib.split_lora(lora, cut)
    return lora_lib.embed_in_full_shape(s_part, lora, cut, "server")


def _client_part(params, lora, cut: int):
    pc = dict(params)
    key = "enc_layers" if "enc_layers" in params else "layers"
    pc[key] = lora_lib.slice_stack(params[key], 0, cut)
    return pc, lora_lib.split_lora(lora, cut)[0]


def adapter_pairs(tree) -> int:
    """The {a, b} pairs of a LoRA tree, stacked or not, each once."""
    if "a" in tree and not isinstance(tree["a"], dict):
        return 1
    return sum(adapter_pairs(v) for v in tree.values() if isinstance(v, dict))


def owned_projections(model, lora, side: str, cut: int) -> tuple:
    """The adapted projections a forward on ``side`` of ``cut`` applies, read
    from the LoRA tree, and how many of them are f32 (the MoE router's,
    ``router_projections`` a layer): each stack's pairs a layer times the
    layers of it the side owns (the client those below the cut, the server
    the rest, "full" all); a server-only tree (``SERVER_ONLY_KEYS``: the
    decoder's layers, the hybrid's shared block) none on the client, whose
    shared blocks run without an adapter; the shared block's once after
    each segment whose last layer the side owns."""
    cfg = model.cfg

    def owned(layers):
        return sum(side == "full" or (i < cut if side == "client" else i >= cut)
                   for i in layers)

    apps = {"layers": owned(range(cfg.n_layers)),
            "enc_layers": owned(range(cfg.n_encoder_layers)),
            "dec_layers": cfg.n_layers,
            "shared": owned(model._segment_ends()) if "shared" in lora else 0}
    n = sum(adapter_pairs(tree) * apps[key] for key, tree in lora.items()
            if not (side == "client" and key in lora_lib.SERVER_ONLY_KEYS))
    return n, router_projections(cfg) * apps["layers"]


def _named_pairs(a, b, name: str = ""):
    """The leaves of two trees side by side, matched by key path (a tree
    whose keys differ raises)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"trees differ at {name or '/'}: {sorted(a)} against "
                                 f"{sorted(b)}")
        for key in a:
            yield from _named_pairs(a[key], b[key], f"{name}/{key}")
    else:
        yield name.lstrip("/"), a, b


def _bits(a, b) -> bool:
    return all(torch.equal(x, y) for _, x, y in _named_pairs(a, b))


def _max_abs(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max()) for _, x, y in _named_pairs(a, b))


def rel2(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| in the 2-norm over the whole tensor (0 where
    both are zero)."""
    num = float(torch.linalg.vector_norm(got.double() - want.double()))
    den = float(torch.linalg.vector_norm(want.double()))
    return num / den if den else (0.0 if num == 0.0 else math.inf)


def _worst_rel2(a, b) -> tuple:
    """The worst leaf's ``rel2`` of two trees, matched by key path, and its
    path."""
    return max((rel2(x, y), name) for name, x, y in _named_pairs(a, b))


def lm_train(arch: str, seed: int) -> dict:
    """LM split training at full width (gemma-2b at its full depth, rwkv6-3b
    and qwen3-moe-30b-a3b at LM_TRAIN_LAYERS), bf16, fused LoRA (bf16
    lora_matmul forward and dx; the MoE router's adapter fp32; the grouped
    kernel for 3-D adapters), a mid cut:

    1. the LM server step on the sliced path against the scan path (the
       cut a 0-d tensor on the card, so every layer runs masked) on the
       same inputs: loss, dv, the new adapters and the optimizer's first
       moment bit for bit; for the MoE family, whose scan path adds the
       router's aux loss and the sliced path does not, the logits bit for
       bit and the scan loss equal to the sliced loss plus the aux, bit for
       bit (the steps run for their launches);
    2. LM_TRAIN_STEPS split steps (client forward, server step, client
       backward) on one repeated batch: the loss falls;
    3. ``make_full_train_step`` with remat off and on, two steps each from
       the same state: bit for bit;
    4. ``make_server_step_batched`` over three lanes at LM_TRAIN_LANE_CUTS:
       vmap and ragged against the three sequential steps, lane by lane
       (``lane_readings``: losses within LM_GRAD_LOSS_RTOL; dv and each
       adapter leaf's gradient within LM_GRAD_TOL in the relative 2-norm,
       the gradient read from the returned optimizer state, whose step-1
       first moment is (1 - b1) g; adapters within 2 lr, all a step-1
       update can move).  For the MoE family the sequential steps are scan
       steps at a 0-d cut (each lane its own dispatch and aux, as a vmap
       lane has) for the vmap lanes, and sliced steps for the ragged lanes:
       the ragged step reports no aux (the reference's), nor does a sliced
       step.  The hybrid's lanes' dv and
       gradients are held in fp32 instead (``hybrid_fp32_lanes``, within
       HYBRID_FP32_LANE_TOL);

    each call's launches asserted (``owned_projections``, read from the
    LoRA tree: P of a forward over the whole model, P_s of the server's at
    cut c, P_c of the client's, whose shared blocks carry no adapter; R of
    each the f32 router's; F_c and F_s frozen-input ones, ``FROZEN_INPUT``):
    sliced server step 2 P_s - F_s, scan 2 P, split step 2 (P_c + P_s) -
    F_c - F_s, full step 2 P - F_c - F_s and with remat 3 P - F_c - F_s
    (each layer's forward again in the backward), vmap 2 P grouped, ragged
    2 P_s grouped per cut; the R ones on fp32 tiles and the router's
    grouped dx call (K = E <= 128) in direct mode; every bf16 launch on the
    wgmma tile), and each call's wall s, peak bytes and (for the main
    calls) device s printed.  The hybrid's sliced and scan steps run at
    every cut of ``LM_TRAIN_CUTS``; the encoder-decoder runs 1-3 at its cut
    (its encoder has one path)."""
    from repro_torch.core import splitfl
    from repro_torch.optim import AdamW

    model, params, lora, new_batch = lm_train_model(arch, seed)
    cfg = model.cfg
    moe = cfg.family == "moe"
    nl = cfg.n_layers
    opt = AdamW(LR)
    batch = new_batch()
    rows, launches, checks = {}, {}, {}
    frozen = FROZEN_INPUT[cfg.family]

    def proj(side, c=0, times=1):
        n, n32 = owned_projections(model, lora, side, c)
        return times * n, times * n32

    def lm(fwd, dx, frozen_=0):
        """lora_matmul launches: a forward and a dx over (all, f32)
        projection applications, less the frozen-input dx calls."""
        bf16 = fwd[0] - fwd[1] + dx[0] - dx[1] - frozen_
        return no_launches(lora_matmul=bf16 + fwd[1] + dx[1], lora_matmul_bf16=bf16,
                           lora_matmul_wgmma=bf16)

    def gl(apps, frozen_=0):
        """grouped launches of a forward and a dx over (all, f32) projection
        applications, less the frozen-input dx calls: the router's dx call
        (K = E <= 128) in direct mode."""
        bf16 = 2 * (apps[0] - apps[1]) - frozen_
        direct = apps[1] if cfg.moe is not None and cfg.moe.num_experts <= 128 else 0
        return no_launches(grouped_lora_chunk=bf16 + 2 * apps[1] - direct,
                           grouped_lora_chunk_bf16=bf16, grouped_lora_chunk_wgmma=bf16,
                           grouped_lora_direct=direct)

    def total(*apps):
        return tuple(map(sum, zip(*apps)))

    # the flash kernel pair, where the attention is in its domain under a
    # gradient (bf16 at a head dim the backward has: whisper-large-v3's
    # encoder, "chunked", and its decoder's self- and cross-attention,
    # "naive"): a forward launch per attention a pass makes, the backward's
    # two kernels per attention differentiated
    pair = cfg.dtype == "bfloat16" and cfg.head_dim in BWD_HEAD_DIMS and cfg.family != "ssm"
    if pair and cfg.family != "encdec":
        raise AssertionError(f"{arch}: no rule for the flash pair's launches in "
                             f"family {cfg.family}")

    def attn(side, c=0):
        """attention calls of a pass over a side at cut c (encoder layers
        held by the client) in the pair's domain"""
        if not pair:
            return 0
        enc, dec = cfg.n_encoder_layers, 2 * cfg.n_layers
        return {"client": c, "server": enc - c + dec, "full": enc + dec}[side]

    def fl(counts, fwd, diffed):
        return {**counts, "flash_attention": fwd, "flash_attention_bwd": 2 * diffed}

    def split(c):   # the client's forward and dx, and the server step
        both = total(proj("client", c), proj("server", c))
        return fl(lm(both, both, frozen["client"] + frozen["server"]), attn("full"),
                  attn("full"))

    want = {"server_sliced": lambda c: fl(lm(proj("server", c), proj("server", c),
                                             frozen["server"]),
                                          attn("server", c), attn("server", c)),
            "server_scan": lambda c: lm(proj("full"), proj("full")),
            "split": split,
            # remat: each layer's forward again in the backward
            "full": lambda remat: fl(lm(proj("full", times=2 if remat else 1), proj("full"),
                                        frozen["client"] + frozen["server"]),
                                     attn("full") * (2 if remat else 1), attn("full")),
            "vmap": lambda cuts: gl(proj("full")),
            "ragged": lambda cuts: gl(total(*(proj("server", c_) for c_ in set(cuts))),
                                      len(set(cuts)) * frozen["server"]),
            # the MoE family's sequential steps are scan steps (each lane its
            # own dispatch and aux)
            "sequential": lambda cuts: (
                lm(proj("full", times=len(cuts)), proj("full", times=len(cuts))) if moe else
                lm(total(*(proj("server", c_) for c_ in cuts)),
                   total(*(proj("server", c_) for c_ in cuts)),
                   len(cuts) * frozen["server"]))}
    cuts_here = LM_TRAIN_CUTS.get(arch, (nl // 2,))
    cut = cuts_here[0]
    # the encoder-decoder has one path (the reference's encoder is one masked
    # scan) and no cohort step here
    has_scan = cfg.family != "encdec"

    def record(name, row, want):
        rows[name] = {k: v for k, v in row.items() if k != "launches"}
        launches[name] = row["launches"]
        if row["launches"] != want:
            raise AssertionError(f"{arch} {name}: launches {row['launches']}, "
                                 f"expected {want}")

    # 1. sliced against scan, at each cut (the first one's steps timed)
    scan_step = splitfl.make_server_step(model, opt, path="scan")
    for c_ in cuts_here[1:] if has_scan else ():
        pc_, lc_ = _client_part(params, lora, c_)
        with torch.no_grad():
            v_ = splitfl.client_forward(model, pc_, lc_, batch, c_)
        ls_ = _server_part(lora, c_)
        a_, row = counted(lambda: splitfl.make_server_step(model, opt, static_cut=c_)(
            params, ls_, opt.init(ls_), v_, batch))
        record(f"server_step_sliced_cut_{c_}", row, want["server_sliced"](c_))
        b_, row = counted(lambda: scan_step(params, ls_, opt.init(ls_), v_, batch,
                                            torch.tensor(c_, device=v_.device)))
        record(f"server_step_scan_cut_{c_}", row, want["server_scan"](c_))
        checks[f"sliced_vs_scan_cut_{c_}"] = {"bit_equal": {
            "loss": bool(torch.equal(a_[0], b_[0])), "dv": bool(torch.equal(a_[3], b_[3])),
            "adapters": _bits(a_[1], b_[1]), "first_moment": _bits(a_[2].mu, b_[2].mu)}}
        if not all(checks[f"sliced_vs_scan_cut_{c_}"]["bit_equal"].values()):
            raise AssertionError(f"{arch}: sliced and scan server steps differ at cut {c_}: "
                                 f"{checks[f'sliced_vs_scan_cut_{c_}']}")
        del a_, b_, v_
    pc, lc = _client_part(params, lora, cut)
    fwd, bwd = splitfl.make_client_step(model, opt, cut)
    v, tape = fwd(pc, lc, batch)
    ls = _server_part(lora, cut)
    sliced_step = splitfl.make_server_step(model, opt, static_cut=cut)
    a, row = counted(lambda: sliced_step(params, ls, opt.init(ls), v, batch), profile=True)
    record("server_step_sliced", row, want["server_sliced"](cut))
    cut_t = torch.tensor(cut, device=v.device)
    if has_scan:
        b, row = counted(lambda: scan_step(params, ls, opt.init(ls), v, batch, cut_t),
                         profile=True)
        record("server_step_scan", row, want["server_scan"](cut))
    if not has_scan:
        checks["server_step"] = {"loss": float(a[0]), "dv_finite": bool(
            torch.isfinite(a[3].float()).all())}
        if not checks["server_step"]["dv_finite"] or not math.isfinite(float(a[0])):
            raise AssertionError(f"{arch}: the server step is not finite: "
                                 f"{checks['server_step']}")
    elif moe:
        with torch.no_grad():
            la, ga = model.loss(params, ls, batch, cut=cut, side="server", x0=v)
            lb, gb = model.loss(params, ls, batch, cut=cut_t, side="server", x0=v,
                                path="scan")
            _, aux = model.forward_hidden(params, ls, batch, cut=cut_t, side="server",
                                          x0=v, path="scan")
        checks["sliced_vs_scan"] = {
            "bit_equal": {"logits": bool(torch.equal(ga, gb)),
                          "loss_is_sliced_plus_aux": bool(torch.equal(lb, la + aux))},
            "aux": float(aux), "step_losses": [float(a[0]), float(b[0])],
            "dv_rel2": rel2(b[3], a[3])}
    else:
        checks["sliced_vs_scan"] = {
            "bit_equal": {"loss": bool(torch.equal(a[0], b[0])),
                          "dv": bool(torch.equal(a[3], b[3])), "adapters": _bits(a[1], b[1]),
                          "first_moment": _bits(a[2].mu, b[2].mu)}}
    if has_scan and not all(checks["sliced_vs_scan"]["bit_equal"].values()):
        raise AssertionError(f"{arch}: sliced and scan server steps differ: "
                             f"{checks['sliced_vs_scan']}")
    del a, tape
    if has_scan:
        del b

    # 2. split steps on one repeated batch
    state = {"ls": _server_part(lora, cut), "lc": lc}
    state["so"], state["co"] = opt.init(state["ls"]), opt.init(lc)
    losses = []

    def split_step():
        v, tape = fwd(pc, state["lc"], batch)
        loss, state["ls"], state["so"], dv = sliced_step(params, state["ls"], state["so"],
                                                         v, batch)
        state["lc"], state["co"] = bwd(tape, state["co"], dv)
        return loss

    for i in range(LM_TRAIN_STEPS):
        loss, row = counted(split_step)
        record(f"split_step_{i}", row, want["split"](cut))
        losses.append(float(loss))
    checks["split_losses"] = losses
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{arch}: split-training loss did not fall: {losses}")
    del state

    # 3. the full step, remat off and on, from the same state
    full = {}
    for remat in (False, True):
        step = splitfl.make_full_train_step(model, opt, remat=remat)
        carry = {"lora": lora, "opt": opt.init(lora)}
        seq = []

        def full_step():
            loss, carry["lora"], carry["opt"] = step(params, carry["lora"], carry["opt"],
                                                     batch)
            return loss

        for i in range(2):
            loss, row = counted(full_step)
            record(f"full_step_remat_{remat}_{i}", row, want["full"](remat))
            seq.append(loss)
        full[remat] = (seq, carry["lora"])
    # device time of one full step at each setting (not counted)
    for remat in (False, True):
        step = splitfl.make_full_train_step(model, opt, remat=remat)
        rows[f"full_step_remat_{remat}_0"]["device_s"] = device_time(
            lambda: step(params, lora, opt.init(lora), batch), top=1)[0]
    checks["full_step"] = {
        "losses": {str(k): [float(x) for x in v[0]] for k, v in full.items()},
        "bit_equal": (all(torch.equal(x, y) for x, y in zip(full[False][0], full[True][0]))
                      and _bits(full[False][1], full[True][1]))}
    if not checks["full_step"]["bit_equal"]:
        raise AssertionError(f"{arch}: the full step with and without remat is not "
                             f"bit for bit: {checks['full_step']}")
    del full
    if not has_scan:
        out = {"arch": arch, "layers": nl, "encoder_layers": cfg.n_encoder_layers,
               "cut": cut, "batch": [LM_TRAIN_BATCH, LM_TRAIN_SEQ],
               "frames": cfg.encoder_seq, "projections": proj("full")[0],
               "frozen_input": frozen, "steps": rows, "launches": launches,
               "checks": checks}
        print(f"[lm-train:{arch}] {json.dumps(out)}", flush=True)
        del model, params, lora
        gc.collect()
        torch.cuda.empty_cache()
        return out

    # 4. the LM cohort step over three lanes at three cuts
    cuts = LM_TRAIN_LANE_CUTS[arch]
    lanes = []
    for c_ in cuts:
        pc_, lc_ = _client_part(params, lora, c_)
        b_ = new_batch()
        with torch.no_grad():
            v_ = splitfl.client_forward(model, pc_, lc_, b_, c_)
        lanes.append((v_, b_, _server_part(lora, c_)))
    stacked = (lora_lib.stack_trees([ls_ for _, _, ls_ in lanes]),
               lora_lib.stack_trees([opt.init(ls_) for _, _, ls_ in lanes]),
               torch.stack([v_ for v_, _, _ in lanes]),
               lora_lib.stack_trees([b_ for _, b_, _ in lanes]))
    outs = {}
    for impl in ("vmap", "ragged"):
        step = splitfl.make_server_step_batched(model, opt, impl=impl)
        outs[impl], row = counted(lambda: step(params, *stacked, list(cuts)), profile=True)
        record(f"batched_{impl}", row, want[impl](cuts))

    def sliced_steps():
        return [splitfl.make_server_step(model, opt, static_cut=c_)(
            params, ls_, opt.init(ls_), v_, b_) for c_, (v_, b_, ls_) in zip(cuts, lanes)]

    def sequential():
        if moe:   # each lane alone on the scan path: its own dispatch and aux
            return [splitfl.make_server_step(model, opt, path="scan")(
                params, ls_, opt.init(ls_), v_, b_, torch.tensor(c_, device=v_.device))
                for c_, (v_, b_, ls_) in zip(cuts, lanes)]
        return sliced_steps()

    seq, row = counted(sequential, profile=True)
    record("sequential_steps", row, want["sequential"](cuts))
    # the ragged step reports no aux (the reference's), nor does a sliced
    # step: the MoE family's ragged lanes are held against sliced steps
    seqs = {"vmap": seq, "ragged": sliced_steps() if moe else seq}
    hybrid = cfg.family == "hybrid"
    fp32 = hybrid_fp32_lanes(model, opt, params, cuts, lanes, stacked) if hybrid else None
    lanes_out, failed = [], []
    for i in range(len(cuts)):
        lane = {}
        for impl, out in outs.items():
            lane[impl] = r = lane_readings(out, seqs[impl], i)
            ok = r["loss_rel"] <= LM_GRAD_LOSS_RTOL and r["adapter_max_abs"] <= 2 * LR
            if hybrid:      # dv and gradients held in fp32 (hybrid_fp32_lanes)
                r["fp32"] = r32 = lane_readings(fp32[impl], fp32["sequential"], i)
                ok = ok and max(r32["dv_rel2"], r32["grad_rel2"]) <= HYBRID_FP32_LANE_TOL
            else:
                ok = ok and max(r["dv_rel2"], r["grad_rel2"]) <= LM_GRAD_TOL
            if not ok:
                failed.append(f"{impl}, lane {i} (cut {cuts[i]}): {r}")
        lanes_out.append(lane)
    checks["batched_vs_sequential"] = {
        "cuts": list(cuts), "lanes": lanes_out,
        "sequential_path": {"vmap": "scan", "ragged": "sliced"} if moe else "sliced",
        "grad_tolerance": LM_GRAD_TOL,
        "fp32_tolerance": HYBRID_FP32_LANE_TOL if hybrid else None}
    if failed:
        print(f"[lm-train:{arch}] lanes {json.dumps(checks['batched_vs_sequential'])}",
              flush=True)
        raise AssertionError(f"{arch} batched steps against their sequential steps: "
                             f"{failed}")
    out = {"arch": arch, "layers": nl, "cut": cut, "batch": [LM_TRAIN_BATCH, LM_TRAIN_SEQ],
           "projections": proj("full")[0], "f32_projections": proj("full")[1],
           "frozen_input": frozen, "steps": rows, "launches": launches, "checks": checks}
    print(f"[lm-train:{arch}] {json.dumps(out)}", flush=True)
    del model, params, lora, outs, seq, seqs, lanes, stacked, fp32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lane_readings(out, seq, i: int) -> dict:
    """Lane ``i`` of a cohort step's ``out`` against its sequential step
    ``seq[i]``: the loss (relative), dv and the worst adapter leaf's
    gradient (the relative 2-norm; the gradient read from the first moment,
    (1 - b1) g after one step; leaves matched by name) and the adapters
    after the update (max abs)."""
    grad, leaf = _worst_rel2(lora_lib.unstack_tree(out[2].mu)[i], seq[i][2].mu)
    return {"loss_rel": abs(float(out[0][i]) - float(seq[i][0])) / abs(float(seq[i][0])),
            "dv_rel2": rel2(out[3][i], seq[i][3]), "grad_rel2": grad,
            "grad_worst_leaf": leaf,
            "adapter_max_abs": _max_abs(lora_lib.unstack_tree(out[1])[i], seq[i][1])}


def hybrid_fp32_lanes(model, opt, params, cuts, lanes, stacked) -> dict:
    """The hybrid's cohort steps again in fp32 (plain: einsum LoRA, the plain
    chunked attention and SSD) on the bf16-valued weights, adapters,
    activations and batches upcast: the vmap and the ragged step over the
    three lanes, and each lane's sequential (sliced) step.  Their lanes'
    dv and gradients are held against the sequential steps' (the bf16 run
    gives the launches and times): in bf16 the plain SSD's backward carries
    a rounding of its inputs through exp(dt * A) over the whole sequence, so
    at random weights two bf16 paths that round at other points (one lane
    alone, or three concatenated) part by up to 5.4 % on the H100 (PERF.md),
    while a wrong backward is O(1)."""
    from repro_torch.core import splitfl

    cfg32 = model.cfg.with_(dtype="float32",
                            lora=dataclasses.replace(model.cfg.lora, impl="einsum"))
    model32 = build_model(cfg32)
    up = lambda t: tree_map(lambda a: a.float() if a.is_floating_point() else a, t)  # noqa: E731
    params32 = up(params)
    lora_s, v_s, batch_s = up(stacked[0]), stacked[2].float(), stacked[3]
    opt_s = lora_lib.stack_trees([opt.init(lo) for lo in lora_lib.unstack_tree(lora_s)])
    out = {impl: splitfl.make_server_step_batched(model32, opt, impl=impl)(
        params32, lora_s, opt_s, v_s, batch_s, list(cuts)) for impl in ("vmap", "ragged")}
    out["sequential"] = [splitfl.make_server_step(model32, opt, static_cut=c_)(
        params32, up(ls_), opt.init(up(ls_)), v_.float(), b_)
        for c_, (v_, b_, ls_) in zip(cuts, lanes)]
    del params32
    torch.cuda.empty_cache()
    return out


def lm_train_launches(run: dict, name: str) -> dict:
    """One counter's launches in each call of an [lm-train] run."""
    return {step: counts[name] for step, counts in run["launches"].items()}


def import_seconds(stderr: str) -> float:
    """The seconds a process spent importing: the cumulative times of the
    outermost imports that ``-X importtime`` printed, lazy ones included
    (nested imports are indented under the one that asked for them)."""
    total = 0
    for line in stderr.splitlines():
        parts = line.split("|")
        if (line.startswith("import time:") and len(parts) == 3
                and parts[1].strip().isdigit() and not parts[2].startswith("  ")):
            total += int(parts[1])
    return total / 1e6


def run_launch_module(module: str, args, timeout: int = 600):
    """``python -m repro_torch.launch.<module> *args`` in a process of its
    own, under ``-X importtime``, its output printed under ``[launch]``:
    (its stdout lines, wall s, import s).  A non-zero exit raises."""
    env = dict(os.environ, PYTHONPATH=str(PORT_ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m",
                           f"repro_torch.launch.{module}", *args],
                          cwd=PORT_ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for line in lines:
        print(f"[launch] {line}", flush=True)
    if proc.returncode != 0:
        tail = "\n".join(ln for ln in proc.stderr.splitlines()
                         if not ln.startswith("import time:"))
        raise AssertionError(f"launch/{module}.py exited {proc.returncode}: {tail[-2000:]}")
    return lines, wall, import_seconds(proc.stderr)


def prefill_flops(cfg, b: int, t: int, square: bool = False) -> float:
    """The analytic FLOPs of a decoder LM's prefill of b x t tokens through
    flash (tied embeddings, dense blocks): 2*b*t*(P - V*d) for every weight
    matrix once a token (P the parameter count; the tied table is gathered,
    not multiplied; norms are within rounding), 2*b*d*V for the head on the
    last token alone, and 4*b*L*H*D * t(t+1)/2 for Q K^T and P V over the
    causal pairs the kernel computes; with ``square``, over all t*t pairs,
    as the plain version forms them."""
    body = cfg.param_count() - cfg.vocab_size * cfg.d_model
    pairs = t * t if square else t * (t + 1) // 2
    attn = 4 * b * cfg.n_layers * cfg.n_heads * cfg.head_dim * pairs
    return 2.0 * b * t * body + 2.0 * b * cfg.d_model * cfg.vocab_size + attn


def flash_rows_plain(q_rows, k, v, q0: int) -> torch.Tensor:
    """The plain version's arithmetic (``ref.flash_attention_ref``: f32
    scores, -1e30 past the causal mask, one softmax, bf16 probabilities
    times v) for query rows at positions q0.. against every key."""
    b, r, h, d = q_rows.shape
    t, g = k.shape[1], h // k.shape[2]
    qf = q_rows.float().movedim(2, 1)
    kf = k.float().repeat_interleave(g, dim=2).movedim(2, 1)
    scores = qf @ kf.transpose(-1, -2) / math.sqrt(d)
    dev = q_rows.device
    mask = (q0 + torch.arange(r, device=dev))[:, None] >= torch.arange(t, device=dev)[None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = probs.to(v.dtype) @ v.repeat_interleave(g, dim=2).movedim(2, 1)
    return out.movedim(1, 2).to(q_rows.dtype)


def check_flash_long(seed: int) -> dict:
    """Flash at gemma-2b's prefill_32k attention (FLASH_LONG, bf16, causal):
    its last FLASH_HOLD_ROWS query rows held per row against the plain
    version's arithmetic over all 32768 keys; the kernel timed, beside its
    bound and PyTorch's scaled_dot_product_attention (the yardstick, on
    the kv head repeated; the port never calls it).  The plain version is
    not timed here: its 1 x 8 x 32768 x 32768 f32 scores are 34 GB."""
    b, s, h, kh, d = FLASH_LONG
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(b, s, kh, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, s, kh, d, generator=gen, device=dev).to(torch.bfloat16)
    out = flash_attention(q, k, v, causal=True)
    q0 = s - FLASH_HOLD_ROWS
    want = flash_rows_plain(q[:, q0:], k, v, q0)
    torch.cuda.synchronize()
    err = row_err(out[:, q0:].float(), want.float())
    res = {"shape": [b, s, s, h, kh, d], "causal": True, "dtype": "bfloat16",
           "held_rows": [q0, s], "err": err,
           "max_abs_err": float((out[:, q0:].float() - want.float()).abs().max())}
    if not err <= LM_KERNEL_TOL[torch.bfloat16]:
        raise AssertionError(f"flash_attention at S {s} disagrees with its plain version: "
                             f"{res} (tolerance {LM_KERNEL_TOL[torch.bfloat16]})")
    flops = 4 * b * h * d * work.attention_pairs(s, s, True, None)
    nbytes = q.element_size() * (2 * b * s * h * d + 2 * b * s * kh * d)
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(h // kh, dim=2).transpose(1, 2) for x in (k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    lib = sdpa()
    res.update(ms=cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters=5, warmup=1),
               # windows of 10 calls: windows of 3 recorded [0, 3] and [0, 0, 0]
               # launches on two runs (the profiler drops records, most in
               # short windows)
               device_ms=device_ms(lambda: flash_attention(q, k, v, causal=True),
                                   "flash_bf16_kernel", iters=10),
               plain_ms=None, library_ms=cuda_ms(sdpa, iters=5, warmup=1),
               library_err=row_err(lib.transpose(1, 2)[:, q0:].float(), want.float()),
               **bf16_bound(flops, nbytes))
    return res


def setup_split(wall: float, imports: float, work: float) -> dict:
    """A launch process's wall seconds beside its imports and the work it
    reports (steps, generation, the dry-run's trace and runs).  The two
    may overlap: imports made lazily during the work (the meta trace
    imports ``torch._dynamo``) count in both."""
    return {"wall_s": wall, "import_s": imports, "work_s": work,
            "import_share": imports / wall, "work_share": work / wall}


def launch_phase() -> dict:
    """The launch layer's entry points, each in a process of its own:
    ``launch.train`` in central mode on granite-3-2b at full width and
    depth (LAUNCH_ARGS), which prints the reference's lines and a finite
    loss; ``launch.serve`` at the reference's defaults, which prints its
    two lines and a (4, 32) token array; the dry-run of gemma-2b's
    prefill_32k at full width and depth through flash, executed at batch
    1 (18 flash launches, the peak under the card's memory); flash at that
    attention shape held against its plain version (``check_flash_long``);
    the server-resume step on granite-3-2b at full width executed at two
    cuts from one step, each with a finite loss and dv of the input's
    shape.  Each process's wall seconds are printed beside its imports
    and reported work (``setup_split``).

    The dry-run's FLOPs are held twice against ``prefill_flops``: ops.flops
    (flash counted as the kernel computes, ``kernels/work.py``) against
    its causal pairs, and cost_analysis_raw's flops (the plain version's
    ops as dispatched) against the full square.  The first alone would be
    partly circular: ``work.attention_pairs`` and ``prefill_flops`` count
    the causal pairs by the same formula, so it holds the matmuls; the
    second holds the trace's attention products independently."""
    lines, wall, imports = run_launch_module("train", LAUNCH_ARGS)
    final = [ln for ln in lines if ln.startswith("final loss ")]
    steps = [ln for ln in lines if ln.startswith("step ")]
    loss = float(final[-1].split()[2]) if final else float("nan")
    step_s = sum(float(ln.rsplit("(", 1)[1].split("s/step")[0]) for ln in steps)
    train = {"args": list(LAUNCH_ARGS), "final_loss": loss, "step_lines": len(steps),
             **setup_split(wall, imports, step_s)}
    print(f"[launch] {json.dumps(train)}", flush=True)
    if not (math.isfinite(loss) and len(steps) == 3):
        raise AssertionError(f"launch/train.py printed no finite loss: {lines}")

    lines, wall, imports = run_launch_module("serve", ())
    if not (len(lines) == 2 and lines[0].startswith("[gemma-2b] generated (4, 32) tokens in ")
            and lines[1].startswith("first sequence: ")
            and len(json.loads(lines[1][len("first sequence: "):])) == 32):
        raise AssertionError(f"launch/serve.py did not print the reference's lines: {lines}")
    gen_s = float(lines[0].split(" tokens in ")[1].split("s ")[0])
    serve = {"lines": lines, **setup_split(wall, imports, gen_s)}
    print(f"[launch] serve {json.dumps(serve)}", flush=True)

    lines, wall, imports = run_launch_module("dryrun", DRYRUN_PREFILL_ARGS)
    rec = json.loads(lines[-1])
    cfg = REGISTRY["gemma-2b"]
    analytic = prefill_flops(cfg, 1, 32768)
    analytic_square = prefill_flops(cfg, 1, 32768, square=True)
    flops = rec["ops"]["flops_per_device"]
    raw = rec["cost_analysis_raw"]["flops"]
    prefill = {"step_s": rec["step_s"], "t_lower_s": rec["t_lower_s"],
               "t_compile_s": rec["t_compile_s"],
               "launches": rec["launches"], "memory": rec["memory"],
               "flops": flops, "analytic_flops": analytic,
               "flops_gap": flops / analytic - 1, "raw_flops": raw,
               "analytic_square_flops": analytic_square,
               "raw_flops_gap": raw / analytic_square - 1, "roofline": rec["roofline"],
               "mfu_bound": rec["roofline"]["mfu_bound"],
               "achieved_flops_per_s": flops / rec["step_s"],
               **setup_split(wall, imports,
                             rec["t_lower_s"] + rec["t_compile_s"] + rec["step_s"])}
    print(f"[launch] dryrun gemma-2b prefill_32k: step {rec['step_s']:.4f} s, peak "
          f"{rec['memory']['peak_bytes'] / 1e9:.2f} GB (temp "
          f"{rec['memory']['temp_bytes'] / 1e9:.2f} GB), flash launches "
          f"{rec['launches']['flash_attention']}, ops.flops {flops:.5g} against the analytic "
          f"{analytic:.5g} ({prefill['flops_gap']:+.2%}), raw flops {raw:.5g} against the "
          f"full square's {analytic_square:.5g} ({prefill['raw_flops_gap']:+.2%}), bound "
          f"{rec['roofline']['step_time_lower_bound_s']:.4f} s "
          f"({rec['roofline']['dominant']}), mfu_bound {rec['roofline']['mfu_bound']:.3f}; "
          f"process {wall:.1f} s, imports {imports:.1f} s, trace {rec['t_lower_s']:.1f} s, "
          f"warm {rec['t_compile_s']:.1f} s", flush=True)
    if rec["launches"]["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"dryrun: {rec['launches']} flash launches, not {cfg.n_layers}")
    if not rec["memory"]["peak_bytes"] < torch.cuda.get_device_properties(0).total_memory:
        raise AssertionError(f"dryrun: peak {rec['memory']['peak_bytes']} past the card")
    if not abs(prefill["flops_gap"]) <= DRYRUN_FLOPS_TOL:
        raise AssertionError(f"dryrun: ops.flops {flops} is not within "
                             f"{DRYRUN_FLOPS_TOL} of {analytic}")
    if not abs(prefill["raw_flops_gap"]) <= DRYRUN_FLOPS_TOL:
        raise AssertionError(f"dryrun: cost_analysis_raw flops {raw} is not within "
                             f"{DRYRUN_FLOPS_TOL} of the full square's {analytic_square}")
    prefill["flash_hold"] = check_flash_long(seed=90)
    print(f"[launch] flash_attention S 32768 {json.dumps(prefill['flash_hold'])}", flush=True)

    lines, wall, imports = run_launch_module("dryrun", DRYRUN_RESUME_ARGS)
    rec = json.loads(lines[-1])
    runs = rec.get("cuts", {})
    if sorted(runs) != ["10", "30"] or not all(
            math.isfinite(r["loss"]) and r["dv_shape"] == [4, 1024, 2048] and r["dv_finite"]
            for r in runs.values()):
        raise AssertionError(f"dryrun --server-resume did not run at cuts 10 and 30: {rec}")
    work_s = rec["t_lower_s"] + sum(r["warm_s"] + r["step_s"] for r in runs.values())
    resume = {"cuts": runs, "ops": rec["ops"], "roofline": rec["roofline"],
              "memory": rec["memory"], "t_lower_s": rec["t_lower_s"],
              **setup_split(wall, imports, work_s)}
    print(f"[launch] dryrun server-resume: process {wall:.1f} s, imports {imports:.1f} s, "
          f"trace {rec['t_lower_s']:.1f} s, warm and timed runs "
          f"{work_s - rec['t_lower_s']:.1f} s", flush=True)
    return {"train": train, "serve": serve, "dryrun_prefill": prefill,
            "dryrun_resume": resume}


def memory_lines(fused: dict, plain: dict, cohort: dict, sl: dict) -> dict:
    """The paper's memory model (``Simulator.server_memory_report``) for
    ours, sfl and sl at the paper cuts, printed beside the peak device
    memory each run's rounds allocated.  A model and a reading, side by
    side: neither is held against the other (PERF.md compares them)."""
    from repro_torch.core.memory_model import server_memory

    sfl = dataclasses.asdict(server_memory(REGISTRY["bert-base"], "sfl", PAPER_CUTS,
                                           BATCH, SEQ))
    out = {"modelled_bytes": {}, "measured_max_mem_bytes": {}}
    for scheme, report in (("ours", fused["memory_report"]), ("sfl", sfl),
                           ("sl", sl["memory_report"])):
        out["modelled_bytes"][scheme] = {**report, "total": report["params"]
                                         + report["activations"]
                                         + report["adapters_and_opt"]}
    for label, run in (("main:fused", fused), ("main:einsum", plain),
                       ("cohort:fused", cohort), ("sl:fused", sl)):
        out["measured_max_mem_bytes"][label] = [row["max_mem_bytes"] for row in run["rows"]]
    print(f"[memory] {json.dumps(out)}", flush=True)
    return out


def phase(name: str, fn, *args, **kw):
    """Run one phase of ``main`` and print its wall time (host clock)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"[wall] {name} {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm round of each path")
    ap.add_argument("--ab", type=Path, metavar="OLD_ROOT",
                    help="compare the port of another checkout (a parent commit "
                         "unpacked with git archive) with this one on this card, "
                         "in the order old, new, new, old, and do nothing else")
    ap.add_argument("--ab-one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--predict-control", action="store_true",
                    help="compute the [control] phase's decision logs and timelines on "
                         "the CPU, print them and PREDICTED_CONTROL, and do nothing else")
    ap.add_argument("--predict-resume", action="store_true",
                    help="compute the [resume] phase's snapshot instants, restored state "
                         "and launches on the CPU, print them and PREDICTED_RESUME, and "
                         "do nothing else")
    ap.add_argument("--predict-population", action="store_true",
                    help="compute the [population] phase's cohorts, straggler draws, "
                         "simulated times and launches on the CPU, print them and "
                         "PREDICTED_POPULATION, and do nothing else")
    args = ap.parse_args()
    if args.predict_control:
        predict_control_phase()
        return
    if args.predict_resume:
        predict_resume_phase()
        return
    if args.predict_population:
        predict_population_phase()
        return
    if args.ab_one is not None:
        print("[ab]", json.dumps(ab_measure()), flush=True)
        return
    card = gpu_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(card, flush=True)
    if args.ab is not None:
        # one process per turn, each building and importing its own checkout
        for root in (args.ab, ROOT, ROOT, args.ab):
            subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--ab-one",
                            str(Path(root).resolve())], check=True)
        return

    t0 = t_start = time.perf_counter()
    build.load_all(SOURCES)             # one nvcc per source, all at once
    print(f"[build] {', '.join(SOURCES)} ready in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name in SOURCES:
        seconds, log = build.BUILD_LOG.get(name, (0.0, ""))
        print(f"[build] {name}: nvcc {seconds:.2f} s", flush=True)
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line):
                print(f"[build] {name}: {line.strip()}", flush=True)
        mma = sass_mma_counts(name)
        print(f"[build] {name}: tensor-core instructions in SASS {json.dumps(mma)}",
              flush=True)
        # the bf16 LoRA tile and flash's bf16 body are wgmma
        if name in WGMMA_SOURCES and not mma.get("HGMMA", 0) > 0:
            raise AssertionError(f"no HGMMA instruction in lib{name}.so: {mma}")
    direct_sass = check_direct_sass()
    print(f"[build] grouped_lora direct mode's SASS {json.dumps(direct_sass)}", flush=True)

    t_kernels = time.perf_counter()
    # the main path's shape (timed), then M, N, K off the tiles, the dx
    # call's K 770 (N 770 forward) and ranks 5, 16, 64
    checks = [check_lora_matmul(2048, 768, 768, 16, seed=0, timed=True),
              check_lora_matmul(37, 100, 130, 5, seed=1),
              check_lora_matmul(2047, 768, 770, 16, seed=14),
              check_lora_matmul(2047, 770, 768, 64, seed=15)]
    for c in checks:
        print(f"[kernel] lora_matmul {json.dumps(c)}", flush=True)
    # the MoE router's fp32 product over a prefill's 8192 rows: qwen3-moe's
    # d 2048 to E 128 (timed; its dx call has K = E = 128) and grok-1's
    # d 6144 to E 8 (its dx call K = 8), forward, views and backward
    router_checks = [check_lora_matmul(8192, 2048, 128, 16, seed=60, timed=True),
                     check_lora_matmul(8192, 6144, 8, 16, seed=61)]
    for c in router_checks:
        print(f"[kernel] lora_matmul router {json.dumps(c)}", flush=True)
    grouped_path = check_grouped((2048, 2048), 768, 768, 16, (2.0, 2.0), "chunk",
                                 seed=2, timed=True)
    grouped_ragged = check_grouped((37, 100, 5), 130, 100, 5, (0.5, 1.0, 1.5), "chunk",
                                   seed=3)
    # direct mode: the cohort shape with K cut to 128, the largest K that
    # mode "auto" sends there (timed, beside chunk mode on the same inputs);
    # the ragged test shape; K 770, past the resident slab (the K sweep),
    # whose dx call (K 96) runs the resident tile on the views
    grouped_direct = check_grouped((2048, 2048), 128, 768, 16, (2.0, 2.0), "direct",
                                   seed=4, timed=True)
    grouped_direct_more = [check_grouped((40, 100, 17), 96, 150, 6, (0.5, 1.0, 1.5),
                                         "direct", seed=4),
                           check_grouped((40, 100, 17), 770, 96, 6, (0.5, 1.0, 1.5),
                                         "direct", seed=19)]
    # direct mode where the MoE cohort steps run it: the router's dx call
    # over three lanes of 2 x 512 tokens, K = E 128 to N = d 2048 (timed);
    # and the router's own product, d 2048 to E 128, whose dx call is that
    # one on the views the backward passes (W^T, B^T, A^T; timed there)
    grouped_router_dx = check_grouped((1024, 1024, 1024), 128, 2048, 16, (2.0, 2.0, 2.0),
                                      "direct", seed=62, timed=True)
    grouped_router = check_grouped((1024, 1024, 1024), 2048, 128, 16, (2.0, 2.0, 2.0),
                                   "direct", seed=65, timed=True)
    grouped_one = check_grouped_single_group(seed=5)
    quant = check_quantize(2048, 768, seed=6)
    for label, c in (("grouped_lora chunk", grouped_path),
                     ("grouped_lora chunk", grouped_ragged),
                     ("grouped_lora direct", grouped_direct),
                     ("grouped_lora direct (MoE router dx)", grouped_router_dx),
                     ("grouped_lora direct (MoE router, dx call on views)", grouped_router),
                     *(("grouped_lora direct", c) for c in grouped_direct_more),
                     ("grouped_lora G=1", grouped_one), ("quantize_rows", quant)):
        print(f"[kernel] {label} {json.dumps(c)}", flush=True)

    # bf16: gemma-2b's q-projection (timed) and k/v projection over the
    # prefill's 4 x 2048 rows, the reference's sweep shapes and ranks, and
    # the fp32 checks' ragged shapes
    bf16_q = check_lora_matmul_bf16(8192, 2048, 2048, 16, seed=20, timed=True)
    bf16_kv = check_lora_matmul_bf16(8192, 2048, 256, 16, seed=21, timed=True)
    # and rwkv6-3b's three projection shapes over the same 8192 rows
    bf16_rwkv = [check_lora_matmul_bf16(8192, k, n, 16, seed=40 + i, timed=True)
                 for i, (k, n) in enumerate(RWKV6_PROJECTIONS)]
    bf16_ragged = [check_lora_matmul_bf16(m, k, n, r, seed=22 + r)
                   for m, k, n in ((128, 128, 128), (64, 256, 128), (100, 300, 200),
                                   (7, 130, 64), (256, 512, 384))
                   for r in (4, 16)]
    bf16_ragged += [check_lora_matmul_bf16(2047, 770, 768, 64, seed=23),
                    check_lora_matmul_bf16(2047, 768, 770, 5, seed=24)]
    # zamba2-7b's in_proj over the prefill's 8192 rows: N = 2*7168 + 2*64 +
    # 112 = 14576, whose last 256-wide tile is partial (timed)
    bf16_in_proj = check_lora_matmul_bf16(8192, 3584, 14576, 16, seed=81, timed=True)
    for c in (bf16_q, bf16_kv, *bf16_rwkv, bf16_in_proj, *bf16_ragged):
        print(f"[kernel] lora_matmul bf16 {json.dumps(c)}", flush=True)
    # the 2-tenant grouped prefill's q-projection (timed); ragged cohorts in
    # chunk mode; direct mode at K <= 128, the reference's auto choice
    bf16_grouped = check_grouped_bf16((4096, 4096), 2048, 2048, 16, (2.0, 2.0), "chunk",
                                      seed=25, timed=True)
    bf16_grouped_ragged = [check_grouped_bf16(sizes, k, n, r, sc, "chunk", seed=26)
                           for sizes, k, n, r, sc in (((37, 100, 5), 130, 100, 5,
                                                       (0.5, 1.0, 1.5)),
                                                      ((33, 90), 256, 192, 8, (2.0, 2.0)))]
    # direct mode: two tenants' groups of 4096 rows with K cut to 128
    # (timed, beside chunk mode); the ragged test shapes (N 150: the K sweep
    # on mma.sync; K 128 at r 8: the resident tile); K 64 (one panel), whose
    # dx call runs the resident tile on W^T with A by hand (the B^T view);
    # r 64; K 770 (the K sweep), its dx call (K 192) past the resident slab;
    # K 2048 (the sweep), whose dx call (K 128, 18 row tiles x 16 N tiles)
    # makes each block reload x and A_g by hand (the B^T view)
    bf16_direct = check_grouped_bf16((4096, 4096), 128, 2048, 16, (2.0, 2.0), "direct",
                                     seed=27, timed=True)
    bf16_direct_more = [check_grouped_bf16(sizes, k, n, r, sc, "direct", seed=28 + i)
                        for i, (sizes, k, n, r, sc) in enumerate((
                            ((40, 100, 17), 96, 150, 6, (0.5, 1.0, 1.5)),
                            ((33, 90), 128, 192, 8, (2.0, 2.0)),
                            ((33, 290), 64, 128, 16, (0.5, 2.0)),
                            ((33, 290), 128, 256, 64, (0.5, 2.0)),
                            ((33, 290), 770, 192, 8, (2.0, 2.0)),
                            ((1000, 1100), 2048, 128, 16, (0.5, 2.0))))]
    bodies = {c[key] for c in (bf16_direct, *bf16_direct_more)
              for key in ("body", "dx_call_body")}
    if bodies != {"resident", "sweep wgmma", "sweep mma.sync"} or "resident" not in {
            c["dx_call_body"] for c in bf16_direct_more}:
        raise AssertionError(f"bf16 direct mode's checks did not reach every body: {bodies}")
    for c in (bf16_grouped, *bf16_grouped_ragged, bf16_direct, *bf16_direct_more):
        print(f"[kernel] grouped_lora {c['mode']} bf16 {json.dumps(c)}", flush=True)

    flash_path = check_flash(4, 2048, 2048, 8, 1, 256, True, None, torch.bfloat16, seed=7,
                             timed=True)
    flash_f32 = check_flash(4, 2048, 2048, 8, 1, 256, True, None, torch.float32, seed=8,
                            timed=True)
    flash_gqa = [check_flash(2, 1000, 1000, 32, 8, 64, causal, window, dtype, seed=9)
                 for dtype in (torch.bfloat16, torch.float32)
                 for causal, window in ((True, 256), (False, None))]
    # the tensor-core path at the other head dimensions the models use
    flash_bf16_dims = [check_flash(b_, s_, t_, h_, kh_, d, causal, window, torch.bfloat16,
                                   seed=16)
                       for d in (64, 128)
                       for b_, s_, t_, h_, kh_, causal, window in (
                           (1, 700, 900, 16, 4, False, None),
                           (2, 1000, 1000, 32, 8, True, 256))]
    # the A10 slice's prefill shapes (4 x 2048, causal): qwen3-moe's head_dim
    # 128 with GQA 8:1 (timed), and granite-3-2b's head_dim 64 with GQA 4:1
    flash_gqa128 = check_flash(4, 2048, 2048, 32, 4, 128, True, None, torch.bfloat16,
                               seed=63, timed=True)
    flash_bf16_dims.append(check_flash(4, 2048, 2048, 32, 8, 64, True, None,
                                       torch.bfloat16, seed=64))
    # zamba2-7b's shared attention at head_dim 112 (the 128-wide tile, zero
    # past D), 4 x 2048, 32 heads on 32, causal, in both types (timed); and
    # whisper-large-v3's encoder: 4 x 1500 frames, 20 heads, D 64,
    # non-causal, T not a tile multiple (timed)
    flash_112 = check_flash(4, 2048, 2048, 32, 32, 112, True, None, torch.bfloat16,
                            seed=80, timed=True)
    flash_112_f32 = check_flash(4, 2048, 2048, 32, 32, 112, True, None, torch.float32,
                                seed=82, timed=True)
    flash_whisper = check_flash(4, 1500, 1500, 20, 20, 64, False, None, torch.bfloat16,
                                seed=83, timed=True)
    # the kernel pair (the forward's lse and both instances, the backward):
    # granite-3-2b's server step, 16 x 512, 32 heads on 8, D 64, causal
    # (timed); ragged S and T, MQA, windows with and without causality
    flash_pair = check_flash_pair(16, 512, 512, 32, 8, 64, True, None, seed=84, timed=True)
    flash_pair_more = [check_flash_pair(*shape, causal, window, seed=86 + i)
                       for i, (shape, causal, window) in enumerate((
                           ((2, 65, 65, 8, 2, 64), True, None),
                           ((2, 48, 80, 8, 2, 64), True, None),
                           ((2, 48, 80, 8, 1, 64), False, None),
                           ((1, 300, 300, 4, 1, 64), True, 100),
                           ((2, 200, 150, 8, 2, 64), False, 64),
                           ((1, 150, 70, 4, 2, 64), True, None)))]
    wkv_path = check_wkv(4, 2048, 40, 64, torch.bfloat16, torch.float32, seed=10,
                         timed=True)
    wkv_f32 = check_wkv(4, 2048, 40, 64, torch.float32, torch.float32, seed=11, timed=True)
    wkv_ragged = [check_wkv(4, 1000, 40, 64, dtype, torch.float32, seed=12)
                  for dtype in (torch.bfloat16, torch.float32)]
    # fast decays (many near 0) at the path's shape and at ragged T, and
    # every head dimension the kernel takes
    wkv_fast = [check_wkv(b_, t_, 40, 64, dtype, torch.float32, seed=17, fast=True)
                for b_, t_ in ((4, 2048), (4, 1000), (3, 37))
                for dtype in (torch.bfloat16, torch.float32)]
    wkv_dims = [check_wkv(2, t_, 3, d, dtype, w_dtype, seed=18, fast=fast)
                for d in (16, 32, 64, 128) for t_ in (1000, 37) for fast in (False, True)
                for dtype, w_dtype in ((torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32),
                                       (torch.bfloat16, torch.bfloat16))]
    for c in (flash_path, flash_f32, *flash_gqa, *flash_bf16_dims, flash_gqa128, flash_112,
              flash_112_f32, flash_whisper):
        print(f"[kernel] flash_attention {json.dumps(c)}", flush=True)
    for c in (flash_pair, *flash_pair_more):
        print(f"[kernel] flash_attention pair {json.dumps(c)}", flush=True)
    for c in (wkv_path, wkv_f32, *wkv_ragged, *wkv_fast, *wkv_dims):
        print(f"[kernel] wkv6 {json.dumps(c)}", flush=True)

    print(f"[wall] kernel checks {time.perf_counter() - t_kernels:.1f} s", flush=True)
    train = make_emotion_dataset(N_TRAIN, seq_len=SEQ, vocab_size=30_522, seed=0)
    test = make_emotion_dataset(N_TEST, seq_len=SEQ, vocab_size=30_522, seed=1)
    fused = phase("main:fused", run_path, True, train, test)
    plain = phase("main:einsum", run_path, False, train, test)
    compare_paths(fused, plain, "main")
    cohort = phase("cohort:fused", run_path, True, train, test, cohort=True)
    cohort_plain = phase("cohort:einsum", run_path, False, train, test, cohort=True)
    compare_paths(cohort, cohort_plain, "cohort")
    vmap = phase("vmap", vmap_phase, train, test, {"fused": cohort, "einsum": cohort_plain})
    sl = phase("sl", run_path, True, train, test, scheme="sl")
    memory_lines(fused, plain, cohort, sl)
    finals = {}
    event = phase("event", event_phase, fused, train, test, finals)
    control = phase("control", control_phase, train, test, finals)
    resume = phase("resume", resume_phase, train, test, finals)
    del finals
    gc.collect()
    population = phase("population", population_phase, train, test)

    del train, test
    gc.collect()
    torch.cuda.empty_cache()
    lm = {arch: phase(f"lm:{arch}", lm_phase, arch, seed=13 + i,
                      layers=LM_PHASE_LAYERS.get(arch))
          for i, arch in enumerate(LM_ARCHS)}
    lm_new = {arch: phase(f"lm:{arch}", lm_phase, arch, seed=70 + i, **kw)
              for i, (arch, kw) in enumerate(NEW_LM_PHASES)}
    lm_new.update({arch: phase(f"lm:{arch}", lm_phase, arch, seed=85 + i)
                   for i, arch in enumerate(FAMILY_LM_PHASES)})
    built = phase("build-models", build_phase)
    lm_grad = {arch: phase(f"lm-grad:{arch}", lm_backward, arch, seed=30 + i)
               for i, arch in enumerate(LM_ARCHS)}
    lm_tr = {arch: phase(f"lm-train:{arch}", lm_train, arch, seed=50 + i)
             for i, arch in enumerate(LM_TRAIN_ARCHS)}
    launch = phase("launch", launch_phase)
    print(f"[wall] the phases took {time.perf_counter() - t_start:.1f} s", flush=True)

    if args.profile:
        train = make_emotion_dataset(N_TRAIN, seq_len=SEQ, vocab_size=30_522, seed=0)
        test = make_emotion_dataset(N_TEST, seq_len=SEQ, vocab_size=30_522, seed=1)
        for fused_path, cohort_path in ((True, False), (False, False), (True, True)):
            profile_round(fused_path, train, test, cohort=cohort_path)
        for policy in ("sync", "buffered"):
            profile_event(policy, train, test)

    print(json.dumps({"lm": {**lm, **lm_new}, "build_models": built, "lm_grad": lm_grad,
                      "lm_train": lm_tr, "launch": launch}), flush=True)
    all_lm = {**lm, **lm_new}
    main_shape, ragged = checks[0], checks[1:]

    def entry(name, source, replaces, launches, c, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": None,
                "device_ms": c["device_ms"], **extra, "ok": True}

    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        entry("lora_matmul", csrc + "lora_matmul.cu", "src/repro/kernels/lora_matmul.py:62",
              fused["launches"]["lora_matmul"], main_shape, path="main",
              design=DESIGNS["lora_matmul"],
              bound_tf32x3_ms=main_shape["bound_tf32x3_ms"],
              bound_bytes_ms=main_shape["bound_bytes_ms"],
              dx_call_device_ms=main_shape["dx_call_device_ms"],
              cohort_launches=cohort["launches"]["lora_matmul"],
              vmap_launches=vmap["fused"]["launches"]["lora_matmul"],
              sl_launches=sl["launches"]["lora_matmul"],
              event_launches=event_launches(event, "lora_matmul"),
              control_launches=control_launches(control, "lora_matmul"),
              resume_launches=resume_launches(resume, "lora_matmul"),
              population_launches=population_launches(population, "lora_matmul"),
              base_matmul_ms=main_shape["base_matmul_ms"],
              moe_router={str(c["shape"]): {key: c.get(key) for key in
                                            ("fwd_err", "views_err", "dx_err", "da_err",
                                             "db_err", "ms", "device_ms",
                                             "dx_call_device_ms", "plain_ms",
                                             "base_matmul_ms", "bound_ms", "bound_by")}
                          for c in router_checks},
              moe_router_launches={
                  **{f"{arch} fused prefill": (
                      all_lm[arch]["lora_kernels"]["fused"]["launches"]["lora_matmul"]
                      - all_lm[arch]["lora_kernels"]["fused"]["launches"]["lora_matmul_bf16"])
                     for arch in all_lm if REGISTRY[arch].family == "moe"},
                  **{f"{arch} lm-train ({LM_TRAIN_LAYERS[arch]} layers)": {
                      step: counts["lora_matmul"] - counts["lora_matmul_bf16"]
                      for step, counts in lm_tr[arch]["launches"].items()}
                     for arch in LM_TRAIN_ARCHS if REGISTRY[arch].family == "moe"}},
              ragged={str(c["shape"]): {key: c[key] for key in
                                        ("fwd_err", "views_err", "dx_err", "da_err",
                                         "db_err", "max_abs_err")}
                      for c in ragged}),
        entry("grouped_lora_chunk", csrc + "grouped_lora.cu",
              "src/repro/kernels/grouped_lora.py:119",
              cohort["launches"]["grouped_lora_chunk"], grouped_path, path="cohort",
              design=DESIGNS["grouped_lora_chunk"],
              vmap_launches=vmap["fused"]["launches"]["grouped_lora_chunk"],
              event_launches=event_launches(event, "grouped_lora_chunk"),
              control_launches=control_launches(control, "grouped_lora_chunk"),
              resume_launches=resume_launches(resume, "grouped_lora_chunk"),
              population_launches=population_launches(population, "grouped_lora_chunk"),
              bound_tf32x3_ms=grouped_path["bound_tf32x3_ms"],
              dx_call_device_ms=grouped_path["dx_call_device_ms"],
              views_err=grouped_path["views_err"],
              error_sources=grouped_path["error_sources"],
              dx_error_sources=grouped_path["dx_error_sources"],
              base_matmul_ms=grouped_path["base_matmul_ms"],
              moe_router_launches={
                  **{f"{arch} 2-tenant grouped prefill": (
                      all_lm[arch]["lora_kernels"]["grouped"]["launches"]["grouped_lora_chunk"]
                      - all_lm[arch]["lora_kernels"]["grouped"]["launches"][
                          "grouped_lora_chunk_bf16"])
                     for arch in all_lm if REGISTRY[arch].family == "moe"},
                  **{f"{arch} lm-train ({LM_TRAIN_LAYERS[arch]} layers)": {
                      step: counts["grouped_lora_chunk"] - counts["grouped_lora_chunk_bf16"]
                      for step, counts in lm_tr[arch]["launches"].items()}
                     for arch in LM_TRAIN_ARCHS if REGISTRY[arch].family == "moe"}},
              ragged_max_abs_err=grouped_ragged["max_abs_err"],
              single_group_err_vs_lora_matmul=grouped_one["err_vs_lora_matmul"]),
        entry("grouped_lora_direct", csrc + "grouped_lora.cu",
              "src/repro/kernels/grouped_lora.py:103",
              sum(lm_tr[arch]["launches"][f"batched_{impl}"]["grouped_lora_direct"]
                  for arch in LM_TRAIN_ARCHS for impl in ("vmap", "ragged")
                  if f"batched_{impl}" in lm_tr[arch]["launches"]),
              grouped_router_dx,
              path="qwen3-moe-30b-a3b lm-train cohort steps (the router's dx call)",
              tile=csrc + "tf32_lora_tile.cuh", body=grouped_router_dx["body"],
              design=DESIGNS["grouped_lora_direct"], views_err=grouped_router_dx["views_err"],
              shape=[grouped_router_dx["sizes"], grouped_router_dx["k"],
                     grouped_router_dx["n"], grouped_router_dx["r"]],
              launches_by_path={
                  f"{arch} lm-train {step}": counts["grouped_lora_direct"]
                  for arch in LM_TRAIN_ARCHS
                  for step, counts in lm_tr[arch]["launches"].items()
                  if counts["grouped_lora_direct"]},
              cohort_path_launches=cohort["launches"]["grouped_lora_direct"],
              chunk_device_ms=grouped_router_dx["chunk_device_ms"],
              dx_call_device_ms=grouped_router_dx["dx_call_device_ms"],
              dx_call_body=grouped_router_dx["dx_call_body"],
              path_views={"shape": [grouped_router["sizes"], grouped_router["k"],
                                    grouped_router["n"], grouped_router["r"]],
                          "dx_call_body": grouped_router["dx_call_body"],
                          "dx_call_device_ms": grouped_router["dx_call_device_ms"],
                          "views_err": grouped_router["views_err"],
                          "dx_err": grouped_router["dx_err"]},
              base_matmul_ms=grouped_router_dx["base_matmul_ms"],
              bound_tf32x3_ms=grouped_router_dx["bound_tf32x3_ms"],
              error_sources=grouped_router_dx["error_sources"],
              cohort_shape={key: grouped_direct[key] for key in
                            ("sizes", "k", "n", "r", "body", "ms", "device_ms",
                             "chunk_device_ms", "dx_call_device_ms", "plain_ms",
                             "base_matmul_ms", "bound_ms", "bound_by", "error_sources")},
              more={f"{c['sizes']} K {c['k']} N {c['n']} r {c['r']}": {
                  key: c[key] for key in ("body", "dx_call_body", "fwd_err", "views_err",
                                          "dx_err", "da_err", "db_err")}
                  for c in grouped_direct_more},
              sass=direct_sass),
        entry("lora_matmul_bf16", csrc + "lora_matmul.cu",
              "src/repro/kernels/lora_matmul.py:62",
              sum(all_lm[arch]["lora_kernels"]["fused"]["launches"]["lora_matmul_wgmma"]
                  for arch in all_lm), bf16_q,
              path="the LMs' fused-LoRA prefill", dtype="bfloat16",
              tile=csrc + "bf16_wgmma_tile.cuh",
              shape=bf16_q["shape"], design=DESIGNS["lora_matmul_bf16"],
              launches_by_path={
                  **{f"{arch} fused prefill ({all_lm[arch]['layers']} layers)":
                     all_lm[arch]["lora_kernels"]["fused"]["launches"]["lora_matmul_bf16"]
                     for arch in all_lm},
                  **{f"{arch} backward ({LM_GRAD_LAYERS} layers)":
                     lm_grad[arch]["launches"]["fused"]["lora_matmul_bf16"]
                     for arch in LM_ARCHS},
                  **{f"{arch} lm-train ({LM_TRAIN_LAYERS[arch]} layers)":
                     lm_train_launches(lm_tr[arch], "lora_matmul_bf16")
                     for arch in LM_TRAIN_ARCHS}},
              dx_call_device_ms=bf16_q["dx_call_device_ms"],
              base_matmul_ms=bf16_q["base_matmul_ms"],
              bound_bytes_ms=bf16_q["bound_bytes_ms"],
              error_vs_exact=bf16_q["error_vs_exact"],
              kv_projection={key: bf16_kv[key] for key in
                             ("shape", "ms", "device_ms", "plain_ms", "base_matmul_ms",
                              "bound_ms", "bound_by", "fwd_err", "mma_sync_device_ms")},
              rwkv6_projections=[{key: c[key] for key in
                                  ("shape", "ms", "device_ms", "dx_call_device_ms",
                                   "mma_sync_device_ms", "plain_ms", "base_matmul_ms",
                                   "bound_ms", "bound_by", "fwd_err", "views_err",
                                   "dx_call_err", "error_vs_exact")}
                                 for c in bf16_rwkv],
              ragged={str(c["shape"]): max(v for key, v in c.items()
                                           if key.endswith("_err") and key != "max_abs_err")
                      for c in bf16_ragged},
              zamba2_in_proj={key: bf16_in_proj[key] for key in
                              ("shape", "tile", "ms", "device_ms", "dx_call_device_ms",
                               "mma_sync_device_ms", "plain_ms", "base_matmul_ms",
                               "bound_ms", "bound_by", "fwd_err", "views_err",
                               "dx_call_err", "error_vs_exact")}),
        entry("lora_matmul_bf16_mma_sync", csrc + "lora_matmul.cu",
              "src/repro/kernels/lora_matmul.py:62",
              sum(all_lm[arch]["lora_kernels"]["fused"]["launches"]["lora_matmul_bf16"]
                  - all_lm[arch]["lora_kernels"]["fused"]["launches"]["lora_matmul_wgmma"]
                  for arch in all_lm),
              {**bf16_q, "ms": bf16_q["mma_sync_ms"], "device_ms": bf16_q["mma_sync_device_ms"],
               "max_abs_err": bf16_q["mma_sync_max_abs_err"]},
              path=None, dtype="bfloat16", tile=csrc + "bf16_lora_tile.cuh",
              shape=bf16_q["shape"], timed_with="A misaligned by one element",
              design=DESIGNS["lora_matmul_bf16_mma_sync"],
              ragged_tiles={str(c["shape"]): [c["tile"], c["views_tile"], c["dx_call_tile"]]
                            for c in bf16_ragged}),
        entry("grouped_lora_chunk_bf16", csrc + "grouped_lora.cu",
              "src/repro/kernels/grouped_lora.py:119",
              sum(all_lm[arch]["lora_kernels"]["grouped"]["launches"][
                  "grouped_lora_chunk_wgmma"] for arch in all_lm), bf16_grouped,
              path="the LMs' 2-tenant grouped prefill", dtype="bfloat16",
              tile=csrc + "bf16_wgmma_tile.cuh",
              shape=[bf16_grouped["sizes"], bf16_grouped["k"], bf16_grouped["n"],
                     bf16_grouped["r"]],
              design=DESIGNS["grouped_lora_chunk_bf16"],
              lm_train_launches={
                  f"{arch} lm-train ({LM_TRAIN_LAYERS[arch]} layers)":
                  lm_train_launches(lm_tr[arch], "grouped_lora_chunk_bf16")
                  for arch in LM_TRAIN_ARCHS},
              dx_call_device_ms=bf16_grouped["dx_call_device_ms"],
              base_matmul_ms=bf16_grouped["base_matmul_ms"],
              bound_bytes_ms=bf16_grouped["bound_bytes_ms"],
              mma_sync_device_ms=bf16_grouped["mma_sync_device_ms"],
              ragged_errs=[max(v for key, v in c.items()
                               if key.endswith("_err") and key != "max_abs_err")
                           for c in bf16_grouped_ragged]),
        entry("grouped_lora_chunk_bf16_mma_sync", csrc + "grouped_lora.cu",
              "src/repro/kernels/grouped_lora.py:119",
              sum(all_lm[arch]["lora_kernels"]["grouped"]["launches"]["grouped_lora_chunk_bf16"]
                  - all_lm[arch]["lora_kernels"]["grouped"]["launches"][
                      "grouped_lora_chunk_wgmma"]
                  for arch in all_lm),
              {**bf16_grouped, "ms": bf16_grouped["mma_sync_ms"],
               "device_ms": bf16_grouped["mma_sync_device_ms"],
               "max_abs_err": bf16_grouped["mma_sync_max_abs_err"]},
              path=None, dtype="bfloat16", tile=csrc + "bf16_lora_tile.cuh",
              timed_with="A misaligned by one element",
              shape=[bf16_grouped["sizes"], bf16_grouped["k"], bf16_grouped["n"],
                     bf16_grouped["r"]],
              design=DESIGNS["grouped_lora_chunk_bf16_mma_sync"],
              ragged_tiles=[c["tile"] for c in bf16_grouped_ragged]),
        entry("grouped_lora_direct_bf16", csrc + "grouped_lora.cu",
              "src/repro/kernels/grouped_lora.py:103",
              sum(all_lm[arch]["lora_kernels"]["grouped"]["launches"][
                  "grouped_lora_direct_bf16"] for arch in all_lm),
              bf16_direct, path=None, dtype="bfloat16",
              shape=[bf16_direct["sizes"], bf16_direct["k"], bf16_direct["n"],
                     bf16_direct["r"]],
              design=DESIGNS["grouped_lora_direct_bf16"], body=bf16_direct["body"],
              chunk_device_ms=bf16_direct["chunk_device_ms"],
              dx_call_device_ms=bf16_direct["dx_call_device_ms"],
              dx_call_body=bf16_direct["dx_call_body"],
              base_matmul_ms=bf16_direct["base_matmul_ms"],
              bound_bytes_ms=bf16_direct["bound_bytes_ms"],
              error_vs_exact=bf16_direct["error_vs_exact"],
              more={f"{c['sizes']} K {c['k']} N {c['n']} r {c['r']}": {
                  key: c[key] for key in ("body", "dx_call_body", "fwd_err", "views_err",
                                          "dx_err", "da_err", "db_err")}
                  for c in bf16_direct_more}),
        entry("quantize_rows", csrc + "quant.cu", "src/repro/kernels/quant.py:33",
              cohort["launches"]["quantize_rows"], quant, path="cohort",
              bit_equal=True, design=DESIGNS["quantize_rows"], shape=quant["shape"],
              vmap_launches=vmap["fused"]["launches"]["quantize_rows"],
              event_launches=event_launches(event, "quantize_rows"),
              control_launches=control_launches(control, "quantize_rows"),
              resume_launches=resume_launches(resume, "quantize_rows"),
              population_launches=population_launches(population, "quantize_rows"),
              dtype="float32", body=quant["body"],
              bf16={key: quant["bfloat16"][key] for key in
                    ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "body",
                     "q_mismatches", "scale_mismatches")},
              bodies=[[c["shape"], c["dtype"], c["body"]] for c in quant["bodies"]]),
        {**entry("flash_attention", csrc + "flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:84",
                 lm["gemma-2b"]["prefill"]["kernels"]["launches"]["flash_attention"],
                 flash_path, path="gemma-2b prefill", shape=flash_path["shape"],
                 dtype="bfloat16", err=flash_path["err"],
                 design=DESIGNS["flash_attention"],
                 bf16_dims_errs={f"{c['shape']}": c["err"] for c in flash_bf16_dims},
                 fp32={key: flash_f32[key] for key in
                       ("err", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by")},
                 gqa_errs=[c["err"] for c in flash_gqa],
                 launches_by_path={**{f"{arch} prefill ({all_lm[arch]['layers']} layers)":
                                      all_lm[arch]["prefill"]["kernels"]["launches"][
                                          "flash_attention"]
                                      for arch in all_lm if all_lm[arch]["family"] != "ssm"},
                                   "launch dryrun gemma-2b prefill_32k (18 layers, 1 x 32768)":
                                   launch["dryrun_prefill"]["launches"]["flash_attention"]},
                 prefill_32k={key: launch["dryrun_prefill"]["flash_hold"][key] for key in
                              ("shape", "held_rows", "err", "max_abs_err", "ms", "device_ms",
                               "plain_ms", "library_ms", "library_err", "bound_ms",
                               "bound_by")},
                 head_dim_128_gqa_8={key: flash_gqa128[key] for key in
                                     ("shape", "err", "ms", "device_ms", "plain_ms",
                                      "library_ms", "library_err", "bound_ms",
                                      "bound_by")},
                 **{label: {key: c[key] for key in
                            ("shape", "dtype", "causal", "err", "max_abs_err", "ms",
                             "device_ms", "plain_ms", "library_ms", "library_err",
                             "bound_ms", "bound_by")}
                    for label, c in (("zamba2_head_dim_112", flash_112),
                                     ("zamba2_head_dim_112_fp32", flash_112_f32),
                                     ("whisper_encoder", flash_whisper))},
                 library="torch.nn.functional.scaled_dot_product_attention",
                 library_err=flash_path["library_err"],
                 granite_server_step_pair={
                     **{key: flash_pair[key] for key in
                        ("shape", "online", "normalise_first", "forward_nf_device_ms",
                         "forward_online_device_ms", "forward_nf_bound_ms", "ms",
                         "device_ms", "dq_device_ms", "plain_ms", "library_ms",
                         "bound_ms", "bound_by")},
                     "ragged_grad_errs": {str(c["shape"]): max(
                         c[inst][f"d{n}_err"] for inst in ("online", "normalise_first")
                         for n in "qkv") for c in flash_pair_more}},
                 normalise_first={label: {key: c[key] for key in
                                          ("shape", "nf_err", "nf_device_ms", "device_ms",
                                           "bound_ms")}
                                  for label, c in (("gemma_2b", flash_path),
                                                   ("head_dim_128_gqa_8", flash_gqa128),
                                                   ("zamba2_head_dim_112", flash_112),
                                                   ("whisper_encoder", flash_whisper))}),
         "library_ms": flash_path["library_ms"]},
        entry("wkv6", csrc + "wkv6.cu", "src/repro/kernels/rwkv6_scan.py:71",
              lm["rwkv6-3b"]["prefill"]["kernels"]["launches"]["wkv6"], wkv_path,
              path="rwkv6-3b prefill", shape=wkv_path["shape"],
              dtype="bfloat16 r/k/v, float32 w", err=wkv_path["err"],
              state_err=wkv_path["state_err"], design=DESIGNS["wkv6"],
              fast_decay_errs=[[c["shape"], c["dtype"], c["err"], c["state_err"]]
                               for c in wkv_fast],
              worst_dims_errs={key: max(c[key] for c in wkv_dims)
                               for key in ("err", "state_err")},
              fp32={key: wkv_f32[key] for key in
                    ("err", "state_err", "ms", "device_ms", "plain_ms", "bound_ms",
                     "bound_by")},
              ragged_errs=[[c["err"], c["state_err"]] for c in wkv_ragged]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
