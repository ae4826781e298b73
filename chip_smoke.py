#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--json PATH]

Phases, each reported on its own lines:

  1. environment: the card's name and power limit, torch and CUDA versions,
     and the build of every CUDA kernel from the checkout's sources (nvcc,
     all sources at once, into build/kernels/);
  2. every kernel against its plain PyTorch version on the card, at the test
     shapes and at the shapes the main path gives it, with its time, the
     plain version's time and the bound the card sets;
  3. the flat stacking path at Table 2's locality-10 size: 46,480 tasks over
     4,648 files on 64 executors (the ANL/UC testbed) with 1 GiB caches on
     the card, through RuntimeEngine; the kernel must launch once per task,
     and the first 64 results are recomputed with the plain version;
  4. the stack-then-mosaic pipeline at the example's defaults (8 groups x 4
     files on 4 executors); the kernel must launch groups + 1 times and the
     stacks and the mosaic must match the plain version;
  5. serving h2o-danube-3-4b at its published widths in bf16 (random
     weights from a seeded torch.Generator) through the launcher's code
     path (``repro_torch.launch.serve``): the reference launcher's 16
     requests in waves of 8 on 2 replicas.  The flash-attention kernel must
     launch once per layer per wave (48 times), each time the tensor-core
     kernel; on the last wave's tokens
     every layer's attention block is held, flash against the plain
     ``ref`` attention, on the flash forward's own hidden states.  Each
     wave's forward logits against the decode replay's, and the whole
     forward under each attention, are reported: with these random weights
     attention scores reach about 1e3 with near ties, so end to end any
     rounding difference flips a winner somewhere and the logits part;
  6. serving falcon-mamba-7b at its published widths in bf16 (random
     weights from a seeded torch.Generator) through the same launcher code
     path and traffic.  The selective-scan kernel must launch once per
     layer per wave (128 times); on the last wave's tokens every layer's
     mamba block is held, kernel against the plain chunked scan, on the
     kernel forward's own hidden states (within 2e-2 of max|output|).
     Each wave's forward logits against the decode replay's, and the whole
     forward under each scan, are reported: in bf16 the 64 random layers
     amplify one-ulp differences until the logits part.  The last wave
     again with the weights in fp32 holds both comparisons within 2e-2 of
     max|logit|;
  7. training h2o-danube-3-4b at its published widths (3.84 B parameters
     in bf16, AdamW moments in fp32, remat full) through the launcher's code
     path (``repro_torch.launch.train``): 6 steps of 4 x 2048 tokens, the
     batches read through the diffusion pipeline whose executor caches hold
     the shards on the card.  The flash-attention kernel must launch
     2 x 24 x 6 times (each layer's forward and its remat recompute), each
     time the tensor-core kernel; the mean loss over the run's own 6
     batches must be lower at the trained weights than at the initial ones
     (the window means of the per-step losses, each on another batch, are
     reported); the gradient of every attention weight
     of every layer must be finite and non-zero; then 2 layers at full
     width in fp32 take one step with flash and with the plain ``ref``
     attention (loss within 1e-4 relative, each gradient leaf within 2e-2
     of its max|g|), and that state's checkpoint must restore bit for bit.
     Two more steps run under torch.profiler for the card's busy share;
  8. serving qwen3-moe-30b-a3b at its published widths in bf16 (30.5 B
     parameters, 128 experts top-8, random weights from a seeded
     torch.Generator) through the same launcher code path and traffic.
     The flash kernel must launch 2 x 48 times, each on tensor cores; on
     both waves every layer's attention block is held against the plain
     ``ref`` attention and its MoE block (sort+gather routing) against
     ``moe_block_onehot`` (the reference's one-hot formulation) on the
     forward's own hidden states, within 2e-2 of max|output|, and each
     layer's dropped (token, choice) pairs are printed (the padded wave
     overflows some experts' capacity).  Then each wave again with the
     weights widened to fp32, cut to its first 2, 8 and 48 layers at full
     width: the MoE block against the one-hot one on layers 0-1 within
     1e-4, and, on every request that dropped no pair up to its last
     prompt position (there must be one), the forward logits against the
     decode replay's, within 2e-2 of max|logit| at 2 layers and reported
     beyond (and in bf16), beside how far an fp32 forward with flash and
     one with ``ref`` attention drift apart layer by layer: with these
     random weights rounding grows to O(1) with depth.  A profiled decode
     step and the experts' products timed alone give the experts' share
     of the card time against the bound of reading every expert's
     weights.  Then one wave of
     reduced jamba-1.5-large (attention, Mamba, dense and MoE sub-layers)
     through the flash and scan kernels, whose fp32 logits must be within
     2e-2 of max|logit| of the plain path's; the same reduced jamba
     trained 6 steps (8 x 128 tokens) through flash, the scan and the MoE
     layer (each kernel 2 x its layers a step, the loss falling by phase
     7's rule, and in fp32 every gradient leaf of the kernel route within
     2e-2 of its max|g| of the plain route's); and the train_lm app's
     ``moe-30m`` preset trained 6 steps through its pipeline and optimizer:
     the loss must fall by phase 7's rule, the aux loss be finite and
     positive and every layer's router gradient finite and non-zero;
  9. training falcon-mamba-7b at its published widths (d_model 4096,
     d_inner 8192, vocab 65,024) through the launcher's code path with the
     selective-scan kernel in every Mamba forward, at phase 7's traffic,
     its depth cut to 32 of 64 layers (the phase reckons each depth's
     state: all 64 need 87 GB).  The kernel must launch 2 x 32 x 6 times,
     all on one lane layout; the loss must fall by phase 7's rule; every
     Mamba leaf of every layer must get a finite, non-zero gradient; 2
     layers at full width in fp32 hold the kernel route's loss (1e-4
     relative) and gradients (2e-2 of max|g|) to the plain chunked
     scan's.  One more step runs under torch.profiler (the card's busy
     share, its time split into the scan kernel, the plain backward scan,
     the products and the rest), two under remat dots (ms per step, peak
     memory beside remat full's), and the products one forward dispatches
     on the card are listed with what remat dots does with each;
 10. the encoder-decoder and the vision model at their published widths
     and depths in bf16 (random weights from a seeded torch.Generator,
     the stub frontends' embeddings from a numpy seed at the std of the
     embedding table's entries).  whisper-base (6 encoder and 6 decoder
     layers): the encoder over 8 x 1500 frames (6 flash launches, all
     unmasked, on tensor cores), ``make_prefill`` on a 64-token prompt (12
     launches: 6 unmasked, 6 causal; the cross-attention takes the plain
     path, as in the reference), the prompt replayed through
     ``make_serve_step`` against the encoder's output and 8 greedy
     tokens; every self-attention layer, flash against ``ref`` on the
     flash path's own hidden states, within 2e-2 of max|output|; in fp32
     the replay's logits at the last prompt position against
     ``decode_train``'s within 2e-2 of max|logit|.  Then whisper-base
     trained 6 steps of 4 x 448 tokens through the launcher's code path
     (the reference loop's zero frames): 2 x 12 x 6 flash launches, the
     loss falling by phase 7's rule, a finite gradient on every encoder,
     decoder and cross-attention leaf.  Then llava-next-mistral-7b (32
     layers, 7.24 B parameters) at B=2, S=1024 with 576 patch embeddings
     spliced at offset 1: ``make_forward`` and ``make_prefill`` (32 flash
     launches each), every layer's attention against ``ref`` within 2e-2,
     and with another image, position 0's logits bit for bit the same
     and every later position's different.  (llava's training state, 87
     GB, fits no card.)
 11. the stacking workload on an elastic executor pool: Table 2's
     locality-30 row in full (23,695 requests over 790 files, the
     stacking trace's popularity) arriving as a sine wave (mean 395/s,
     amplitude 375/s, period 30 s, two periods on the wall clock) at a pool
     that starts at one 1 GiB-cache executor on the card and that the
     dynamic resource provisioner grows and shrinks (exponential, 1 to 64
     executors, the quickstart's elastic knobs), through RuntimeEngine; each
     request holds its executor for the paper's host time of a request
     (§5.2: radec2xy and a GZ decompress, 42 ms) and then runs the stacking
     kernel (``astro.decode_and_stack``).  Every task must complete; the pool
     must grow in each period and shrink between the peaks; the kernel must
     launch once per completed task plus once per attempt that ran on an
     executor released under it (the provisioner reads the idle set before
     it releases, so a task dispatched in between runs again); no
     provisioning action may fail; the first 64 results must match the
     plain version.  The run is recorded (``ObserveSpec``: lifecycle
     events in a ring of 2^21, a telemetry sample a second): the recorder
     must drop nothing, emit one ``task_done`` per completed task, one
     ``exec_start``/``exec_end`` pair per kernel launch, and ``pool``
     events whose sizes are the report's pool log.  From the events it
     prints the queue wait (dispatch less arrival) as quantiles, split into
     the pool growing (a period's first arrival until the pool first
     reaches that period's peak) and the rest; the telemetry's sample count
     and last merged snapshot; the card's busy share over a 5 s
     torch.profiler window around the first peak; and writes a Chrome
     trace of the run to build/chip_smoke_elastic_trace.json.  Then, with
     the tasks settled, every idle executor but one is released and the
     card's allocated memory must fall by at least the bytes of the
     storages only those executors cached;
 12. training llava-next-mistral-7b at its published widths (d_model
     4096, 32 heads over 8 kv heads of 128, d_ff 14,336, vocab 32,000)
     through the launcher's code path at phase 7's traffic and optimizer,
     with the train loop's zero patch embeddings, its depth cut by
     ``cellrun._depth_variant`` to the most layers whose dry-run peak
     (``cellrun.run_cell`` on the meta device at this shape, with the plain
     ``ref`` attention whose memory the flash op's backward holds) is
     within 0.9 of the card's memory.  The measured peak must be within
     20% of the dry run's; the flash kernel must launch 2 x layers x 6
     times, each on tensor cores; the loss must fall by phase 7's rule.
     One more step runs under torch.profiler for the card's busy share;
 13. serving over diffusion (``ServeDiffusionEngine``, the experiment
     API's ``"serve"`` engine) on the card: 128 multi-turn chat sessions
     of 4 turns (512 requests, each reading its session's prefix pages:
     a Zipf-shared 4-page system prompt and 2 pages a turn) with KV pages
     of h2o-danube-3-4b's published widths (92,160 bytes a token, 64-token
     pages of 5,898,240 bytes; 1,056 pages, 6.23 GB, held in the store as
     host tensors whose first 16 bytes stamp the page's index) on 4
     replicas with 2 GiB caches on the card, replayed batch-synchronously.
     A task fn, a check harness only, holds every input it is given to be
     on the card, of the page's bytes, with its stamp.  Every request must
     complete; kv_summary and every request's replica must equal those of
     the same spec run on the CPU shape-only; the bytes really copied to
     the card must equal the store reads' and the card's allocated memory
     must grow by exactly the distinct storages the caches hold.  Its
     lifecycle events are diffed against the simulator twin's prediction.
     Then the same traffic without the barrier, the replicas working at
     once, so requests take pages from their peers: the bytes copied must
     still equal the store reads' alone (on one card a peer's page is the
     tensor the peer holds) and memory must again grow by the distinct
     storages;
 14. the stacking workload on a fleet (``repro_torch.fleet``): Table 2's
     locality-30 row in full (23,695 requests over 790 files, each request
     writing its 40,000 B coadd to its executor's cache) on host processes
     that share the card, each running executor threads whose 1 GiB
     caches live on the card and ``astro.stack_object`` -- so the stacking
     kernel -- inside the host; peers on other hosts are fetched over real
     sockets.  (a) the trace replayed batch-synchronously (a barrier every
     64 requests) on the in-process runtime with 64 executors and on a
     2-host x 32-thread fleet: no scheduling-determined field of the
     reports and no task's (executor, hits, peer hits, misses) may differ,
     and the kernel must launch once per task in each (the hosts count
     their own launches and report them in their stats frames); (b)
     free-running on 4 x 16: every task completes, the hit ratio is at
     least 0.9 of the ideal 1-1/30, the recorder's forwarded exec spans
     equal the completed attempts and the launches, and the first 64
     coadds, fetched from the hosts' caches through their peer servers,
     match the plain version on the card; it prints tasks/s, the byte
     split (with the cache-to-cache bytes that crossed a socket) and each
     host's device memory; (c) 2 x 8 on the first 4,000 requests, host
     ``h1`` SIGKILLed after 1,000 completions: the run drains with every
     task completed, the victim's executors leave the pool, and its
     process no longer holds device memory in nvidia-smi;
 15. the command line, run as a user types it (``python -m
     repro_torch.apps.<cli>`` subprocesses with ``PYTHONPATH=src``) on the
     first 4,000 requests of phase 14's locality-30 trace, recorded to a
     trace file that the spec files name, shape-only (the CLIs pass no
     payload factory, in the reference as here, so no tensor moves and no
     kernel launches), 1 GiB caches.  (a) ``run_experiment describe`` must
     give the spec's fingerprint, and ``run --engine sim`` the in-process
     simulator's report (``wall_s`` aside); (b) ``run --engine runtime
     --barrier-every 64 --trace-out`` without ``--device`` on 64 executors
     must name the card on stderr as nvidia-smi does, and its report's
     scheduling fields and every task's placement must equal an in-process
     ``RuntimeEngine(device="cuda")`` run's, with no kernel launched;
     ``diff`` on its trace prints the sim twin's divergence; (c) the same
     spec on 2 host processes x 32 threads through the CLI must place every
     task as (b) did, and each host's stats frames must show device memory
     reserved on the card and no kernel launched; (d) ``mk_workload
     generate`` with the sine, Zipf and join flags must write an in-process
     ``record`` of the same generator byte for byte, and ``mk_workload
     run`` replays it on the card; (e) a run with the telemetry plane on
     (an endpoint on a free port and a JSONL sink), paced over about 10 s
     of wall clock: ``monitor --attach --once`` while it runs and
     ``monitor --tail --once`` after it must show the pool of 64, the
     queue depth and, at the end, every request completed; (f) the
     location index's Figure 2 timing (``time_ops`` of 200,000 ops, central
     and 8 shards) and the P-RLS model's aggregate lookups/s at 1 to
     1,000,000 nodes, labelled as host-clock numbers.

Phase 2 runs the stacking kernel at the reference's test shapes and the
main path's (N=8 and N=32 at 100x100), each beside the launch floor (the
kernel at N=1 on one pixel, timed alike), with the host cost of each layer
of an eager call at the flat shape; the flash-attention kernels at the
reference's eight test cases, bf16 cases of the tensor-core kernel
(gemma2-27b's widths at S=512 and S=4096, ragged tiles, a binding window,
MQA, bidirectional), bf16 cases of the SIMT kernel (head dims 20 and 136,
storage off 16 bytes), the
serving forward's shape, a long prefill, the training forward's shape
(4 x 2048), qwen3-moe-30b-a3b's serving shape (D 128, a GQA group of
8), whisper-base's encoder (8 x 1500, D 64, unmasked) and
llava-next-mistral-7b's prefill (2 x 1024, D 128, causal) and training
forward (4 x 2048), each with the kernel it took
(each case must take the kernel ``kernel_path``'s rule gives it, the main
shapes the tensor-core one), its TFLOP/s and share of the bound, the host
cost of each layer of an eager call at the serving shape, and
``scaled_dot_product_attention`` timed beside it as a yardstick only (with
the mask, and with ``is_causal`` where the window does not bind); and
the selective-scan kernel at the reference's four test cases, a chained
pair of halves, the serving forward's shape, a long prefill and the
training forward's shape (4 x 2048), each with the path the shape rule
gave it (``kernel_path``) and its share of the bound, at the main shapes
the other path's time beside it, and the training op's backward (the
plain chunked scan) at one layer of the training shape.
fp32 products on the card run in full fp32: TF32 is switched off for
matmuls and cuDNN before anything runs.

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Any failure raises, so the script exits non-zero and prints no
result.  It needs CUDA and the rest of the checkout, and fails without them.
With ``--json PATH`` it also writes everything it measured to PATH.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: fp32 exp on the special-function units: 16 results per clock per SM,
#: 132 SMs at the 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9

FLAT_TASKS, FLAT_LOCALITY, FLAT_HOSTS = 46_480, 10, 64   # Table 2, ANL/UC
#: phase 11: Table 2's locality-30 row under a sine wave sized by the
#: reference's rule (the peak wants the whole pool, the trough almost none,
#: at 95% amplitude): two periods, about 60 s, on the wall clock
ELASTIC_LOCALITY, ELASTIC_PERIOD_S = 30, 30.0
ELASTIC_ARRIVALS = {"kind": "SineWaveArrivals", "mean_rate": 395.0,
                    "amplitude": 375.0, "period_s": ELASTIC_PERIOD_S,
                    "phase": 0.0}
#: phase 11 records the run: every lifecycle event (23,695 requests x
#: about 7 events, plus pump, pool and provisioner events, in a ring that
#: drops none) and a telemetry sample each second; the card's busy share is
#: read over a profiled window of this length around the first peak
ELASTIC_RING, ELASTIC_METRICS_S, ELASTIC_PROFILE_S = 1 << 21, 1.0, 5.0
#: phase 11's tasks/s over the busy span in two earlier runs without
#: recording (NVIDIA H100 80GB HBM3, 700 W), beside which this run's rate
#: is printed
ELASTIC_UNRECORDED_RATE = (390.9, 392.0)
CHECKED_TASKS = 64
PIPE_GROUPS, PIPE_GROUP_SIZE, PIPE_HOSTS = 8, 4, 4       # example defaults
#: phase 13: multi-turn chat sessions served over diffusion, KV pages of
#: h2o-danube-3-4b's published widths (92,160 bytes a token, 64-token
#: pages), on 4 replicas with 2 GiB caches on the card, replayed
#: batch-synchronously as the reference's serve demo runs
SERVE_DIFFUSION_SESSIONS = {
    "kind": "chat", "n_sessions": 128, "turns_per_session": 4,
    "n_system_prompts": 8, "system_prompt_blocks": 4, "turn_blocks": 2,
    "block": 64, "model": "h2o-danube-3-4b", "think_time_s": 0.0,
    "turn_seconds": 0.0, "arrivals": {"kind": "BatchArrivals", "at_s": 0.0}}
SERVE_DIFFUSION_REPLICAS, SERVE_DIFFUSION_CACHE = 4, 2 << 30
#: phase 14: Table 2's locality-30 row on fleets of host processes that
#: share the card, as (hosts, executor threads per host): the parity run,
#: the free run and the failure run (on the trace's first requests, ``h1``
#: SIGKILLed after that many completions); the task fn each host runs
FLEET_LOCALITY = 30
FLEET_PARITY, FLEET_FREE, FLEET_FAILURE = (2, 32), (4, 16), (2, 8)
FLEET_FAILURE_TASKS, FLEET_KILL_AFTER = 4_000, 1_000
FLEET_TASK_FN = "repro_torch.apps.astro:stack_object"
FLEET_RING = 1 << 21
#: phase 15: the command line on phase 14 (c)'s traffic (the first 4,000
#: requests of the locality-30 trace, shape-only), replayed with a barrier
#: every 64 requests on 64 executors in process and on 2 hosts x 32 threads
#: (a barrier must not exceed the pool for the replay to be deterministic);
#: the observed run paced on the wall clock over about this many seconds so
#: the monitor can attach while it runs; the index timed at the size of
#: benchmarks/bench_index.py's default and the P-RLS model at its node counts
CLI_TASKS, CLI_BARRIER, CLI_FLEET = 4_000, 64, (2, 32)
CLI_OBSERVED_S = 10.0
CLI_DIR = ROOT / "build" / "chip_smoke_cli"
#: the verify recipe's sine, Zipf and join generation flags
MK_TASKS = 1_000
MK_FLAGS = ("--arrivals", "sine", "--popularity", "zipf",
            "--inputs-per-task", 3, "--input-corr", 0.8, "--tasks", MK_TASKS)
INDEX_OPS, INDEX_SHARDS = 200_000, 8
PRLS_NODES = (1, 15, 1_000, 32_000, 1_000_000)

STACKING_TPU_KERNEL = "src/repro/kernels/stacking/stacking.py:26"
STACKING_SOURCE = "src/repro_torch/kernels/stacking/csrc/stack_rois.cu"
FLASH_TPU_KERNEL = "src/repro/kernels/flash_attention/flash_attention.py:35"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
MAMBA_TPU_KERNEL = "src/repro/kernels/mamba_scan/mamba_scan.py:29"
MAMBA_SOURCE = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"

SERVE_ARCH, SERVE_REQUESTS, SERVE_REPLICAS = "h2o-danube-3-4b", 16, 2
SSM_ARCH = "falcon-mamba-7b"
SERVE_POLICY, SERVE_MAX_NEW, SERVE_SEED = "max-compute-util", 8, 0
#: phase 7: h2o-danube-3-4b trained at full width, 4 x 2048 tokens a step
#: (the pipeline's rows are seq_len + 1 tokens) from 16 shards over 4
#: executors, with a 2-step warmup to a peak of 1e-3.  Whether it learns is
#: read on the run's own batches, at the initial and at the trained
#: weights: in 6 steps the per-step losses, each on another batch, move by
#: less than their batch-to-batch spread, so their window means (over the
#: first and last 3 steps, reported) rise or fall with the draw
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "h2o-danube-3-4b", 4, 2047, 6
TRAIN_SHARDS, TRAIN_HOSTS, TRAIN_SEED, TRAIN_WINDOW = 16, 4, 0, 3
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL = 1e-3, 2, 20
#: phase 8: qwen3-moe-30b-a3b served at full width; forward vs decode
#: replay in fp32 at these depths (its first layers, full width), held at
#: the first and reported at the others; reduced jamba as the hybrid
#: check; the train_lm app's moe-30m preset at the app's defaults (batch 8
#: x 128 tokens from 12 shards over 4 executors), TRAIN_STEPS steps
MOE_ARCH, HYBRID_ARCH = "qwen3-moe-30b-a3b", "jamba-1.5-large-398b"
MOE_FP32_DEPTHS = (2, 8, 48)
MOE_TRAIN_PRESET, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = "moe-30m", 8, 128
MOE_TRAIN_HOSTS, MOE_TRAIN_SHARDS = 4, 12
#: phase 9: falcon-mamba-7b trained at full width at phase 7's traffic, its
#: 64 layers cut to this many (the phase reckons the state of each depth:
#: 64 layers need 87 GB, more than the card); then SSM_DOTS_STEPS more
#: steps under remat dots
SSM_TRAIN_LAYERS, SSM_DOTS_STEPS = 32, 2
#: phase 10: whisper-base at its published widths and depth: the encoder
#: over 8 x 1500 frames (the reference's 30 s window), a 64-token decoder
#: prompt replayed through the serve step, 8 greedy tokens; trained 6
#: steps of 4 x 448 tokens (the pipeline's rows are seq_len + 1 tokens) at
#: phase 7's optimizer without its gradient clip (at the initial weights
#: the encoder's gradient, norm ~4e5 with the loop's zero frames, makes a
#: clip at 1.0 shrink every other gradient under Adam's eps, so in 6 steps
#: neither package's whisper-base learns); the replay against
#: ``decode_train`` in fp32 at these depths (encoder and decoder cut
#: alike, full width), held at the first and reported at the others (the
#: random weights' rounding grows with depth, as in phase 8);
#: llava-next-mistral-7b at B=2, S=1024, its 576 patch embeddings spliced
#: at offset 1
ENCDEC_ARCH, VISION_ARCH = "whisper-base", "llava-next-mistral-7b"
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_NEW = 8, 1500, 64, 8
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 4, 447
ENCDEC_TRAIN_CLIP = float("inf")
ENCDEC_FP32_DEPTHS = (2, 3, 6)
VISION_BATCH, VISION_SEQ = 2, 1024
#: phase 12: llava-next-mistral-7b trained at its published widths at
#: phase 7's traffic, its 32 layers cut by ``cellrun._depth_variant`` to
#: the most whose dry-run peak at this shape (``run_cell`` on the meta
#: device, ``attn_impl="ref"``: the fp32 attention the flash op's backward
#: recomputes) is within VISION_TRAIN_BUDGET of the card's memory; the
#: measured peak must be within VISION_PEAK_BAND of the dry run's
VISION_TRAIN_BUDGET, VISION_PEAK_BAND = 0.9, 0.2
#: flash cases: (label, B, S, H, KV, D, causal, window, softcap, dtype[,
#: offset]): the reference's eight (tests/test_kernels.py), cases beyond
#: them, then the shapes the serving and training paths give the kernel at
#: h2o-danube-3-4b's widths and the serving path at qwen3-moe-30b-a3b's.
#: ``offset`` starts each tensor's storage that many elements past an
#: aligned one.
FLASH_CASES = [
    ("test", 2, 64, 4, 2, 16, True, 0, 0.0, "float32"),
    ("test SWA", 1, 128, 8, 2, 32, True, 32, 0.0, "float32"),
    ("test softcap", 2, 64, 4, 4, 24, True, 0, 50.0, "float32"),
    ("test MQA", 1, 256, 4, 1, 16, True, 0, 0.0, "float32"),
    ("test ragged", 2, 96, 4, 2, 16, True, 0, 0.0, "float32"),
    ("test bidirectional", 1, 64, 4, 2, 16, False, 0, 0.0, "float32"),
    ("test SWA+softcap", 2, 64, 4, 2, 16, True, 16, 30.0, "float32"),
    ("test MHA bf16", 2, 64, 8, 8, 16, True, 0, 0.0, "bfloat16"),
    # bf16 inputs the tensor-core kernel takes, beyond the main shapes:
    # gemma2-27b's widths (Dh 128, softcap 50, window 4096), ragged tiles
    # at Dh 120, a window that binds at short S, MQA and bidirectional
    ("tc gemma2-27b", 1, 512, 32, 16, 128, True, 4096, 50.0, "bfloat16"),
    ("tc S=1", 8, 1, 32, 8, 120, True, 4096, 0.0, "bfloat16"),
    ("tc S=63", 8, 63, 32, 8, 120, True, 4096, 0.0, "bfloat16"),
    ("tc S=200", 8, 200, 32, 8, 120, True, 4096, 0.0, "bfloat16"),
    ("tc window 32", 2, 200, 32, 8, 120, True, 32, 0.0, "bfloat16"),
    ("tc MQA", 1, 256, 32, 1, 120, True, 0, 0.0, "bfloat16"),
    ("tc bidirectional", 1, 256, 16, 4, 128, False, 0, 0.0, "bfloat16"),
    # gemma2-27b's prefill at S=4096, with its softcap and without (the
    # softcap's tanh is the difference; SDPA has no softcap)
    ("tc gemma2-27b S=4096", 1, 4096, 32, 16, 128, True, 4096, 50.0,
     "bfloat16"),
    ("tc gemma2-27b S=4096 no softcap", 1, 4096, 32, 16, 128, True, 4096,
     0.0, "bfloat16"),
    # bf16 the tensor-core kernel does not take, on the SIMT kernel: a head
    # dim that is not a multiple of 8, one above 128, storage off 16 bytes
    ("simt bf16 D=20", 1, 77, 4, 2, 20, True, 0, 0.0, "bfloat16"),
    ("simt bf16 D=136", 2, 130, 4, 1, 136, True, 64, 30.0, "bfloat16"),
    ("simt bf16 misaligned", 2, 150, 8, 2, 120, True, 64, 0.0, "bfloat16",
     1),
    ("main/serve", 8, 96, 32, 8, 120, True, 4096, 0.0, "bfloat16"),
    ("main/prefill", 1, 8192, 32, 8, 120, True, 4096, 0.0, "bfloat16"),
    ("main/train", 4, 2048, 32, 8, 120, True, 4096, 0.0, "bfloat16"),
    ("main/serve qwen3-moe", 8, 96, 32, 4, 128, True, 0, 0.0, "bfloat16"),
    # phase 10: whisper-base's encoder self-attention (unmasked; S=1500
    # leaves a ragged last 128-key tile) and llava's prefill
    ("main/encoder whisper-base", 8, 1500, 8, 8, 64, False, 0, 0.0,
     "bfloat16"),
    ("main/prefill llava", 2, 1024, 32, 8, 128, True, 0, 0.0, "bfloat16"),
    # phase 12: llava's training forward (4 x 2048, causal, no window)
    ("main/train llava", 4, 2048, 32, 8, 128, True, 0, 0.0, "bfloat16"),
]
#: the main path's flash cases: each must take the tensor-core kernel
FLASH_MAIN = ("main/serve", "main/prefill", "main/train",
              "main/serve qwen3-moe", "main/encoder whisper-base",
              "main/prefill llava", "main/train llava")
#: query rows per chunk of the plain version at long lengths (bounds its
#: (Sq, Sk) score tensor)
FLASH_PLAIN_Q_CHUNK = 1024
#: selective-scan cases: (label, B, S, I, N, h0); the reference's four
#: (tests/test_kernels.py, with its h0 = 0.05), then the shapes the serving
#: and training forwards give the kernel at falcon-mamba-7b's widths (no
#: h0): the launcher's waves (B=8, S=96), one 4096-token prefill and the
#: training batch of phase 9 (4 x 2048)
MAMBA_CASES = [
    ("test", 1, 32, 16, 4, True),
    ("test", 2, 96, 48, 8, True),
    ("test", 2, 128, 64, 16, True),
    ("test ragged", 1, 50, 24, 4, True),
    ("main/serve", 8, 96, 8192, 16, False),
    ("main/prefill", 1, 4096, 8192, 16, False),
    ("main/train", 4, 2048, 8192, 16, False),
]
#: falcon-mamba-7b's dt_rank: Bm and Cm are column slices of a projection
#: (B, S, DT_RANK + 2N) on the main path
MAMBA_DT_RANK = 256
MAMBA_TOL = dict(atol=2e-4, rtol=1e-3)   # the reference's, y and h_last


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(label: str, got: torch.Tensor, want: torch.Tensor,
                exact: bool = False) -> tuple[float, float]:
    """Hold ``got`` to ``want``: rtol 1e-5 and atol 1e-5 * max|want| (the
    reference's own stacking tolerance), or bit equality with ``exact``.
    Returns (max abs error, max rel error); raises on a mismatch."""
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite values")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    if exact:
        ok = max_abs == 0.0
    else:
        atol = 1e-5 * float(want.abs().max())
        ok = bool((err <= atol + 1e-5 * want.abs()).all())
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             f"version (max abs {max_abs}, max rel {max_rel})")
    return max_abs, max_rel


def host_ms(fn, reps: int = 30, inner: int = 50) -> float:
    """Per-call time of ``inner`` eager back-to-back calls (CUDA events,
    median over ``reps``, after a warm-up).  Where the host takes longer to
    issue a call than the card to run it, this is the host's time."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, reps: int = 30, inner: int = 50) -> float:
    """Per-call device time: ``inner`` calls captured in one CUDA graph and
    replayed ``reps`` times (CUDA events, median), so the host's cost of
    issuing each call is out of the measurement.  Inputs stay in L2 between
    calls, as they do on the main path, where a task's tiles were just
    written."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def stacking_bound(n: int, h: int, w: int) -> tuple[float, str]:
    """Least time (ms) the card could take for one stacking call, and what
    sets it: each input read once (ROIs and the four per-ROI scalars) and
    the output written once, over HBM bandwidth; against 10 fp32 operations
    per ROI pixel (calibrate 2, bilinear blend 7, accumulate 1) plus the
    division for the mean, over the fp32 peak outside the tensor cores."""
    bytes_moved = 4 * n * h * w + 4 * 4 * n + 4 * h * w
    ops = 10 * n * h * w + h * w
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def coadd_bound(n: int, h: int, w: int) -> float:
    """Least time (ms) the card could take for one one-call coadd: the prep
    kernel and the stacking kernel each read the (N, H, W) tiles once, the
    prep kernel writes 4N scalars that the stacking kernel reads, and the
    output is written once, over HBM bandwidth (the operations, ~11 a
    pixel, take a tenth of that)."""
    return (2 * 4 * n * h * w + 2 * 16 * n + 4 * h * w) / HBM_BYTES_PER_S \
        * 1e3


def flash_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Valid (query, key) pairs of one head under the masks."""
    q = np.arange(sq, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros_like(q)
    hi = np.minimum(q, sk - 1) if causal else np.full_like(q, sk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound(b: int, s: int, h: int, kv: int, d: int, causal: bool,
                window: int, softcap: float, dtype: str) -> tuple[float, str]:
    """Least time (ms) the card could take for one attention call, and what
    sets it: q, k, v read once and the output written once, over HBM
    bandwidth; against the larger of two operation counts: 4·D FLOPs (two
    products) per valid (q, k) pair and head over the peak for the inputs'
    type (bf16 tensor cores, or the fp32 pipes: an fp32 product in full
    precision has no tensor-core path), and one exp per valid pair and
    head, plus one tanh with a softcap, on the special-function units."""
    es = 2 if dtype == "bfloat16" else 4
    bytes_moved = es * d * (2 * b * h * s + 2 * b * kv * s)
    pairs = b * h * flash_pairs(s, s, causal, window)
    peak = BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(4 * d * pairs / peak,
                pairs * (2 if softcap > 0 else 1) / SFU_EXP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mamba_scan_bound(b: int, s: int, i: int, n: int,
                     h0: bool = False) -> tuple[float, str]:
    """Least time (ms) for one selective scan at (B, S, I, N), all fp32:
    the largest of three terms.  Bytes: u, dt, A, Bm, Cm, D (and h0 where
    one is given; the forward passes none) read once and y, h_last written
    once, over HBM bandwidth.  fp32 operations: 6 per (t, i, n) (dt·A, ·h,
    +dBu, ·B, ·C, the sum over n) and 3 per (t, i) (dt·u, u·D, the add),
    over the fp32 peak.  exps: one per (t, i, n), B·S·I·N in all, on the
    special-function units (16 per clock per SM).  At falcon-mamba-7b's
    widths the exp term is the largest (at the serving shape the bytes
    come within 1% of it); a polynomial exp on the FMA pipes would ease
    that term."""
    bytes_moved = 4 * (3 * b * s * i + i * n + 2 * b * s * n + i
                       + b * i * n * (2 if h0 else 1))
    ops = b * s * i * (6 * n + 3)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / FP32_OPS_PER_S, b * s * i * n / SFU_EXP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 1: environment and build
# --------------------------------------------------------------------------

def phase_environment() -> dict:
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.monotonic()
    took = build.build_all()
    total = time.monotonic() - t0
    for name, secs in took.items():
        log(f"[build] {name}: nvcc {secs:.2f}s -> "
            f"{build.library_path(name).relative_to(ROOT)}")
        ptxas = build.library_path(name).with_suffix(".log")
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels built in {total:.2f}s (wall)")
    return {"nvidia_smi": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": took,
            "build_wall_s": total}


# --------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# --------------------------------------------------------------------------

def _stacking_inputs(n: int, h: int, w: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(500, 100, (n, h, w)), rng.normal(0, 10, n),
            rng.uniform(0.5, 1.5, n), rng.uniform(0, 1, n),
            rng.uniform(0, 1, n))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


def phase_kernels() -> dict:
    from repro_torch.kernels.stacking.ref import stack_rois_ref
    from repro_torch.kernels.stacking.stacking import stack_rois_fwd

    dev = torch.device("cuda", 0)

    def plain(rois, sky, cal, dy, dx, mean):
        out = stack_rois_ref(rois, sky, cal, dy, dx)
        return out / rois.shape[0] if mean else out

    cases = []
    # the reference's test shapes (tests/test_kernels.py), sum only
    for i, (n, h, w) in enumerate([(8, 16, 16), (37, 24, 40),
                                   (100, 100, 100), (3, 8, 8)]):
        cases.append((f"test N={n} {h}x{w}", _stacking_inputs(n, h, w, i, dev),
                      False, False))
    # dy = dx = 0 must be the exact calibrated sum
    rois = torch.arange(2 * 4 * 4, dtype=torch.float32, device=dev) \
        .reshape(2, 4, 4)
    z, o = torch.zeros(2, device=dev), torch.ones(2, device=dev)
    cases.append(("exact-sum N=2 4x4 dy=dx=0", [rois, z, o, z, z], False, True))
    # the main path's shapes: flat task, pipeline stack task, mosaic task
    main_shapes = {"flat": (8, 100, 100), "stack": (32, 100, 100),
                   "mosaic": (PIPE_GROUPS, 100, 100)}
    for j, (label, (n, h, w)) in enumerate(main_shapes.items()):
        args = _stacking_inputs(n, h, w, 100 + j, dev)
        if label == "mosaic":
            zn, on = torch.zeros(n, device=dev), torch.ones(n, device=dev)
            args = [args[0], zn, on, zn, zn]
        cases.append((f"main/{label} N={n} {h}x{w}", args, True, False))

    # the launch floor: the kernel at N=1 on one pixel, timed as the cases
    # are (one block, one load per input), the least a call can cost here
    floor_args = _stacking_inputs(1, 1, 1, 99, dev)
    floor_ms = device_ms(lambda: stack_rois_fwd(*floor_args))
    log(f"[kernel] stack_rois launch floor (N=1 1x1, same graph harness): "
        f"{floor_ms * 1e3:.3f} us")
    rows = []
    for label, args, mean, exact in cases:
        got = stack_rois_fwd(*args, mean=mean)
        want = plain(*args, mean)
        torch.cuda.synchronize()
        max_abs, max_rel = check_close(label, got, want, exact=exact)
        if exact:
            check_close(label + " vs sum", got, args[0].sum(0), exact=True)
        n, h, w = args[0].shape
        kernel = lambda: stack_rois_fwd(*args, mean=mean)  # noqa: E731
        plain_fn = lambda: plain(*args, mean)  # noqa: E731
        k_ms, p_ms = device_ms(kernel), device_ms(plain_fn)
        k_host, p_host = host_ms(kernel), host_ms(plain_fn)
        bound_ms, bound_by = stacking_bound(n, h, w)
        row = {"case": label, "shape": [n, h, w], "mean": mean,
               "max_abs_err": max_abs, "max_rel_err": max_rel,
               "ms": k_ms, "plain_ms": p_ms, "host_ms": k_host,
               "plain_host_ms": p_host, "bound_ms": bound_ms,
               "bound_by": bound_by, "launch_floor_ms": floor_ms}
        rows.append(row)
        log(f"[kernel] stack_rois {label}: max abs err {max_abs:.3g} "
            f"max rel err {max_rel:.3g} | device: kernel "
            f"{k_ms * 1e3:.3f} us ({k_ms / floor_ms:.2f}x the launch "
            f"floor), plain {p_ms * 1e3:.3f} us, bound "
            f"{bound_ms * 1e3:.3f} us ({bound_by}) | eager per call: kernel "
            f"{k_host * 1e3:.2f} us, plain {p_host * 1e3:.2f} us")
        if label.startswith("main/flat"):
            row["host_costs_us"] = _stacking_host_costs(*args)
            log("[kernel] stack_rois main/flat host us per call: "
                + ", ".join(f"{n} {t:.2f}"
                            for n, t in row["host_costs_us"].items()))
    log("[kernel] stack_rois: no single PyTorch call computes this function "
        "(calibrate + bilinear shift + coadd), so there is no library "
        "yardstick (library_ms null)")
    return {"stack_rois": rows, "coadd": _coadd_rows(dev)}


def _coadd_rows(dev) -> list[dict]:
    """The app's one-call coadd (``stacking.coadd_fwd``: the prep kernel,
    then the stacking kernel) at the main path's shapes: the CLI's flat
    file (8 tiles), the pipeline's stack (32) and the benchmark's file
    (150).  Each is held to the plain version of the app's coadd and timed
    beside it, beside the stacking kernel alone on the same scalars (the
    prep kernel's share is the difference) and against ``coadd_bound``;
    eager, against the former path (``coadd_params`` + the stacking op)."""
    from repro_torch.apps import astro
    from repro_torch.kernels.stacking import ops as st_ops
    from repro_torch.kernels.stacking.ref import stack_rois_ref
    from repro_torch.kernels.stacking.stacking import (coadd_fwd,
                                                       stack_rois_fwd)

    rows = []
    for j, (n, h, w) in enumerate([(8, 100, 100), (32, 100, 100),
                                   (150, 100, 100)]):
        ids = [200 + j]
        tiles = _stacking_inputs(n, h, w, 200 + j, dev)[0]
        shifts = astro.draw_shifts(ids, n)
        params = astro.coadd_params(tiles, ids)
        got = coadd_fwd(tiles, shifts, astro.SKY_FRACTION)
        want = stack_rois_ref(tiles, *params) / n
        torch.cuda.synchronize()
        label = f"coadd N={n} {h}x{w}"
        max_abs, max_rel = check_close(label, got, want)
        ones = torch.ones(n, device=dev)
        dy, dx = torch.from_numpy(shifts).to(dev)

        def one_call():
            return coadd_fwd(tiles, shifts, astro.SKY_FRACTION)

        def plain():
            sky = tiles.mean(dim=(1, 2)) * astro.SKY_FRACTION
            return stack_rois_ref(tiles, sky, ones, dy, dx) / n

        def stack_alone():
            return stack_rois_fwd(tiles, *params)

        def former():
            return st_ops.stack_rois(tiles, *astro.coadd_params(tiles, ids))

        k_ms, p_ms, s_ms = (device_ms(one_call), device_ms(plain),
                            device_ms(stack_alone))
        k_host, f_host = host_ms(one_call), host_ms(former)
        bound_ms = coadd_bound(n, h, w)
        rows.append({"case": label, "shape": [n, h, w],
                     "max_abs_err": max_abs, "max_rel_err": max_rel,
                     "ms": k_ms, "plain_ms": p_ms, "stack_alone_ms": s_ms,
                     "prep_ms": k_ms - s_ms, "host_ms": k_host,
                     "former_host_ms": f_host, "bound_ms": bound_ms,
                     "bound_by": "bytes"})
        log(f"[kernel] one-call {label}: max abs err {max_abs:.3g} max rel "
            f"err {max_rel:.3g} | device: prep + stack {k_ms * 1e3:.3f} us "
            f"(stack alone {s_ms * 1e3:.3f} us, so prep "
            f"{(k_ms - s_ms) * 1e3:.3f} us), plain {p_ms * 1e3:.3f} us, "
            f"bound {bound_ms * 1e3:.3f} us (bytes) | eager per call: one "
            f"call {k_host * 1e3:.2f} us, former path {f_host * 1e3:.2f} us")
    return rows


def _host_us(calls: dict, n: int = 2000) -> dict:
    """Host time per call (µs, the host's clock over ``n`` calls after a
    warm-up) of each named zero-argument function."""
    costs = {}
    for name, fn in calls.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        costs[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return costs


def _stacking_host_costs(rois, sky, cal, dy, dx) -> dict:
    """Host time per call (µs) of each layer of an eager stacking call at
    these inputs: the wrapper's checks, the output's allocation, the
    stream lookup (the raw one the wrapper makes, and through a Stream
    object, for comparison), the C entry point alone (``data_ptr`` reads
    included), the wrapper ``stack_rois_fwd`` and the op
    ``ops.stack_rois``."""
    from repro_torch.kernels.stacking import ops as st_ops
    from repro_torch.kernels.stacking import stacking as st

    n, h, w = rois.shape
    idx = rois.get_device()
    out = torch.empty((h, w), dtype=torch.float32, device=rois.device)
    stream = torch.cuda.current_stream(rois.device).cuda_stream
    entry = st._entry()
    return _host_us({
        "checks": lambda: st.check_inputs(rois, sky, cal, dy, dx),
        "new_empty": lambda: rois.new_empty((h, w)),
        "stream": lambda: torch._C._cuda_getCurrentRawStream(idx),
        "stream object": lambda: torch.cuda.current_stream(
            rois.device).cuda_stream,
        "entry": lambda: entry(rois.data_ptr(), sky.data_ptr(),
                               cal.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                               out.data_ptr(), n, h, w, 1, idx, stream),
        "stack_rois_fwd": lambda: st.stack_rois_fwd(rois, sky, cal, dy, dx,
                                                    mean=True),
        "op": lambda: st_ops.stack_rois(rois, sky, cal, dy, dx, mean=True)})


def _expected_flash_path(d: int, dtype: str, offset: int) -> str:
    """The kernel the wrapper must pick for these inputs (the cases'
    tensors are dense, with strides of whole rows of heads): tensor cores
    for bf16 with head_dim a multiple of 8 up to 128 whose storage starts
    16-byte aligned, else the SIMT kernel."""
    return ("wgmma" if dtype == "bfloat16" and d % 8 == 0 and d <= 128
            and (2 * offset) % 16 == 0 else "simt")


def _flash_host_costs(q, k, v) -> dict:
    """Host time per call (µs, the host's clock over 200 calls) of each
    layer of an eager flash call at these (B,S,H,D) inputs: the path
    choice, the tensor-core and the SIMT C entry points alone (the
    tensor-core one also encodes three tensor maps), the wrapper
    ``flash_attention_fwd`` and the op in the model's layout."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = torch.empty_like(qt)

    def entry(path):
        args = fa._launch_args(path, qt, kt, vt, out, True, 0, 0.0)
        fn = fa._entry(path)
        return lambda: fn(*args)

    calls = {"kernel_path": lambda: fa.kernel_path(qt, kt, vt),
             "entry_wgmma": entry("wgmma"), "entry_simt": entry("simt"),
             "flash_attention_fwd": lambda: fa.flash_attention_fwd(qt, kt,
                                                                   vt),
             "op": lambda: fa_ops.flash_attention(q, k, v)}
    return _host_us(calls, 200)


def phase_flash_kernel() -> list[dict]:
    """The flash-attention kernels against their plain version on the card,
    with ``scaled_dot_product_attention`` timed beside them (a yardstick the
    port never calls; none exists for a softcap): with the boolean mask, and
    where the window does not bind also with ``is_causal`` (or no mask when
    bidirectional), which computes the same function; ``library_ms`` is the
    faster of the two."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dev = torch.device("cuda", 0)
    rows = []
    for i, (label, b, s, h, kv, d, causal, window, softcap, dtype,
            *offset) in enumerate(FLASH_CASES):
        offset = offset[0] if offset else 0
        rng = np.random.default_rng(200 + i)
        tdt = getattr(torch, dtype)
        q, k, v = (torch.empty(int(np.prod(shape)) + offset, dtype=tdt,
                               device=dev)[offset:].view(shape).copy_(
            torch.from_numpy(rng.standard_normal(shape, np.float32)))
                   for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        chunk = FLASH_PLAIN_Q_CHUNK if s > FLASH_PLAIN_Q_CHUNK else 0
        long = s > FLASH_PLAIN_Q_CHUNK
        kernel = lambda: fa_ops.flash_attention(  # noqa: E731
            q, k, v, causal=causal, window=window, softcap=softcap)
        plain = lambda: attention_ref(  # noqa: E731
            qt, kt, vt, causal=causal, window=window, softcap=softcap,
            q_chunk=chunk).transpose(1, 2)
        before = {p: c.value for p, c in fa.path_launches.items()}
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        took = [p for p, c in fa.path_launches.items()
                if c.value != before[p]]
        path = took[0] if len(took) == 1 else f"?{took}"
        expected = _expected_flash_path(d, dtype, offset)
        if path != expected:
            raise AssertionError(f"flash {label}: took the {path} kernel, "
                                 f"expected {expected}")
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash {label}: non-finite output")
        err = (got.float() - want.float()).abs()
        max_abs = float(err.max())
        if not bool((err <= tol + tol * want.float().abs()).all()):
            raise AssertionError(f"flash {label}: kernel disagrees with the "
                                 f"plain version (max abs {max_abs}, "
                                 f"tolerance {tol})")
        reps, inner = (3, 3) if long else (30, 50)
        k_ms = device_ms(kernel, reps, inner)
        p_ms = device_ms(plain, reps, min(inner, 2) if long else inner)
        k_host = host_ms(kernel, reps, inner)
        lib_ms = lib_err = flag_ms = None
        if softcap == 0.0:
            qp = torch.arange(s, device=dev)[:, None]
            kp = torch.arange(s, device=dev)[None, :]
            mask = torch.ones(s, s, dtype=torch.bool, device=dev)
            if causal:
                mask &= kp <= qp
            if window > 0:
                mask &= kp > qp - window
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
            lib_err = float((library().transpose(1, 2).float()
                             - want.float()).abs().max())
            lib_ms = device_ms(library, reps, inner)
            if window == 0 or window >= s:
                flagged = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
                lib_err = max(lib_err, float(
                    (flagged().transpose(1, 2).float()
                     - want.float()).abs().max()))
                flag_ms = device_ms(flagged, reps, inner)
        bound_ms, bound_by = flash_bound(b, s, h, kv, d, causal, window,
                                         softcap, dtype)
        flops = 4 * b * h * d * flash_pairs(s, s, causal, window)
        row = {"case": label, "shape": [b, s, h, kv, d], "causal": causal,
               "window": window, "softcap": softcap, "dtype": dtype,
               "offset": offset,
               "path": path, "max_abs_err": max_abs, "tolerance": tol,
               "ms": k_ms, "plain_ms": p_ms, "host_ms": k_host,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / k_ms,
               "tflops": flops / (k_ms * 1e-3) / 1e12,
               "library_ms": (None if lib_ms is None else
                              min(x for x in (lib_ms, flag_ms)
                                  if x is not None)),
               "sdpa_mask_ms": lib_ms, "sdpa_flag_ms": flag_ms,
               "library_max_abs_err": lib_err}
        rows.append(row)
        if lib_ms is None:
            lib = "none (softcap)"
        else:
            lib = (f"{lib_ms * 1e3:.3f} us with the mask"
                   + ("" if flag_ms is None else
                      f", {flag_ms * 1e3:.3f} us with is_causal={causal}")
                   + f" (max abs err {lib_err:.3g})")
        log(f"[kernel] flash_attention {label} B={b} S={s} H={h} KV={kv} "
            f"D={d} {dtype} causal={causal} window={window} "
            f"softcap={softcap}: {path} kernel, max abs err {max_abs:.3g} "
            f"(tol {tol}) | device: kernel {k_ms * 1e3:.3f} us "
            f"({row['tflops']:.1f} TFLOP/s, {row['bound_share']:.3f} of the "
            f"bound), plain {p_ms * 1e3:.3f} us, sdpa {lib}, bound "
            f"{bound_ms * 1e3:.3f} us ({bound_by}) | eager per call: kernel "
            f"{k_host * 1e3:.2f} us")
        if label == "main/serve":
            row["host_costs_us"] = _flash_host_costs(q, k, v)
            log("[kernel] flash_attention main/serve host us per call: "
                + ", ".join(f"{n} {t:.2f}"
                            for n, t in row["host_costs_us"].items()))
    for label in FLASH_MAIN:
        row = next(r for r in rows if r["case"] == label)
        if row["path"] != "wgmma":
            raise AssertionError(f"flash {label} took the {row['path']} "
                                 f"kernel, not the tensor-core one")
    return rows


def _scan_inputs(b: int, s: int, i: int, n: int, h0: bool, seed: int,
                 dev) -> dict:
    """The reference test's distributions on the card: u, dt =
    softplus(normal), A = -exp(0.5·normal), Bm, Cm, D, h0 = 0.05.  Bm and
    Cm are column slices of a projection (B, S, DT_RANK + 2N), as the model
    passes them."""
    g = torch.Generator(dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)

    proj = normal(b, s, MAMBA_DT_RANK + 2 * n)
    arrs = {"u": normal(b, s, i),
            "dt": torch.nn.functional.softplus(normal(b, s, i)),
            "A": -torch.exp(normal(i, n) * 0.5),
            "Bm": proj[..., MAMBA_DT_RANK: MAMBA_DT_RANK + n],
            "Cm": proj[..., MAMBA_DT_RANK + n:], "D": normal(i)}
    if h0:
        arrs["h0"] = torch.full((b, i, n), 0.05, device=dev)
    return arrs


def _scan_err(label: str, got, want) -> float:
    """Hold y and h_last to the plain version at the reference's
    tolerance; returns the max abs error."""
    worst = 0.0
    for name, g, w in zip(("y", "h_last"), got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"scan {label} {name}: shape "
                                 f"{tuple(g.shape)} or non-finite values")
        err = (g - w).abs()
        worst = max(worst, float(err.max()))
        if bool((err > MAMBA_TOL["atol"]
                 + MAMBA_TOL["rtol"] * w.abs()).any()):
            raise AssertionError(
                f"scan {label} {name}: kernel disagrees with the plain "
                f"version (max abs {float(err.max())}, tolerance "
                f"{MAMBA_TOL})")
    return worst


def _scan_path_ms(path: str, arrs: dict, want, label: str,
                  reps: tuple[int, int]) -> float:
    """Device time per call of the scan kernel on ``path`` whatever the
    shape rule says, after holding its result to the plain version's
    ``want``.  Its launches are counted as any other (phase 2 runs before
    the counters are reset for the main path)."""
    from repro_torch.kernels.mamba_scan import mamba_scan as ms

    rule = ms.kernel_path
    ms.kernel_path = lambda b, i: path
    try:
        _scan_err(f"{label} on the {path} path", ms.mamba_scan_fwd(**arrs),
                  want)
        return device_ms(lambda: ms.mamba_scan_fwd(**arrs), *reps)
    finally:
        ms.kernel_path = rule


def _scan_backward(arrs: dict, reps: int = 3) -> dict:
    """The training op's backward at one layer of the training shape: the
    plain chunked scan's VJP (``mamba_scan_with_ref_vjp``, in chunks of
    falcon-mamba-7b's ``ssm_chunk``), host wall per backward (median of
    ``reps`` after one warm-up, each ending in a synchronise), then one
    more under torch.profiler for its kernels and card time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import ops as ms_ops

    chunk = get_config(SSM_ARCH).ssm_chunk
    ins = {k: v.detach().clone().requires_grad_() for k, v in arrs.items()}
    gy = torch.randn_like(ins["u"])
    y, _ = ms_ops.mamba_scan_with_ref_vjp(**ins, chunk=chunk)

    def backward():
        torch.autograd.grad(y, list(ins.values()), gy, retain_graph=True)
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        backward()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    b, s, i = arrs["u"].shape
    row = {"case": "main/train backward (plain chunked scan)",
           "shape": [b, s, i, arrs["A"].shape[1]], "chunk": chunk,
           "host_ms": statistics.median(times[1:]) * 1e3,
           "host_ms_all": [t * 1e3 for t in times],
           "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
           "kernels": sum(e.count for e in kernels)}
    log(f"[kernel] mamba_scan main/train backward B={b} S={s} I={i} N="
        f"{row['shape'][3]}, the plain chunked scan in chunks of {chunk} "
        f"(one layer): {row['host_ms']:.1f} ms a backward "
        f"(host wall, median of {reps}), card busy {row['device_ms']:.1f} "
        f"ms over {row['kernels']} kernels (profiled)")
    return row


def phase_mamba_kernel() -> list[dict]:
    """The selective-scan kernel against its plain version on the card (no
    single PyTorch call computes a selective scan: no library yardstick)."""
    from repro_torch.kernels.mamba_scan import mamba_scan as ms
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

    dev = torch.device("cuda", 0)
    rows = []
    for k, (label, b, s, i, n, h0) in enumerate(MAMBA_CASES):
        arrs = _scan_inputs(b, s, i, n, h0, 300 + k, dev)
        kernel = lambda: ms_ops.mamba_scan(**arrs)  # noqa: E731
        plain = lambda: mamba_scan_ref(**arrs)  # noqa: E731
        before = {p: c.value for p, c in ms.path_launches.items()}
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        took = [p for p, c in ms.path_launches.items()
                if c.value != before[p]]
        path = took[0] if len(took) == 1 else f"?{took}"
        if path != ms.kernel_path(b, i):
            raise AssertionError(f"scan {label}: took the {path} path, the "
                                 f"rule gives {ms.kernel_path(b, i)}")
        max_abs = _scan_err(label, got, want)
        long = s > 1024
        reps = (10, 10) if long else (30, 50)
        k_ms = device_ms(kernel, *reps)
        # the plain version is a loop over S: a few repetitions
        p_ms = device_ms(plain, *((3, 1) if long else (5, 3)))
        k_host = host_ms(kernel, *((5, 5) if long else (30, 50)))
        bound_ms, bound_by = mamba_scan_bound(b, s, i, n, h0)
        row = {"case": label, "shape": [b, s, i, n], "h0": h0,
               "path": path, "max_abs_err": max_abs, "tolerance": MAMBA_TOL,
               "ms": k_ms, "plain_ms": p_ms, "host_ms": k_host,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / k_ms, "library_ms": None}
        other = ""
        if label.startswith("main/"):
            # the path the rule did not pick, on the same inputs: the
            # reason for the rule at the main shapes
            row["other_path"] = next(p for p in ms.LANES if p != path)
            row["other_path_ms"] = _scan_path_ms(row["other_path"], arrs,
                                                 want, label, reps)
            other = (f", the {row['other_path']} path "
                     f"{row['other_path_ms'] * 1e3:.3f} us")
        rows.append(row)
        log(f"[kernel] mamba_scan {label} B={b} S={s} I={i} N={n} "
            f"h0={h0}: {path} path, max abs err {max_abs:.3g} (atol 2e-4, "
            f"rtol 1e-3, y and h_last) | device: kernel {k_ms * 1e3:.3f} us "
            f"({row['bound_share']:.3f} of the bound){other}, plain "
            f"{p_ms * 1e3:.3f} us, bound {bound_ms * 1e3:.3f} us "
            f"({bound_by}) | eager per call: kernel {k_host * 1e3:.2f} us")
    rows.append(_scan_backward(_scan_inputs(4, 2048, 8192, 16, False, 398,
                                            dev)))
    # state chaining (tests/test_kernels.py): two halves, h_last carried
    # over as h0, give the whole
    arrs = _scan_inputs(1, 64, 16, 8, False, 399, dev)
    halves = [{k: (v[:, sl] if v.dim() == 3 else v) for k, v in arrs.items()}
              for sl in (slice(0, 32), slice(32, 64))]
    y_full, h_full = ms.mamba_scan_fwd(**arrs)
    y1, h1 = ms.mamba_scan_fwd(**halves[0])
    y2, h2 = ms.mamba_scan_fwd(**halves[1], h0=h1)
    want = mamba_scan_ref(**arrs)
    torch.cuda.synchronize()
    err = max(_scan_err("chained", (torch.cat([y1, y2], 1), h2), want),
              _scan_err("whole", (y_full, h_full), want))
    rows.append({"case": "test chained halves", "shape": [1, 64, 16, 8],
                 "max_abs_err": err})
    log(f"[kernel] mamba_scan test chained halves B=1 S=64 I=16 N=8: the "
        f"halves with h_last carried over, and the whole, against the "
        f"plain version: max abs err {err:.3g}")
    log("[kernel] mamba_scan: no single PyTorch call computes a selective "
        "scan, so there is no library yardstick (library_ms null)")
    return rows


# --------------------------------------------------------------------------
# phases 3 and 4: the main path through RuntimeEngine
# --------------------------------------------------------------------------

def _recompute(eng, task, seed_ids) -> torch.Tensor:
    """The plain version's coadd of ``task``'s inputs, read afresh from the
    store and copied to the card."""
    from repro_torch.apps import astro
    from repro_torch.kernels.stacking.ref import stack_rois_ref

    store = eng.runtime.store
    tiles = torch.cat([store.get(oid)[1].to(eng.runtime.device)
                       for oid in task.inputs], dim=0)
    out = stack_rois_ref(tiles, *astro.coadd_params(tiles, seed_ids))
    return out / tiles.shape[0]


def phase_flat() -> dict:
    from repro_torch.apps import astro
    from repro_torch.configs.astro_stacking import workload
    from repro_torch.experiments import RuntimeEngine
    from repro_torch.kernels.stacking.stacking import coadd_calls, launches

    spec = astro.flat_spec(FLAT_TASKS, FLAT_LOCALITY, FLAT_HOSTS)
    n_files = spec.workload.n_objects
    log(f"[flat] {FLAT_TASKS} tasks over {n_files} files (locality "
        f"{FLAT_LOCALITY}; Table 2 lists 4650 files) on {FLAT_HOSTS} "
        f"executors with 1 GiB caches on the card; no cut")
    t0 = time.monotonic()
    eng = RuntimeEngine(device="cuda").prepare(spec)
    try:
        for ob in eng.workload.objects:
            eng.runtime.put_object(ob, astro.make_tiles(ob))
        setup_s = time.monotonic() - t0
        log(f"[flat] set-up (catalog made on the host, "
            f"{n_files * astro.FILE_BYTES / 1e9:.3f} GB): {setup_s:.2f}s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        coadd_calls.reset()
        rep = eng.run(task_fn=astro.stack_object, time_scale=0.0,
                      timeout=900.0)
        torch.cuda.synchronize()
        n_launch = launches.value
        n_one_call = coadd_calls.value
        peak = torch.cuda.max_memory_allocated()
        ideal = workload(FLAT_LOCALITY).ideal_cache_hit_ratio
        b = rep.bytes_by_kind
        log(f"[flat] completed {rep.n_completed}/{rep.n_tasks} failed "
            f"{rep.n_failed} | wall {rep.wall_s:.2f}s | "
            f"{rep.tasks_per_second:.1f} tasks/s over the busy span "
            f"({rep.busy_span_s:.2f}s)")
        log(f"[flat] cache hit ratio {rep.cache_hit_ratio:.4f} (ideal 1-1/L "
            f"= {ideal:.4f}; local {rep.local_hits}, peer {rep.peer_hits}, "
            f"store {rep.store_reads})")
        log(f"[flat] bytes: store {b['store_read'] / 1e9:.4f} GB, local "
            f"{b['local'] / 1e9:.4f} GB, cache-to-cache {b['c2c'] / 1e9:.4f} "
            f"GB | peak device memory {peak / 2**30:.3f} GiB")
        log(f"[flat] stack_rois launches {n_launch}, one-call coadds "
            f"{n_one_call} (completed tasks {rep.n_completed})")
        if rep.n_completed != FLAT_TASKS or rep.n_failed:
            raise AssertionError("flat run did not complete every task")
        if n_launch != rep.n_completed or n_one_call != rep.n_completed:
            raise AssertionError(f"flat: {n_launch} kernel launches and "
                                 f"{n_one_call} one-call coadds for "
                                 f"{rep.n_completed} tasks")
        if rep.cache_hit_ratio < 0.9 * ideal:
            raise AssertionError(f"flat: hit ratio {rep.cache_hit_ratio} is "
                                 f"below 90% of the ideal {ideal}")
        done = eng.runtime.dispatcher.completed
        worst = 0.0
        for t in done[:CHECKED_TASKS]:
            want = _recompute(eng, t, [int(oid[3:]) for oid in t.inputs])
            if t.result.device.type != "cuda":
                raise AssertionError(f"{t.tid}: result not on the card")
            worst = max(worst, check_close(t.tid, t.result, want)[0])
        log(f"[flat] first {CHECKED_TASKS} completed tasks against the plain "
            f"version on the card: max abs err {worst:.3g}")
        return {"tasks": FLAT_TASKS, "files": n_files,
                "executors": FLAT_HOSTS, "setup_s": setup_s,
                "wall_s": rep.wall_s, "busy_span_s": rep.busy_span_s,
                "tasks_per_second": rep.tasks_per_second,
                "cache_hit_ratio": rep.cache_hit_ratio, "ideal": ideal,
                "local_hits": rep.local_hits, "peer_hits": rep.peer_hits,
                "store_reads": rep.store_reads, "bytes_by_kind": b,
                "peak_memory_bytes": peak, "launches": n_launch,
                "one_call_coadds": n_one_call,
                "checked_max_abs_err": worst}
    finally:
        eng.shutdown()


def phase_pipeline() -> dict:
    from repro_torch.apps import astro
    from repro_torch.experiments import RuntimeEngine
    from repro_torch.kernels.stacking.ref import stack_rois_ref
    from repro_torch.kernels.stacking.stacking import launches

    spec = astro.pipeline_spec(PIPE_GROUPS, PIPE_GROUP_SIZE, PIPE_HOSTS)
    eng = RuntimeEngine(device="cuda").prepare(spec)
    try:
        launches.reset()
        rep = eng.run(task_fn=astro.stack_or_mosaic,
                      payload_factory=astro.make_tiles, time_scale=0.0,
                      timeout=300.0)
        torch.cuda.synchronize()
        n_launch = launches.value
        done = {t.tid: t for t in eng.runtime.dispatcher.completed}
        stacks = []
        worst = 0.0
        for g in range(PIPE_GROUPS):
            t = done[f"astro-stack{g}"]
            want = _recompute(eng, t, [int(o.split(".")[2][1:])
                                       for o in t.inputs])
            worst = max(worst, check_close(t.tid, t.result, want)[0])
            stacks.append(t.result)
        tiles = torch.stack(stacks)
        z = torch.zeros(PIPE_GROUPS, device=tiles.device)
        o = torch.ones(PIPE_GROUPS, device=tiles.device)
        want = stack_rois_ref(tiles, z, o, z, z) / PIPE_GROUPS
        mosaic = done["astro-mosaic"].result
        worst = max(worst, check_close("mosaic", mosaic, want)[0])
        b = rep.bytes_by_kind
        log(f"[pipeline] stacked {PIPE_GROUPS} groups x {PIPE_GROUP_SIZE} "
            f"files, then mosaicked, on {PIPE_HOSTS} executors: completed "
            f"{rep.n_completed}/{rep.n_tasks}, wall {rep.wall_s:.3f}s")
        log(f"[pipeline] cache hit ratio {rep.cache_hit_ratio:.4f} | bytes: "
            f"store {b['store_read'] / 1e6:.1f} MB, cache-served "
            f"{(b['c2c'] + b['local']) / 1e6:.1f} MB | mosaic pixel mean "
            f"{float(mosaic.mean()):.2f}")
        log(f"[pipeline] stack_rois launches {n_launch} (groups + 1 = "
            f"{PIPE_GROUPS + 1}); stacks and mosaic against the plain "
            f"version: max abs err {worst:.3g}")
        if rep.n_completed != PIPE_GROUPS + 1 or rep.n_failed:
            raise AssertionError("pipeline run did not complete every task")
        if n_launch != PIPE_GROUPS + 1:
            raise AssertionError(f"pipeline: {n_launch} kernel launches, "
                                 f"expected {PIPE_GROUPS + 1}")
        return {"wall_s": rep.wall_s, "cache_hit_ratio": rep.cache_hit_ratio,
                "bytes_by_kind": b, "launches": n_launch,
                "max_abs_err": worst}
    finally:
        eng.shutdown()


# --------------------------------------------------------------------------
# phase 5: serving h2o-danube-3-4b through the launcher's code path
# --------------------------------------------------------------------------

def _wave_agreement(w) -> tuple[float, float]:
    """A wave's forward logits against the decode replay's at each
    request's last prompt position: max abs diff / max|logit|, and the
    share of requests whose argmax agrees."""
    pre, rep = w.prefill_logits.float(), w.replay_logits.float()
    if not (bool(torch.isfinite(pre).all())
            and bool(torch.isfinite(rep).all())):
        raise AssertionError("serve: non-finite logits")
    rel = float((pre - rep).abs().max() / pre.abs().max())
    same = float((pre.argmax(-1) == rep.argmax(-1)).float().mean())
    return rel, same


def _profile_decode(eng, steps: int = 3) -> dict:
    """Decode steps of the engine's model under torch.profiler: host wall
    per step, card busy time per step (the sum of its kernels' times),
    kernels per step, and the kernels that take the most card time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import init_cache, make_serve_step

    w = eng.waves[-1]
    step = make_serve_step(eng.cfg)
    b = w.tokens.shape[0]
    with torch.inference_mode():
        cache = init_cache(eng.cfg, b, eng.max_seq, device=eng.device)
        tok = w.tokens[:, :1]
        step(eng.params, cache, {"token": tok, "pos": 0})
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for pos in range(1, steps + 1):
                step(eng.params, cache, {"token": tok, "pos": pos})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
    # the kernels themselves (the CPU ops that launched them also carry
    # their device time, so they are left out of the sums)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events) / steps
    launches = sum(e.count for e in events) / steps
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms_per_step": wall * 1e3,
            "busy_ms_per_step": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / (wall * 1e3),
            "kernels_per_step": launches,
            "top": [(e.key[:70], e.self_device_time_total / steps / 1e3)
                    for e in top]}


def _launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mamba_scan import mamba_scan as ms
    from repro_torch.kernels.stacking import stacking

    return {"stack_rois": stacking.launches,
            "flash_attention": fa.launches,
            "flash_attention/wgmma": fa.path_launches["wgmma"],
            "flash_attention/simt": fa.path_launches["simt"],
            "mamba_scan": ms.launches,
            "mamba_scan/pair": ms.path_launches["pair"],
            "mamba_scan/quad": ms.path_launches["quad"]}


def _reset_launches() -> None:
    for counter in _launch_counters().values():
        counter.reset()


def _read_launches() -> dict:
    return {name: c.value for name, c in _launch_counters().items()}


def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.device import describe
    from repro_torch.launch import serve as launch
    from repro_torch.models import init_params
    from repro_torch.models.transformer import flatten

    dev = torch.device("cuda", 0)
    cfg = get_config(SERVE_ARCH).with_(attn_impl="flash")
    # the runtime phases' device tensors sit in reference cycles until a
    # collection: free them so the peak below is the serve phase's own
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SERVE_SEED),
                         dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    leaves = [t for _, t in flatten(params)]
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"[serve] {cfg.name} at its published widths: {cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} kv heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, window {cfg.window}; {n_params:,} "
        f"parameters ({param_bytes / 1e9:.3f} GB in {cfg.dtype}) drawn on "
        f"the card in {init_s:.2f}s; no cut")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.monotonic()
    eng, done = launch.serve(cfg, SERVE_REQUESTS, SERVE_REPLICAS,
                             SERVE_POLICY, SERVE_MAX_NEW, SERVE_SEED, dev,
                             params=params)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    counts = _read_launches()
    n_launch = counts["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    for line in launch.report(eng, done, SERVE_REPLICAS, SERVE_POLICY):
        log(line)
    card = describe(dev)
    failures = []
    if len(done) != SERVE_REQUESTS or any(
            len(r.output) != SERVE_MAX_NEW or
            not all(0 <= t < cfg.vocab_size for t in r.output)
            for r in done):
        failures.append("not every request got its tokens")
    expected = cfg.n_layers * len(eng.waves)
    log(f"[serve] flash_attention launches {n_launch} (layers x waves = "
        f"{cfg.n_layers} x {len(eng.waves)} = {expected})")
    if n_launch != expected:
        failures.append(f"{n_launch} flash launches, expected {expected}")
    log(f"[serve] flash_attention launches by kernel: tensor cores (wgmma) "
        f"{counts['flash_attention/wgmma']}, SIMT "
        f"{counts['flash_attention/simt']}")
    if counts["flash_attention/wgmma"] != expected:
        failures.append(f"{counts['flash_attention/wgmma']} of the flash "
                        f"launches took the tensor-core kernel, expected "
                        f"all {expected}")
    waves = []
    for i, w in enumerate(eng.waves):
        rel, same = _wave_agreement(w)
        waves.append({"forward_ms": w.forward_s * 1e3,
                      "replay_ms_per_step": w.replay_s * 1e3 / w.replay_steps,
                      "decode_ms_per_step": w.decode_s * 1e3 / w.decode_steps,
                      "replay_steps": w.replay_steps,
                      "decode_steps": w.decode_steps,
                      "forward_vs_replay_rel": rel,
                      "argmax_equal_share": same})
        log(f"[serve] wave {i} (bf16): forward (flash) vs decode replay at "
            f"each request's last prompt position: max abs diff / "
            f"max|logit| {rel:.4g}, argmax equal in {same:.3f} of requests "
            f"(reported, not bounded)")
    last = eng.waves[-1]
    e2e = _end_to_end(cfg, params, last.tokens)
    log(f"[serve] last wave's forward end to end (bf16), max abs diff / "
        f"max|logit|: flash vs ref {e2e['flash_vs_ref']:.4g}, blocked vs "
        f"ref {e2e['blocked_vs_ref']:.4g} (two plain PyTorch paths: "
        f"reported, not bounded)")
    layers = _layer_by_layer(cfg, params, last.tokens)
    worst = max(r["flash_vs_ref"] for r in layers)
    log(f"[serve] last wave, layer by layer on the flash forward's own "
        f"hidden states: attention block output flash vs ref, max abs diff "
        f"/ max|output| over the {len(layers)} layers {worst:.4g} "
        f"(tolerance 2e-2); attention scores reach "
        f"{max(r['max_abs_score'] for r in layers):.1f} and the smallest "
        f"gap between a row's two largest scores is "
        f"{min(r['min_top2_gap'] for r in layers):.3g}")
    if not worst <= 2e-2:
        failures.append(f"flash attention block disagrees with ref "
                        f"({worst} of max|output|)")
    prof = _profile_decode(eng)
    log(f"[serve] decode step profiled ({card}): wall "
        f"{prof['wall_ms_per_step']:.3f} ms, card busy "
        f"{prof['busy_ms_per_step']:.3f} ms ({prof['busy_share']:.3f} of "
        f"the wall), {prof['kernels_per_step']:.0f} kernels per step; top: "
        + "; ".join(f"{k} {ms:.3f} ms" for k, ms in prof["top"]))

    steps = sum(w.replay_steps + w.decode_steps for w in eng.waves)
    step_ms = sum(w.replay_s + w.decode_s for w in eng.waves) * 1e3 / steps
    log(f"[serve] on {card}: serve wall {wall_s:.3f}s for "
        f"{SERVE_REQUESTS} requests; forward (prefill) "
        + ", ".join(f"{w['forward_ms']:.2f}" for w in waves)
        + f" ms per wave; decode {step_ms:.3f} ms per step over {steps} "
        f"steps; peak device memory {peak / 2**30:.3f} GiB (weights "
        f"included; {held / 2**30:.3f} GiB still held from earlier phases)")
    if failures:
        raise AssertionError("serve: " + "; ".join(failures))
    return {"arch": cfg.name, "params": n_params, "param_bytes": param_bytes,
            "init_s": init_s, "wall_s": wall_s, "launches": n_launch,
            "launches_wgmma": counts["flash_attention/wgmma"],
            "waves": waves, "decode_ms_per_step": step_ms,
            "end_to_end": e2e, "layer_by_layer": layers,
            "decode_profile": prof,
            "peak_memory_bytes": peak, "held_before_bytes": held,
            "prefill_tokens": eng.prefill_tokens,
            "reused_tokens": eng.reused_tokens,
            "router": eng.router.stats(), "card": card}


def _end_to_end(cfg, params, tokens) -> dict:
    """The wave's forward logits under flash, ref and blocked attention."""
    from repro_torch.models import make_forward

    out = {}
    with torch.inference_mode():
        ref, _ = make_forward(cfg.with_(attn_impl="ref"))(
            params, {"tokens": tokens})
        scale = float(ref.abs().max())
        for impl in ("flash", "blocked"):
            got, _ = make_forward(cfg.with_(attn_impl=impl))(
                params, {"tokens": tokens})
            out[f"{impl}_vs_ref"] = float((got - ref).abs().max()) / scale
    return out


def _layer_by_layer(cfg, params, tokens) -> list[dict]:
    """Walk the flash forward layer by layer; at each layer run the
    attention block with flash and with ref on the same (flash-path) input
    and compare, and record the attention scores' largest magnitude and
    the smallest gap between the two largest scores of a row."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    spec = cfg.pattern[0]
    rows = []
    with torch.inference_mode():
        x = T.embed_inputs(cfg, params, {"tokens": tokens})
        pos = torch.arange(x.shape[1], device=x.device)
        causal = torch.ones(x.shape[1], x.shape[1], dtype=torch.bool,
                            device=x.device).tril()
        for i in range(cfg.n_blocks):
            p = T._layer(params["blocks"]["sub0"], i)
            h = T._norm(cfg, x, p, "ln1")
            var = T._variant(cfg, spec)
            a_f, a_r = (L.attention_block(h, p, pos, var, cfg.rope_theta,
                                          impl=impl)
                        for impl in ("flash", "ref"))
            q = L.apply_rope(torch.einsum("bsd,dhk->bshk", h, p["wq"]), pos,
                             cfg.rope_theta).float()
            k = L.apply_rope(torch.einsum("bsd,dhk->bshk", h, p["wk"]), pos,
                             cfg.rope_theta).float()
            k = k.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)
            sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / cfg.head_dim_ ** 0.5
            top2 = sc.masked_fill(~causal, float("-inf")).topk(2, -1).values
            rows.append({
                "flash_vs_ref": float((a_f - a_r).abs().max()
                                      / a_r.abs().max()),
                "max_abs_score": float(sc.masked_fill(~causal, 0).abs()
                                       .max()),
                "min_top2_gap": float((top2[..., 1:, 0]
                                       - top2[..., 1:, 1]).min())})
            x, _ = T._apply_sub(cfg, spec, x, p, pos)
    return rows


# --------------------------------------------------------------------------
# phase 6: serving falcon-mamba-7b through the launcher's code path
# --------------------------------------------------------------------------

def phase_ssm_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.device import describe
    from repro_torch.kernels.mamba_scan import mamba_scan as ms
    from repro_torch.launch import serve as launch
    from repro_torch.models import init_params
    from repro_torch.models.transformer import flatten

    dev = torch.device("cuda", 0)
    cfg = get_config(SSM_ARCH).with_(use_mamba_kernel=True)
    # phase 5's tensors may sit in reference cycles: free them first
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SERVE_SEED),
                         dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    init_peak = torch.cuda.max_memory_allocated()
    leaves = [t for _, t in flatten(params)]
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"[ssm] {cfg.name} at its published widths: {cfg.n_layers} mamba "
        f"layers, d_model {cfg.d_model}, d_inner {cfg.d_inner}, state "
        f"{cfg.ssm_state}, conv {cfg.ssm_conv}, dt_rank {cfg.dt_rank}, vocab "
        f"{cfg.vocab_size}, untied embeddings; {n_params:,} parameters "
        f"({param_bytes / 1e9:.3f} GB in {cfg.dtype}) drawn on the card in "
        f"{init_s:.2f}s; drawing peaked at {init_peak / 2**30:.3f} GiB (each "
        f"stacked leaf is drawn one layer at a time in fp32, then cast); no "
        f"cut")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.monotonic()
    eng, done = launch.serve(cfg, SERVE_REQUESTS, SERVE_REPLICAS,
                             SERVE_POLICY, SERVE_MAX_NEW, SERVE_SEED, dev,
                             params=params)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    counts = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    for line in launch.report(eng, done, SERVE_REPLICAS, SERVE_POLICY):
        log(line)
    card = describe(dev)
    failures = []
    if len(done) != SERVE_REQUESTS or any(
            len(r.output) != SERVE_MAX_NEW or
            not all(0 <= t < cfg.vocab_size for t in r.output)
            for r in done):
        failures.append("not every request got its tokens")
    expected = {"stack_rois": 0, "flash_attention": 0,
                "flash_attention/wgmma": 0, "flash_attention/simt": 0,
                "mamba_scan": cfg.n_layers * len(eng.waves),
                "mamba_scan/pair": 0, "mamba_scan/quad": 0}
    for w in eng.waves:   # each wave's forward: one launch per layer
        path = ms.kernel_path(w.tokens.shape[0], cfg.d_inner)
        expected[f"mamba_scan/{path}"] += cfg.n_layers
    log(f"[ssm] launches {counts} (mamba_scan: layers x waves = "
        f"{cfg.n_layers} x {len(eng.waves)} = {expected['mamba_scan']}, "
        f"each on the path the shape rule gives its wave)")
    if counts != expected:
        failures.append(f"launches {counts}, expected {expected}")
    waves = []
    for i, w in enumerate(eng.waves):
        rel, same = _wave_agreement(w)
        waves.append({"forward_ms": w.forward_s * 1e3,
                      "replay_ms_per_step": w.replay_s * 1e3 / w.replay_steps,
                      "decode_ms_per_step": w.decode_s * 1e3 / w.decode_steps,
                      "replay_steps": w.replay_steps,
                      "decode_steps": w.decode_steps,
                      "forward_vs_replay_rel": rel,
                      "argmax_equal_share": same})
        log(f"[ssm] wave {i} (bf16): forward (scan kernel) vs decode replay "
            f"at each request's last prompt position: max abs diff / "
            f"max|logit| {rel:.4g}, argmax equal in {same:.3f} of requests "
            f"(reported, not bounded)")
    last = eng.waves[-1]
    e2e = _ssm_end_to_end(cfg, params, last.tokens)
    log(f"[ssm] last wave's forward end to end (bf16): scan kernel vs plain "
        f"chunked scan, max abs diff / max|logit| {e2e:.4g} (reported, not "
        f"bounded)")
    layers = _ssm_layer_by_layer(cfg, params, last.tokens)
    worst = max(r["kernel_vs_plain"] for r in layers)
    log(f"[ssm] last wave, layer by layer on the kernel forward's own "
        f"hidden states: mamba block output, scan kernel vs plain chunked "
        f"scan, max abs diff / max|output| over the {len(layers)} layers "
        f"{worst:.4g} (tolerance 2e-2)")
    if not worst <= 2e-2:
        failures.append(f"mamba block with the kernel disagrees with the "
                        f"plain path ({worst} of max|output|)")
    marks = sorted({k for k in (0, 1, 3, 7, 15, 31, 47) if k < len(layers)}
                   | {len(layers) - 1})
    log("[ssm] the two forwards' residual streams (scan kernel, plain "
        "chunked scan) apart after layer k, max abs diff / max|x|: "
        + ", ".join(f"k={k}: {layers[k]['stream_divergence']:.3g}"
                    for k in marks))
    fp32 = _ssm_fp32_check(cfg, params, last)
    log(f"[ssm] last wave again with the weights in fp32: forward, scan "
        f"kernel vs plain chunked scan, max abs diff / max|logit| "
        f"{fp32['kernel_vs_plain']:.4g}; forward (kernel) vs decode replay "
        f"at each request's last prompt position {fp32['forward_vs_replay']:.4g}"
        f", argmax equal in {fp32['argmax_equal_share']:.3f} of requests "
        f"(tolerance 2e-2 on both)")
    for what in ("kernel_vs_plain", "forward_vs_replay"):
        if not fp32[what] <= 2e-2:
            failures.append(f"fp32 end to end: {what} {fp32[what]} of "
                            f"max|logit|")
    prof = _profile_decode(eng)
    log(f"[ssm] decode step profiled ({card}): wall "
        f"{prof['wall_ms_per_step']:.3f} ms, card busy "
        f"{prof['busy_ms_per_step']:.3f} ms ({prof['busy_share']:.3f} of "
        f"the wall), {prof['kernels_per_step']:.0f} kernels per step; top: "
        + "; ".join(f"{k} {ms:.3f} ms" for k, ms in prof["top"]))
    steps = sum(w.replay_steps + w.decode_steps for w in eng.waves)
    step_ms = sum(w.replay_s + w.decode_s for w in eng.waves) * 1e3 / steps
    log(f"[ssm] on {card}: serve wall {wall_s:.3f}s for {SERVE_REQUESTS} "
        f"requests; forward (prefill) "
        + ", ".join(f"{w['forward_ms']:.2f}" for w in waves)
        + f" ms per wave; decode {step_ms:.3f} ms per step over {steps} "
        f"steps; peak device memory {peak / 2**30:.3f} GiB (weights "
        f"included; {held / 2**30:.3f} GiB still held from earlier phases)")
    if failures:
        raise AssertionError("ssm serve: " + "; ".join(failures))
    return {"arch": cfg.name, "params": n_params, "param_bytes": param_bytes,
            "init_s": init_s, "init_peak_memory_bytes": init_peak,
            "wall_s": wall_s, "launches": counts["mamba_scan"],
            "launches_by_path": {p: counts[f"mamba_scan/{p}"]
                                 for p in ms.LANES},
            "launches_all": counts, "waves": waves,
            "decode_ms_per_step": step_ms, "end_to_end_kernel_vs_plain": e2e,
            "layer_by_layer": layers, "fp32": fp32, "decode_profile": prof,
            "peak_memory_bytes": peak, "held_before_bytes": held,
            "prefill_tokens": eng.prefill_tokens,
            "reused_tokens": eng.reused_tokens,
            "router": eng.router.stats(), "card": card}


def _ssm_end_to_end(cfg, params, tokens) -> float:
    """The wave's forward logits with the scan kernel against the plain
    chunked scan: max abs diff / max|logit|."""
    from repro_torch.models import make_forward

    with torch.inference_mode():
        plain, _ = make_forward(cfg.with_(use_mamba_kernel=False))(
            params, {"tokens": tokens})
        kernel, _ = make_forward(cfg)(params, {"tokens": tokens})
        return float((kernel - plain).abs().max()) / float(plain.abs().max())


def _ssm_layer_by_layer(cfg, params, tokens) -> list[dict]:
    """Walk the kernel forward layer by layer; at each layer run the mamba
    block with the scan kernel and with the plain chunked scan on the same
    (kernel-path) input and compare.  Beside it, walk the plain forward's
    own residual stream and record how far the two streams are apart after
    each layer.  falcon-mamba-7b's layer is the mamba block and its
    residual (no MLP, no post-norms)."""
    from repro_torch.models import mamba as M
    from repro_torch.models import transformer as T

    def block(x, p, kernel):
        return M.mamba_block(T._norm(cfg, x, p, "ln1"), p, use_kernel=kernel,
                             chunk=cfg.ssm_chunk)

    rows = []
    with torch.inference_mode():
        x = T.embed_inputs(cfg, params, {"tokens": tokens})
        x_plain = x
        for i in range(cfg.n_blocks):
            p = T._layer(params["blocks"]["sub0"], i)
            out_k, out_p = block(x, p, True), block(x, p, False)
            x = x + out_k
            x_plain = x_plain + block(x_plain, p, False)
            out_k, out_p = out_k.float(), out_p.float()
            rows.append({
                "kernel_vs_plain": float((out_k - out_p).abs().max()
                                         / out_p.abs().max()),
                "max_abs_output": float(out_p.abs().max()),
                "stream_divergence": float(
                    (x.float() - x_plain.float()).abs().max()
                    / x_plain.float().abs().max())})
    return rows


def _replay(cfg, params, toks, lens) -> torch.Tensor:
    """The engine's replay: the prompts through the decode step, each
    request's logits at its last prompt position (B, V)."""
    from repro_torch.models import init_cache, make_serve_step

    step = make_serve_step(cfg)
    with torch.inference_mode():
        cache = init_cache(cfg, len(lens), toks.shape[1], device=toks.device)
        out = None
        for t in range(max(lens)):
            lg, cache = step(params, cache, {"token": toks[:, t: t + 1],
                                             "pos": t})
            if out is None:
                out = torch.zeros_like(lg[:, -1])
            ending = [i for i, n in enumerate(lens) if n == t + 1]
            if ending:
                out[ending] = lg[ending, -1]
    return out


def _ssm_fp32_check(cfg, params, wave) -> dict:
    """The wave's forward and decode replay again with the weights cast to
    fp32: the forward with the scan kernel against the plain chunked scan,
    and against the decode replay at each request's last prompt position
    (max abs diff / max|logit|, and the share of equal argmaxes)."""
    from repro_torch.models import make_forward
    from repro_torch.models.transformer import flatten, unflatten

    cfg32 = cfg.with_(dtype="float32")
    toks, lens = wave.tokens, wave.lens
    with torch.inference_mode():
        p32 = unflatten((path, t.float()) for path, t in flatten(params))
        kernel, _ = make_forward(cfg32)(p32, {"tokens": toks})
        plain, _ = make_forward(cfg32.with_(use_mamba_kernel=False))(
            p32, {"tokens": toks})
        scale = float(plain.abs().max())
        kernel_vs_plain = float((kernel - plain).abs().max()) / scale
        del plain
        rows = torch.arange(len(lens), device=toks.device)
        last = torch.tensor([n - 1 for n in lens], device=toks.device)
        pre = kernel[rows, last]
        del kernel
        replay = _replay(cfg32, p32, toks, lens)
        rel = float((pre - replay).abs().max() / pre.abs().max())
        same = float((pre.argmax(-1) == replay.argmax(-1)).float().mean())
    return {"kernel_vs_plain": kernel_vs_plain, "forward_vs_replay": rel,
            "argmax_equal_share": same}


# --------------------------------------------------------------------------
# phase 7: training h2o-danube-3-4b through the launcher's code path
# --------------------------------------------------------------------------

def train_model_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward, 3x the
    forward; the remat recompute is not counted): 2 per weight of every
    product per token (the attention projections, the MLP, the unembed)
    and 4·Dh per valid (q, k) pair and head for the attention itself."""
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim_, cfg.d_ff)
    per_layer = d * (h + 2 * kv) * dh + h * dh * d + (3 if cfg.gated_mlp
                                                      else 2) * d * f
    weights = cfg.n_layers * per_layer + cfg.vocab_size * d
    pairs = flash_pairs(seq, seq, True, cfg.window)
    fwd = 2 * weights * batch * seq + cfg.n_layers * 4 * dh * h * batch * pairs
    return 3.0 * fwd


#: the card's kernels in a training step, by kind of work, read from
#: their names (first match): the flash kernel; fp32 products (the plain
#: attention's backward and its recomputed forward: cuBLAS/CUTLASS fp32
#: GEMMs); the other products (the model's bf16 GEMMs); all the rest
#: (elementwise, softmax, reductions, copies, the optimizer)
TRAIN_KERNEL_KINDS = {
    "flash kernel": lambda k: "flash_attention" in k,
    "fp32 products": lambda k: "f32f32" in k or "sgemm" in k,
    "other products": lambda k: any(w in k for w in ("gemm", "nvjet",
                                                      "xmma", "cutlass")),
    "the rest": lambda k: True,
}


def _profile_train(cfg, step_fn, state, pipeline, start: int,
                   steps: int = 2):
    """``steps`` more train steps of ``cfg`` under torch.profiler (batches
    fetched, with the train loop's frontend stubs, before it starts): host
    wall per step, card busy time per step (the sum of its kernels'
    times), the flash kernel's share, and the kernels that take the most
    card time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.loop import train_batch

    batches = [pipeline.fetch_step(start + i) for i in range(steps)]
    batches = [train_batch(cfg, t) for t in batches]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            state, metrics = step_fn(state, batch)
            float(metrics["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events) / steps
    by_kind = dict.fromkeys(TRAIN_KERNEL_KINDS, 0.0)
    for e in events:
        kind = next(k for k, test in TRAIN_KERNEL_KINDS.items()
                    if test(e.key.lower()))
        by_kind[kind] += e.self_device_time_total / steps / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return state, {
        "wall_ms_per_step": wall * 1e3,
        "busy_ms_per_step": busy_us / 1e3,
        "busy_share": busy_us / 1e3 / (wall * 1e3),
        "flash_ms_per_step": by_kind["flash kernel"],
        "ms_per_step_by_kind": by_kind,
        "kernels_per_step": sum(e.count for e in events) / steps,
        "top": [(e.key[:70], e.self_device_time_total / steps / 1e3)
                for e in top]}


def _loss_fell(cfg, params, pipeline, steps: int, seed: int, dev) -> dict:
    """Whether training lowered the loss on its own data: the mean loss
    over the run's ``steps`` batches (fetched again, with the train loop's
    frontend stubs) at the initial weights (drawn again from ``seed``, as
    ``train`` drew them) and at ``params``."""
    from repro_torch.models import init_params
    from repro_torch.models.model import make_loss_fn
    from repro_torch.train.loop import train_batch

    batches = [train_batch(cfg, pipeline.fetch_step(i)) for i in range(steps)]
    loss_fn = make_loss_fn(cfg)

    def mean_loss(p) -> float:
        with torch.no_grad():
            return float(np.mean([float(loss_fn(p, b)) for b in batches]))
    after = mean_loss(params)
    before = mean_loss(init_params(
        cfg, torch.Generator(dev).manual_seed(seed), dev))
    return {"before": before, "after": after,
            "fell": bool(np.isfinite(after) and after < before)}


def _leaf_grads(cfg, params, tokens, names) -> list[dict]:
    """The loss's gradient with respect to the named leaves of the first
    sub-layer of every block at ``params``: for each leaf and layer,
    whether it is finite and its largest magnitude."""
    from repro_torch.models.model import make_loss_fn

    block = params["blocks"]["sub0"]
    leaves = [block[n].requires_grad_() for n in names]
    loss = make_loss_fn(cfg)(params, {"tokens": tokens})
    grads = torch.autograd.grad(loss, leaves)
    rows = []
    for name, g in zip(names, grads):
        for i in range(g.shape[0]):
            rows.append({"leaf": name, "layer": i,
                         "finite": bool(torch.isfinite(g[i]).all()),
                         "max_abs": float(g[i].abs().max())})
    return rows


def _two_layer_fp32(tokens) -> dict:
    """One step of a 2-layer h2o-danube-3-4b at full width in fp32: the
    loss and every gradient leaf with the flash kernel against the plain
    ``ref`` attention, then one AdamW step and a checkpoint save ->
    restore round trip of the state, compared bit for bit on the card."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import make_loss_fn
    from repro_torch.models.transformer import flatten, unflatten
    from repro_torch.train import CheckpointManager, adamw
    from repro_torch.train.checkpoint import _named_leaves

    dev = tokens.device
    cfg = get_config(TRAIN_ARCH).with_(n_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(dev).manual_seed(TRAIN_SEED),
                         dev)
    pairs = flatten(params)
    leaves = [p.requires_grad_() for _, p in pairs]
    out = {}
    for impl in ("flash", "ref"):
        loss = make_loss_fn(cfg.with_(attn_impl=impl))(params,
                                                       {"tokens": tokens})
        grads = torch.autograd.grad(loss, leaves)
        out[impl] = (float(loss.detach()), grads)
    loss_f, grads_f = out["flash"]
    loss_r, grads_r = out.pop("ref")
    rel = {}
    for (path, _), gf, gr in zip(pairs, grads_f, grads_r):
        rel[path] = float((gf - gr).abs().max() / gr.abs().max())
    del grads_r, out
    opt = adamw(TRAIN_LR, warmup=TRAIN_WARMUP, total=TRAIN_TOTAL)
    state = opt.init(params)
    state = opt.apply(state, unflatten(
        (path, g) for (path, _), g in zip(pairs, grads_f)))
    del grads_f
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.monotonic()
    mgr = CheckpointManager(ckpt)
    mgr.save(1, state)
    save_s = time.monotonic() - t0
    t0 = time.monotonic()
    _, back = mgr.restore_latest(state)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    mine = dict(_named_leaves(state))
    unequal = [name for name, t in _named_leaves(back)
               if not (t.dtype == mine[name].dtype
                       and t.device == mine[name].device
                       and torch.equal(t, mine[name]))]
    n_leaves = len(mine)
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"loss_flash": loss_f, "loss_ref": loss_r,
            "loss_rel": abs(loss_f - loss_r) / abs(loss_r),
            "grad_rel": rel, "ckpt_leaves": n_leaves,
            "ckpt_unequal": unequal, "ckpt_bytes": ckpt_bytes,
            "ckpt_save_s": save_s, "ckpt_restore_s": restore_s}


def phase_train() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.device import describe
    from repro_torch.launch import train as launch
    from repro_torch.models.model import make_train_step
    from repro_torch.train import adamw, train

    dev = torch.device("cuda", 0)
    cfg = get_config(TRAIN_ARCH).with_(attn_impl="flash")
    # phases 5 and 6 hold their weights in reference cycles: free them
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    n_params = cfg.param_count()
    tokens_per_step = TRAIN_BATCH * (TRAIN_SEQ + 1)
    log(f"[train] {cfg.name} at its published widths: {cfg.n_layers} layers,"
        f" d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} "
        f"kv heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, window {cfg.window}; {n_params:,} parameters in "
        f"{cfg.dtype} (random, from seed {TRAIN_SEED}), AdamW moments in "
        f"fp32, remat {cfg.remat}; batch {TRAIN_BATCH} x {TRAIN_SEQ + 1} "
        f"tokens from {TRAIN_SHARDS} shards over {TRAIN_HOSTS} executors on "
        f"the card; no cut of width ({held / 2**30:.3f} GiB still held from "
        f"earlier phases)")
    opt = adamw(TRAIN_LR, warmup=TRAIN_WARMUP, total=TRAIN_TOTAL)
    log(f"[train] optimizer: adamw(peak_lr={TRAIN_LR}, warmup="
        f"{TRAIN_WARMUP}, total={TRAIN_TOTAL}), b1 {opt.b1}, b2 {opt.b2}, "
        f"eps {opt.eps}, weight decay {opt.weight_decay}, clip "
        f"{opt.grad_clip}")
    pipeline = launch.make_pipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_HOSTS,
                                    SERVE_POLICY, 64, TRAIN_SHARDS,
                                    TRAIN_SEED, dev)
    failures = []
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.monotonic()
        result = train(cfg, pipeline, TRAIN_STEPS, optimizer=opt,
                       seed=TRAIN_SEED, log_every=1, log=log, device=dev)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        counts = _read_launches()
        peak = torch.cuda.max_memory_allocated()
        for line in launch.report(result, cfg, TRAIN_BATCH, TRAIN_SEQ, dev,
                                  peak):
            log(line)
        card = describe(dev)
        expected = dict.fromkeys(counts, 0)
        n_flash = 2 * cfg.n_layers * TRAIN_STEPS
        expected.update({"flash_attention": n_flash,
                         "flash_attention/wgmma": n_flash})
        log(f"[train] launches {counts} (flash_attention: 2 x layers x steps "
            f"= 2 x {cfg.n_layers} x {TRAIN_STEPS} = {n_flash}, the forward "
            f"and the remat recompute, all on tensor cores)")
        if counts != expected:
            failures.append(f"launches {counts}, expected {expected}")
        losses = result.losses
        w = TRAIN_WINDOW
        first, last = float(np.mean(losses[:w])), float(np.mean(losses[-w:]))
        fell = _loss_fell(cfg, result.state.params, pipeline, TRAIN_STEPS,
                          TRAIN_SEED, dev)
        log(f"[train] losses {', '.join(f'{x:.4f}' for x in losses)}: mean "
            f"of the first {w} {first:.4f}, of the last {w} {last:.4f} "
            f"(reported); mean loss over the run's {TRAIN_STEPS} batches at "
            f"the initial weights {fell['before']:.4f}, at the trained ones "
            f"{fell['after']:.4f} (must fall)")
        if not (all(np.isfinite(losses)) and fell["fell"]):
            failures.append(f"the loss did not fall ({fell['before']} -> "
                            f"{fell['after']} on the run's batches)")
        step_seconds = result.step_seconds
        step_ms = statistics.median(step_seconds[1:]) * 1e3
        flops = train_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ + 1)
        mfu = flops / (step_ms * 1e-3) / BF16_OPS_PER_S
        step_fn = make_train_step(cfg, opt)
        state, prof = _profile_train(cfg, step_fn, result.state, pipeline,
                                     TRAIN_STEPS)
        del result
        log(f"[train] 2 train steps profiled ({card}): wall "
            f"{prof['wall_ms_per_step']:.1f} ms, card busy "
            f"{prof['busy_ms_per_step']:.1f} ms ({prof['busy_share']:.3f} of "
            f"the wall), {prof['kernels_per_step']:.0f} kernels per step; "
            f"by kind: " + ", ".join(f"{k} {ms:.2f} ms" for k, ms in
                                    prof["ms_per_step_by_kind"].items())
            + "; top: "
            + "; ".join(f"{k} {ms:.2f} ms" for k, ms in prof["top"]))
        tokens = pipeline.fetch_step(0)
        grads = _leaf_grads(cfg, state.params, tokens,
                            ("wq", "wk", "wv", "wo"))
        del state
        bad = [f"{r['leaf']}[{r['layer']}]" for r in grads
               if not r["finite"] or not r["max_abs"] > 0]
        log(f"[train] full-width gradient of every attention weight at the "
            f"trained state: {len(grads)} (leaf, layer) slices, "
            f"{len(grads) - len(bad)} finite and non-zero; smallest max|g| "
            f"{min(r['max_abs'] for r in grads):.3g}")
        if bad:
            failures.append(f"attention gradients zero or non-finite: {bad}")
    finally:
        pipeline.close()
    gc.collect()
    torch.cuda.empty_cache()
    small = _two_layer_fp32(tokens)
    worst = max(small["grad_rel"].values())
    log(f"[train] 2 layers at full width in fp32, one step: loss flash "
        f"{small['loss_flash']:.6f} vs ref {small['loss_ref']:.6f} (relative "
        f"{small['loss_rel']:.3g}, tolerance 1e-4); gradients, max abs diff "
        f"/ max|g| over {len(small['grad_rel'])} leaves {worst:.3g} "
        f"(tolerance 2e-2)")
    if not small["loss_rel"] <= 1e-4:
        failures.append(f"2-layer fp32 loss: flash vs ref {small['loss_rel']}")
    if not worst <= 2e-2:
        failures.append(f"2-layer fp32 gradients: flash vs ref {worst}")
    log(f"[train] checkpoint of that state ({small['ckpt_leaves']} leaves, "
        f"{small['ckpt_bytes'] / 1e9:.3f} GB): save {small['ckpt_save_s']:.2f}"
        f"s, restore {small['ckpt_restore_s']:.2f}s, "
        f"{small['ckpt_leaves'] - len(small['ckpt_unequal'])} leaves "
        f"bitwise equal after the round trip")
    if small["ckpt_unequal"]:
        failures.append(f"checkpoint round trip changed "
                        f"{small['ckpt_unequal']}")
    log(f"[train] on {card}: {step_ms:.1f} ms per step (median of steps 2-"
        f"{TRAIN_STEPS}), {tokens_per_step / (step_ms * 1e-3):.0f} tokens/s; "
        f"model FLOPs {flops:.4g} per step, {mfu:.3f} of the card's "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16 peak; peak device memory "
        f"{peak / 2**30:.3f} GiB; train wall {wall_s:.1f}s for "
        f"{TRAIN_STEPS} steps")
    if failures:
        raise AssertionError("train: " + "; ".join(failures))
    return {"arch": cfg.name, "params": n_params, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ + 1, "steps": TRAIN_STEPS,
            "optimizer": {"peak_lr": TRAIN_LR, "warmup": TRAIN_WARMUP,
                          "total": TRAIN_TOTAL},
            "losses": losses, "loss_on_batches": fell, "step_ms": step_ms,
            "step_ms_all": [t * 1e3 for t in step_seconds],
            "tokens_per_s": tokens_per_step / (step_ms * 1e-3),
            "model_flops_per_step": flops, "mfu_bf16": mfu,
            "peak_memory_bytes": peak, "held_before_bytes": held,
            "wall_s": wall_s, "launches": counts["flash_attention"],
            "launches_wgmma": counts["flash_attention/wgmma"],
            "launches_all": counts, "profile": prof,
            "attention_grads": grads, "two_layer_fp32": small, "card": card}


# --------------------------------------------------------------------------
# phase 8: serving qwen3-moe-30b-a3b through the launcher's code path
# --------------------------------------------------------------------------

def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max abs diff / max|want|."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _kept_pairs(cfg, h, p) -> torch.Tensor:
    """Which (token, choice) pairs of an MoE layer's input ``h`` (B, S, D)
    fall within capacity, (B, S, k) bool: the routing and queue order of
    ``moe_block`` itself."""
    from repro_torch.models import moe as MoE

    B, S, D = h.shape
    xt = h.reshape(B * S, D)
    gates, idx = MoE.router_probs(xt, p["w_router"], cfg.top_k)
    cap = MoE.capacity(B * S, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    _, (_, _, in_cap) = MoE._local_route(xt, gates, idx, cfg.n_experts, cap)
    return in_cap.reshape(B, S, cfg.top_k)


def _moe_walk(cfg, params, tokens, check_layers) -> dict:
    """The forward of an attention + MoE model (qwen3's one-sub-layer
    pattern) walked layer by layer, as ``_apply_sub`` runs it: logits,
    each layer's kept pairs (L, B, S, k), and on the layers in
    ``check_layers`` each layer's attention block against the plain
    ``ref`` attention and its MoE block against ``moe_block_onehot``, each
    on the walk's own inputs (max abs diff / max|output|)."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T

    spec = cfg.pattern[0]
    var = T._variant(cfg, spec)
    kept, checks = [], []
    with torch.inference_mode():
        x = T.embed_inputs(cfg, params, {"tokens": tokens})
        pos = torch.arange(x.shape[1], device=x.device)
        for i in range(cfg.n_blocks):
            p = T._layer(params["blocks"]["sub0"], i)
            h = T._norm(cfg, x, p, "ln1")
            a = L.attention_block(h, p, pos, var, cfg.rope_theta,
                                  impl=cfg.attn_impl)
            row = {"layer": i}
            if i in check_layers:
                row["attention_vs_ref"] = _rel(a, L.attention_block(
                    h, p, pos, var, cfg.rope_theta, impl="ref"))
            x = x + a
            h = T._norm(cfg, x, p, "ln2")
            m, aux = MoE.moe_block(h, p, cfg.top_k, cfg.mlp_act,
                                   cfg.capacity_factor)
            if i in check_layers:
                m1, aux1 = MoE.moe_block_onehot(h, p, cfg.top_k, cfg.mlp_act,
                                                cfg.capacity_factor)
                row.update(moe_vs_onehot=_rel(m, m1),
                           aux=float(aux), aux_onehot=float(aux1))
                checks.append(row)
            kept.append(_kept_pairs(cfg, h, p))
            x = x + m
        logits = T._unembed(cfg, params, T._norm(cfg, x, params, "final"))
    return {"logits": logits, "kept": torch.stack(kept), "checks": checks}


def _rows_against_replay(pre, rep, kept, lens) -> list[dict]:
    """Per request: whether any of its pairs up to its last prompt position
    was dropped in any layer, how many, and its forward logits against the
    replay's (max abs diff / max|logit| of the wave's forward)."""
    scale = float(pre.float().abs().max())
    rows = []
    for b, n in enumerate(lens):
        dropped = int((~kept[:, b, :n]).sum())
        rows.append({"row": b, "dropped_pairs": dropped,
                     "forward_vs_replay": float(
                         (pre[b].float() - rep[b].float()).abs().max())
                     / scale,
                     "argmax_equal": bool(pre[b].argmax() == rep[b].argmax())})
    return rows


def _widened(params) -> dict:
    """The weights for an fp32 run without an fp32 copy of the blocks: the
    embedding tables in fp32 make every activation fp32, and each block
    weight is widened as it is used (every ``p[...].to(x.dtype)``), so the
    numbers are the bf16 weights' exactly."""
    return {k: (v if k == "blocks" else v.float()) for k, v in params.items()}


def _moe_fp32_check(cfg, params, wave, depth: int) -> dict:
    """The wave's first ``depth`` layers at full width in fp32, the
    weights widened: the walk (flash on its fp32 kernel) with each layer's
    MoE block against the one-hot formulation (on every layer at a depth
    of 2, on the first 2 beyond), its kept pairs, and the replay through
    the decode step; forward against replay per request."""
    cut = cfg.with_(n_layers=depth, dtype="float32")
    p32 = _widened(dict(params, blocks={
        sub: {k: v[:depth] for k, v in leaves.items()}
        for sub, leaves in params["blocks"].items()}))
    toks, lens = wave.tokens, wave.lens
    walk = _moe_walk(cut, p32, toks, set(range(min(depth, 2))))
    rows = torch.arange(len(lens), device=toks.device)
    last = torch.tensor([n - 1 for n in lens], device=toks.device)
    pre = walk["logits"][rows, last]
    del walk["logits"]
    rep = _replay(cut, p32, toks, lens)
    return {"depth": depth,
            "rows": _rows_against_replay(pre, rep, walk["kept"], lens),
            "checks": walk["checks"],
            "dropped_by_layer": (~walk["kept"]).sum((1, 2, 3)).tolist()}


def _stream_divergence(cfg, params, tokens) -> list[float]:
    """The wave in fp32 (weights widened) through two forwards that differ
    only in their attention, flash (its fp32 kernel) and the plain
    ``ref``: how far apart their residual streams are after each layer,
    max abs diff / max|x|.  No decode step is involved: this is how far
    the random weights amplify fp32 rounding with depth."""
    from repro_torch.models import transformer as T

    cfg32 = cfg.with_(dtype="float32")
    p32 = _widened(params)
    spec = cfg.pattern[0]
    out = []
    with torch.inference_mode():
        x = T.embed_inputs(cfg32, p32, {"tokens": tokens})
        pos = torch.arange(x.shape[1], device=x.device)
        xs = {"flash": x, "ref": x}
        for i in range(cfg.n_blocks):
            p = T._layer(p32["blocks"]["sub0"], i)
            for impl in xs:
                xs[impl], _ = T._apply_sub(cfg32.with_(attn_impl=impl), spec,
                                           xs[impl], p, pos)
            out.append(_rel(xs["flash"], xs["ref"]))
    return out


def _experts_decode_ms(cfg, params, dev) -> dict:
    """Card time (graph-replayed, ``device_ms``) of one layer's MoE block
    and of its expert products alone at the decode step's shape (B=8
    tokens: 10 capacity slots for each of the 128 experts), on layer 0's
    weights."""
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T

    p = T._layer(params["blocks"]["sub0"], 0)
    g = torch.Generator(dev).manual_seed(7)
    h = torch.randn(8, 1, cfg.d_model, generator=g, device=dev).to(
        torch.bfloat16)
    xt = h.reshape(8, cfg.d_model)
    gates, idx = MoE.router_probs(xt, p["w_router"], cfg.top_k)
    cap = MoE.capacity(8, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    disp, _ = MoE._local_route(xt, gates, idx, cfg.n_experts, cap)
    with torch.inference_mode():
        experts = device_ms(lambda: MoE._experts(disp, p, cfg.mlp_act),
                            reps=10, inner=10)
        block = device_ms(lambda: MoE.moe_block_sharded(h, p, cfg),
                          reps=10, inner=10)
    return {"capacity": cap, "experts_ms_per_layer": experts,
            "moe_block_ms_per_layer": block}


def _moe_serve(failures: list) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.device import describe
    from repro_torch.launch import serve as launch
    from repro_torch.models import init_params
    from repro_torch.models import moe as MoE
    from repro_torch.models.transformer import flatten

    dev = torch.device("cuda", 0)
    cfg = get_config(MOE_ARCH).with_(attn_impl="flash")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SERVE_SEED),
                         dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    init_peak = torch.cuda.max_memory_allocated()
    leaves = [t for _, t in flatten(params)]
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"[moe] {cfg.name} at its published widths: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv "
        f"heads of {cfg.head_dim_}, {cfg.n_experts} experts top-"
        f"{cfg.top_k} of d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, untied "
        f"embeddings, capacity factor {cfg.capacity_factor}; {n_params:,} "
        f"parameters ({param_bytes / 1e9:.3f} GB in {cfg.dtype}) drawn on the "
        f"card in {init_s:.2f}s (drawing peaked at {init_peak / 2**30:.3f} "
        f"GiB); no cut ({held / 2**30:.3f} GiB still held from earlier "
        f"phases)")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.monotonic()
    eng, done = launch.serve(cfg, SERVE_REQUESTS, SERVE_REPLICAS,
                             SERVE_POLICY, SERVE_MAX_NEW, SERVE_SEED, dev,
                             params=params)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    counts = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    for line in launch.report(eng, done, SERVE_REPLICAS, SERVE_POLICY):
        log(line)
    card = describe(dev)
    if len(done) != SERVE_REQUESTS or any(
            len(r.output) != SERVE_MAX_NEW or
            not all(0 <= t < cfg.vocab_size for t in r.output)
            for r in done):
        failures.append("moe: not every request got its tokens")
    n_flash = cfg.n_layers * len(eng.waves)
    expected = dict.fromkeys(counts, 0)
    expected.update({"flash_attention": n_flash,
                     "flash_attention/wgmma": n_flash})
    log(f"[moe] launches {counts} (flash_attention: layers x waves = "
        f"{cfg.n_layers} x {len(eng.waves)} = {n_flash}, all on tensor "
        f"cores)")
    if counts != expected:
        failures.append(f"moe: launches {counts}, expected {expected}")
    if not peak < 80e9:
        failures.append(f"moe: peak device memory {peak} B")

    # a decode step routes one token of each of the wave's B requests: an
    # expert gets at most B pairs, so no step drops one where the capacity
    # holds B (qwen3: int(8 x 1.25 x 1) = 10 slots for at most 8 pairs)
    b = eng.waves[0].tokens.shape[0]
    decode_cap = MoE.capacity(b, cfg.n_experts, cfg.top_k,
                              cfg.capacity_factor)
    log(f"[moe] decode: {decode_cap} slots per expert for at most {b} pairs "
        f"a step, so no decode step drops a pair")
    if decode_cap < b:
        failures.append(f"moe: a decode step can drop pairs ({decode_cap} "
                        f"slots, {b} requests)")

    # every layer of every wave: attention and MoE against their plain
    # versions, and the pairs each layer drops
    walks, waves = [], []
    for k, w in enumerate(eng.waves):
        walk = _moe_walk(cfg, params, w.tokens, set(range(cfg.n_blocks)))
        rows = torch.arange(len(w.lens), device=dev)
        last = torch.tensor([n - 1 for n in w.lens], device=dev)
        walk_vs_engine = float((walk["logits"][rows, last]
                                - w.prefill_logits).abs().max())
        del walk["logits"]
        dropped = (~walk["kept"]).sum((1, 2, 3)).tolist()
        per_row = _rows_against_replay(w.prefill_logits, w.replay_logits,
                                       walk["kept"], w.lens)
        walks.append(walk)
        waves.append({"forward_ms": w.forward_s * 1e3,
                      "replay_ms_per_step": w.replay_s * 1e3 / w.replay_steps,
                      "decode_ms_per_step": w.decode_s * 1e3 / w.decode_steps,
                      "dropped_by_layer": dropped, "rows": per_row,
                      "walk_vs_engine_abs": walk_vs_engine})
        log(f"[moe] wave {k}: dropped (token, choice) pairs per layer "
            f"(of {w.tokens.numel() * cfg.top_k}, padding included): "
            + " ".join(str(d) for d in dropped)
            + f"; the walk's logits vs the engine forward's, max abs diff "
            f"{walk_vs_engine:.3g}")
        log(f"[moe] wave {k} (bf16): forward vs decode replay per request, "
            f"max abs diff / max|logit| (pairs dropped up to its last prompt "
            f"position): "
            + ", ".join(f"{r['forward_vs_replay']:.3g} ({r['dropped_pairs']})"
                        for r in per_row)
            + " (reported, not bounded: bf16 at full width)")
    attn = max(c["attention_vs_ref"] for wk in walks for c in wk["checks"])
    moe = max(c["moe_vs_onehot"] for wk in walks for c in wk["checks"])
    aux_gap = max(abs(c["aux"] - c["aux_onehot"]) / c["aux_onehot"]
                  for wk in walks for c in wk["checks"])
    log(f"[moe] every layer of both waves on the flash forward's own hidden "
        f"states (bf16), max abs diff / max|output|: attention flash vs ref "
        f"{attn:.4g}, MoE block (sort+gather) vs moe_block_onehot {moe:.4g}, "
        f"aux relative {aux_gap:.3g} (tolerance 2e-2 on each)")
    if not attn <= 2e-2:
        failures.append(f"moe: flash attention block vs ref {attn}")
    if not moe <= 2e-2:
        failures.append(f"moe: moe_block vs moe_block_onehot {moe}")
    if not aux_gap <= 2e-2:
        failures.append(f"moe: aux vs onehot {aux_gap}")
    del walks

    # fp32, the weights widened, at each depth: the MoE block against the
    # one-hot one, and forward vs replay on the requests that dropped no
    # pair up to their last prompt position (the first depth is held; at
    # the full depth the random weights' sharp attention makes fp32
    # rounding grow to O(1) over the layers, as bf16's does sooner)
    fp32 = {d: [_moe_fp32_check(cfg, params, w, d) for w in eng.waves]
            for d in MOE_FP32_DEPTHS}
    moe32 = max(c["moe_vs_onehot"] for runs in fp32.values() for f in runs
                for c in f["checks"])
    log(f"[moe] MoE block with the weights in fp32 (layers 0-1 of both "
        f"waves at each depth): sort+gather vs one-hot, max abs diff / "
        f"max|output| {moe32:.3g} (tolerance 1e-4)")
    if not moe32 <= 1e-4:
        failures.append(f"moe: fp32 moe_block vs onehot {moe32}")
    fp32_summary = {}
    for d, runs in fp32.items():
        clean = [r for f in runs for r in f["rows"] if r["dropped_pairs"] == 0]
        worst = max((r["forward_vs_replay"] for r in clean), default=None)
        fp32_summary[d] = {"clean_rows": len(clean), "worst": worst,
                           "argmax_equal": sum(r["argmax_equal"]
                                               for r in clean)}
        for k, f in enumerate(runs):
            log(f"[moe] fp32, first {d} layers, wave {k}: dropped pairs per "
                f"layer " + " ".join(str(n) for n in f["dropped_by_layer"])
                + "; forward vs decode replay per request (pairs dropped up "
                "to its last prompt position): "
                + ", ".join(f"{r['forward_vs_replay']:.3g} "
                            f"({r['dropped_pairs']})" for r in f["rows"]))
        bounded = d == MOE_FP32_DEPTHS[0]
        log(f"[moe] fp32, first {d} of {cfg.n_layers} layers: {len(clean)} "
            f"of {sum(len(f['rows']) for f in runs)} requests dropped no "
            f"pair up to their last prompt position; their forward vs decode "
            f"replay, max abs diff / max|logit| "
            + ("none" if worst is None else f"{worst:.4g}")
            + f", argmax equal in {fp32_summary[d]['argmax_equal']} "
            + ("(tolerance 2e-2)" if bounded else "(reported, not bounded)"))
        if bounded and not clean:
            failures.append(f"moe: no request without a dropped pair in "
                            f"the first {d} layers")
        elif bounded and not worst <= 2e-2:
            failures.append(f"moe: fp32 forward vs replay at depth {d} on "
                            f"requests without a drop {worst}")

    divergence = _stream_divergence(cfg, params, eng.waves[-1].tokens)
    marks = sorted({k for k in (0, 1, 3, 7, 15, 31) if k < len(divergence)}
                   | {len(divergence) - 1})
    log("[moe] fp32 (weights widened), last wave: the residual streams of "
        "the forward with flash and with ref attention apart after layer k, "
        "max abs diff / max|x|: "
        + ", ".join(f"k={k}: {divergence[k]:.3g}" for k in marks)
        + " (reported: the growth with depth that the forward vs replay "
        "comparison meets beyond the first layers)")

    prof = _profile_decode(eng)
    experts = _experts_decode_ms(cfg, params, dev)
    experts_ms = experts["experts_ms_per_layer"] * cfg.n_layers
    block_ms = experts["moe_block_ms_per_layer"] * cfg.n_layers
    expert_bytes = (cfg.n_layers * cfg.n_experts * 3 * cfg.d_model
                    * cfg.d_ff * 2)
    bound_ms = expert_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[moe] decode step profiled ({card}): wall "
        f"{prof['wall_ms_per_step']:.3f} ms, card busy "
        f"{prof['busy_ms_per_step']:.3f} ms ({prof['busy_share']:.3f} of the "
        f"wall), {prof['kernels_per_step']:.0f} kernels per step; top: "
        + "; ".join(f"{k} {ms:.3f} ms" for k, ms in prof["top"]))
    log(f"[moe] decode step's MoE on the card ({card}; layer 0's weights, "
        f"graph-replayed, x {cfg.n_layers} layers): the experts' products "
        f"{experts_ms:.3f} ms, the whole MoE blocks {block_ms:.3f} ms, of the "
        f"step's {prof['busy_ms_per_step']:.3f} ms busy; reading every "
        f"expert's weights ({expert_bytes / 1e9:.2f} GB, "
        f"{experts['capacity']} slots each) bounds the experts at "
        f"{bound_ms:.2f} ms ({bound_ms / experts_ms:.3f} of it reached)")
    steps = sum(w.replay_steps + w.decode_steps for w in eng.waves)
    step_ms = sum(w.replay_s + w.decode_s for w in eng.waves) * 1e3 / steps
    log(f"[moe] on {card}: serve wall {wall_s:.3f}s for {SERVE_REQUESTS} "
        f"requests; forward (prefill) "
        + ", ".join(f"{w['forward_ms']:.2f}" for w in waves)
        + f" ms per wave; decode {step_ms:.3f} ms per step over {steps} "
        f"steps; peak device memory {peak / 2**30:.3f} GiB (weights "
        f"{param_bytes / 2**30:.3f} GiB included)")
    return {"arch": cfg.name, "params": n_params, "param_bytes": param_bytes,
            "init_s": init_s, "init_peak_memory_bytes": init_peak,
            "wall_s": wall_s, "launches": counts["flash_attention"],
            "launches_wgmma": counts["flash_attention/wgmma"],
            "launches_all": counts, "waves": waves,
            "attention_vs_ref": attn, "moe_vs_onehot": moe,
            "fp32": fp32, "fp32_summary": fp32_summary,
            "fp32_stream_divergence": divergence,
            "fp32_moe_vs_onehot": moe32,
            "decode_ms_per_step": step_ms, "decode_profile": prof,
            "decode_experts_ms": experts_ms, "decode_moe_ms": block_ms,
            "decode_experts_bound_ms": bound_ms, "peak_memory_bytes": peak,
            "held_before_bytes": held,
            "prefill_tokens": eng.prefill_tokens,
            "reused_tokens": eng.reused_tokens,
            "router": eng.router.stats(), "card": card}


def _hybrid_serve(failures: list) -> dict:
    """One wave of reduced jamba (attention, Mamba, dense and MoE
    sub-layers in one pattern) through the launcher's code path, with the
    flash and scan kernels in the forward, in fp32 and in bf16; the
    forward's logits against the plain path's (ref attention, chunked
    scan)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import mamba_scan as ms
    from repro_torch.launch import serve as launch
    from repro_torch.models import make_forward

    dev = torch.device("cuda", 0)
    base = get_config(HYBRID_ARCH).reduced().with_(attn_impl="flash",
                                                   use_mamba_kernel=True)
    n_attn = base.n_blocks * sum(s.kind == "attn" for s in base.pattern)
    n_mamba = base.n_blocks * sum(s.kind == "mamba" for s in base.pattern)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = base.with_(dtype=dtype)
        _reset_launches()
        eng, done = launch.serve(cfg, launch.WAVE, SERVE_REPLICAS,
                                 SERVE_POLICY, SERVE_MAX_NEW, SERVE_SEED, dev)
        torch.cuda.synchronize()
        counts = _read_launches()
        w = eng.waves[0]
        with torch.inference_mode():
            kernel, _ = make_forward(cfg)(eng.params, {"tokens": w.tokens})
            plain, _ = make_forward(cfg.with_(attn_impl="ref",
                                              use_mamba_kernel=False))(
                eng.params, {"tokens": w.tokens})
        rel = _rel(kernel, plain)
        # the kernels the shape rules give: bf16 at head dim 16 on tensor
        # cores, fp32 on the SIMT kernel; the scan's lanes by B and I
        fa_path = "wgmma" if dtype == "bfloat16" else "simt"
        scan_path = ms.kernel_path(w.tokens.shape[0], cfg.d_inner)
        expected = dict.fromkeys(counts, 0)
        expected.update({"flash_attention": n_attn,
                         f"flash_attention/{fa_path}": n_attn,
                         "mamba_scan": n_mamba,
                         f"mamba_scan/{scan_path}": n_mamba})
        log(f"[hybrid] reduced {cfg.name} in {dtype} ({cfg.n_layers} layers "
            f"of pattern " + " ".join(f"{s.kind}/{s.mlp}" for s in cfg.pattern)
            + f", {cfg.n_experts} experts top-{cfg.top_k}), one wave of "
            f"{len(done)} requests: launches {counts}; forward (flash + scan "
            f"kernels) vs the plain path (ref attention, chunked scan), max "
            f"abs diff / max|logit| {rel:.4g}"
            + (" (tolerance 2e-2)" if dtype == "float32" else
               " (reported, not bounded: bf16 routing near-ties flip)"))
        if counts != expected:
            failures.append(f"hybrid {dtype}: launches {counts}, expected "
                            f"{expected}")
        if dtype == "float32" and not rel <= 2e-2:
            failures.append(f"hybrid: fp32 kernel path vs plain {rel}")
        out[dtype] = {"launches": counts, "kernel_vs_plain": rel}
    return out


def _moe_train(failures: list) -> dict:
    """The app's moe-30m preset trained through its code path
    (``apps.train_lm``: its pipeline and optimizer) for a few steps on the
    card; then, at the trained state, the aux loss and every router
    slice's gradient."""
    from repro_torch.apps import train_lm
    from repro_torch.device import describe
    from repro_torch.models.model import make_hidden_forward, make_loss_fn
    from repro_torch.train import adamw, train

    dev = torch.device("cuda", 0)
    cfg = train_lm.PRESETS[MOE_TRAIN_PRESET].with_(attn_impl="flash")
    pipeline = train_lm.make_pipeline(cfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                                      MOE_TRAIN_HOSTS, MOE_TRAIN_SHARDS,
                                      TRAIN_SEED, dev)
    try:
        _reset_launches()
        t0 = time.monotonic()
        result = train(cfg, pipeline, TRAIN_STEPS,
                       optimizer=adamw(train_lm.PEAK_LR,
                                       warmup=train_lm.WARMUP,
                                       total=TRAIN_STEPS),
                       seed=TRAIN_SEED, log_every=1, log=log, device=dev)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        counts = _read_launches()
        tokens = pipeline.fetch_step(0)
        fell = _loss_fell(cfg, result.state.params, pipeline, TRAIN_STEPS,
                          TRAIN_SEED, dev)
    finally:
        pipeline.close()
    n_flash = 2 * cfg.n_layers * TRAIN_STEPS
    expected = dict.fromkeys(counts, 0)
    expected.update({"flash_attention": n_flash,
                     "flash_attention/wgmma": n_flash})
    if counts != expected:
        failures.append(f"moe train: launches {counts}, expected {expected}")
    losses = result.losses
    w = TRAIN_WINDOW
    first, last = float(np.mean(losses[:w])), float(np.mean(losses[-w:]))
    params = result.state.params
    router = params["blocks"]["sub0"]["w_router"].requires_grad_()
    with torch.no_grad():
        _, aux = make_hidden_forward(cfg)(params, {"tokens": tokens})
    loss = make_loss_fn(cfg)(params, {"tokens": tokens})
    (g,) = torch.autograd.grad(loss, [router])
    bad = [i for i in range(g.shape[0])
           if not (bool(torch.isfinite(g[i]).all())
                   and float(g[i].abs().max()) > 0)]
    step_ms = statistics.median(result.step_seconds[1:]) * 1e3
    log(f"[moe-train] {cfg.name} ({cfg.param_count():,} parameters, "
        f"{cfg.n_experts} experts top-{cfg.top_k}) through apps.train_lm's "
        f"pipeline and optimizer, {TRAIN_STEPS} steps of {MOE_TRAIN_BATCH} x "
        f"{MOE_TRAIN_SEQ} tokens on {describe(dev)}: launches {counts}; "
        f"losses {', '.join(f'{x:.4f}' for x in losses)} (mean of the first "
        f"{w} {first:.4f}, of the last {w} {last:.4f}, reported); mean loss "
        f"over the run's batches at the initial weights {fell['before']:.4f}, "
        f"at the trained ones {fell['after']:.4f} (must fall); aux at the "
        f"trained state {float(aux):.4f}; w_router gradient finite and "
        f"non-zero in "
        f"{g.shape[0] - len(bad)} of {g.shape[0]} layers; {step_ms:.1f} ms "
        f"per step (median of steps 2-{TRAIN_STEPS}), train wall "
        f"{wall_s:.1f}s")
    if not (all(np.isfinite(losses)) and fell["fell"]):
        failures.append(f"moe train: the loss did not fall "
                        f"({fell['before']} -> {fell['after']} on the run's "
                        f"batches)")
    if not (bool(torch.isfinite(aux)) and float(aux) > 0):
        failures.append(f"moe train: aux {float(aux)}")
    if bad:
        failures.append(f"moe train: w_router gradient zero or non-finite "
                        f"in layers {bad}")
    return {"preset": MOE_TRAIN_PRESET, "losses": losses,
            "loss_on_batches": fell, "aux": float(aux),
            "launches": counts["flash_attention"],
            "launches_all": counts, "router_grad_bad_layers": bad,
            "step_ms": step_ms, "wall_s": wall_s}


def _grad_gaps(cfg, params, tokens, routes: dict) -> dict:
    """The loss and every gradient leaf at ``params`` under each of two
    routes (config overrides; the first is held to the second): the loss's
    relative difference, and per leaf max abs diff / max|g| of the second,
    with the launches of each route's loss and gradient."""
    from repro_torch.models.model import make_loss_fn
    from repro_torch.models.transformer import flatten

    pairs = flatten(params)
    leaves = [p.requires_grad_() for _, p in pairs]
    out = {}
    for name, kw in routes.items():
        _reset_launches()
        loss = make_loss_fn(cfg.with_(**kw))(params, {"tokens": tokens})
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[name] = (float(loss.detach()), grads, _read_launches())
    (loss_k, grads_k, launches_k), (loss_p, grads_p, launches_p) = \
        out.values()
    rel = {path: float((gk - gp).abs().max() / gp.abs().max())
           for (path, _), gk, gp in zip(pairs, grads_k, grads_p)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    for p in leaves:
        p.requires_grad_(False)
    return {"loss": {name: v[0] for name, v in out.items()},
            "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
            "grad_rel": rel, "finite": finite,
            "launches": {name: v[2] for name, v in out.items()}}


def _hybrid_train(failures: list) -> dict:
    """Reduced jamba trained through the launcher's code path (its
    pipeline, ``train``) for TRAIN_STEPS steps at the moe-30m traffic, on
    the card with flash, the scan and the MoE layer, remat full; then in
    fp32 at its initial weights, the kernel route's loss and gradients
    (flash, scan) against the plain route's (ref attention, chunked
    scan)."""
    from repro_torch.configs import get_config
    from repro_torch.device import describe
    from repro_torch.kernels.mamba_scan import mamba_scan as ms
    from repro_torch.launch import train as launch
    from repro_torch.models import init_params
    from repro_torch.train import adamw, train

    dev = torch.device("cuda", 0)
    cfg = get_config(HYBRID_ARCH).reduced().with_(attn_impl="flash",
                                                  use_mamba_kernel=True)
    n_attn = cfg.n_blocks * sum(s.kind == "attn" for s in cfg.pattern)
    n_mamba = cfg.n_blocks * sum(s.kind == "mamba" for s in cfg.pattern)
    pipeline = launch.make_pipeline(cfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ - 1,
                                    MOE_TRAIN_HOSTS, SERVE_POLICY, 64,
                                    MOE_TRAIN_SHARDS, TRAIN_SEED, dev)
    try:
        _reset_launches()
        t0 = time.monotonic()
        result = train(cfg, pipeline, TRAIN_STEPS,
                       optimizer=adamw(TRAIN_LR, warmup=TRAIN_WARMUP,
                                       total=TRAIN_TOTAL),
                       seed=TRAIN_SEED, log_every=TRAIN_STEPS, log=log,
                       device=dev)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        counts = _read_launches()
        tokens = pipeline.fetch_step(0)
        fell = _loss_fell(cfg, result.state.params, pipeline, TRAIN_STEPS,
                          TRAIN_SEED, dev)
    finally:
        pipeline.close()
    scan_path = ms.kernel_path(MOE_TRAIN_BATCH, cfg.d_inner)
    expected = dict.fromkeys(counts, 0)
    expected.update({
        "flash_attention": 2 * n_attn * TRAIN_STEPS,
        "flash_attention/wgmma": 2 * n_attn * TRAIN_STEPS,
        "mamba_scan": 2 * n_mamba * TRAIN_STEPS,
        f"mamba_scan/{scan_path}": 2 * n_mamba * TRAIN_STEPS})
    if counts != expected:
        failures.append(f"hybrid train: launches {counts}, expected "
                        f"{expected}")
    losses = result.losses
    if not (all(np.isfinite(losses)) and fell["fell"]):
        failures.append(f"hybrid train: the loss did not fall "
                        f"({fell['before']} -> {fell['after']} on the run's "
                        f"batches)")
    cfg32 = cfg.with_(dtype="float32")
    params = init_params(cfg32, torch.Generator(dev).manual_seed(TRAIN_SEED),
                         dev)
    gaps = _grad_gaps(cfg32, params, tokens, {
        "kernels": {}, "plain": {"attn_impl": "ref",
                                 "use_mamba_kernel": False}})
    worst = max(gaps["grad_rel"].values())
    step_ms = statistics.median(result.step_seconds[1:]) * 1e3
    log(f"[hybrid-train] reduced {cfg.name} ({cfg.param_count():,} "
        f"parameters in {cfg.dtype}; {n_attn} attention, {n_mamba} Mamba "
        f"layers, {cfg.n_experts} experts top-{cfg.top_k}), {TRAIN_STEPS} "
        f"steps of {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ} tokens on "
        f"{describe(dev)}: launches {counts} (2 x layers x steps each: the "
        f"forward and the remat recompute); losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; mean loss over the run's "
        f"batches at the initial weights {fell['before']:.4f}, at the "
        f"trained ones {fell['after']:.4f} (must fall); {step_ms:.1f} ms per "
        f"step (median of steps 2-{TRAIN_STEPS}), train wall {wall_s:.1f}s")
    log(f"[hybrid-train] fp32, initial weights, one batch: loss kernels "
        f"{gaps['loss']['kernels']:.6f} vs plain {gaps['loss']['plain']:.6f}"
        f" (relative {gaps['loss_rel']:.3g}); gradients, max abs diff / "
        f"max|g| over {len(gaps['grad_rel'])} leaves {worst:.3g} (tolerance "
        f"2e-2); kernel route launches {gaps['launches']['kernels']}")
    if not (gaps["finite"] and worst <= 2e-2):
        failures.append(f"hybrid train: fp32 gradients, kernels vs plain "
                        f"{worst} (finite {gaps['finite']})")
    return {"losses": losses, "loss_on_batches": fell, "launches": counts,
            "step_ms": step_ms, "wall_s": wall_s, "fp32_grads": gaps}


def phase_moe() -> dict:
    """Phase 8: qwen3-moe-30b-a3b served at full width, the hybrid checks
    (served, and trained) and the moe-30m training check; any failure
    raises at the end."""
    failures: list = []
    serve = _moe_serve(failures)
    gc.collect()
    torch.cuda.empty_cache()
    hybrid = _hybrid_serve(failures)
    hybrid_train = _hybrid_train(failures)
    trained = _moe_train(failures)
    if failures:
        raise AssertionError("moe: " + "; ".join(failures))
    return {"serve": serve, "hybrid": hybrid, "hybrid_train": hybrid_train,
            "train": trained}


# --------------------------------------------------------------------------
# phase 9: training falcon-mamba-7b through the launcher's code path
# --------------------------------------------------------------------------

#: the name of the profiler range around each plain backward scan
SCAN_BACKWARD_RANGE = "mamba_scan_with_ref_vjp backward (plain chunked scan)"
#: the products' kernels, by name (cuBLAS, cuBLASLt and CUTLASS GEMMs and
#: GEMVs)
PRODUCT_KERNELS = ("gemm", "gemv", "nvjet", "xmma", "cutlass")


class _named_scan_backward:
    """While active, each backward of ``mamba_scan_with_ref_vjp`` runs in
    a profiler range named SCAN_BACKWARD_RANGE (the autograd node looks
    the backward up on its class at each call)."""

    def __enter__(self):
        from repro_torch.kernels.mamba_scan import ops as ms_ops

        self.cls = ms_ops._ScanRefVJP
        self.real = self.cls.backward

        def backward(ctx, *grads):
            with torch.profiler.record_function(SCAN_BACKWARD_RANGE):
                return self.real(ctx, *grads)
        self.cls.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        self.cls.backward = staticmethod(self.real)


def _profile_ssm_train(step_fn, state, pipeline, start: int):
    """One more train step under torch.profiler, each plain backward scan
    in its named range: host wall, card busy time (the sum of its kernels'
    times) split into the scan kernel, the plain backward scans (every
    kernel that runs within their ranges on the card's timeline: one
    stream, so nothing else runs there then), the products outside them
    and the rest, and the kernels that take the most card time.  The
    profiler's raw events are read directly: parsing the ~450,000 kernels
    of a step into its Python event tree takes minutes."""
    from bisect import bisect_right

    from torch.profiler import ProfilerActivity, profile

    tokens = pipeline.fetch_step(start)
    torch.cuda.synchronize()
    with _named_scan_backward(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens})
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t_read = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    kernels, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        if e.name() == SCAN_BACKWARD_RANGE:
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif not e.is_user_annotation():
            kernels.append((e.start_ns(), e.duration_ns() / 1e6, e.name()))
    ranges.sort()
    starts = [r[0] for r in ranges]
    split = dict.fromkeys(("scan kernel", "plain backward scan", "products",
                           "the rest"), 0.0)
    by_name: dict = {}
    for start_ns, ms, name in kernels:
        k = bisect_right(starts, start_ns) - 1
        if k >= 0 and start_ns < ranges[k][1]:
            kind = "plain backward scan"
        elif "mamba_scan_kernel" in name:
            kind = "scan kernel"
        elif any(w in name.lower() for w in PRODUCT_KERNELS):
            kind = "products"
        else:
            kind = "the rest"
        split[kind] += ms
        by_name[name] = by_name.get(name, 0.0) + ms
    busy_ms = sum(split.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return state, {"wall_ms": wall_ms, "busy_ms": busy_ms,
                   "busy_share": busy_ms / wall_ms, "kernels": len(kernels),
                   "scan_backward_ranges": len(ranges), "split_ms": split,
                   "top": [(n[:70], ms) for n, ms in top],
                   "read_s": time.perf_counter() - t_read}


def _products_seen(cfg, params, tokens) -> dict:
    """The products one forward of ``cfg`` dispatches on the card, by op
    and batch (``torch.einsum`` may lower them otherwise than on the CPU),
    and what remat dots's policy does with each kind."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import transformer as T
    from repro_torch.models.model import make_hidden_forward

    seen: dict = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "mm" in func.__name__:
                policy = T._save_products_without_batch(None, func, *args)
                key = (f"{func.__name__} batch "
                       f"{args[0].shape[0] if args[0].dim() == 3 else '-'}: "
                       f"{policy.name}")
                seen[key] = seen.get(key, 0) + 1
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Count():
        make_hidden_forward(cfg)(params, {"tokens": tokens})
    return seen


def _steps_ms(step_fn, state, pipeline, start: int, steps: int):
    """``steps`` train steps from ``state``: host wall per step (each
    ending in the loss's read) and the peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps):
        tokens = pipeline.fetch_step(start + i)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens})
        float(metrics["loss"])
        times.append(time.perf_counter() - t0)
    return state, {"ms_per_step": [t * 1e3 for t in times],
                   "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def phase_ssm_train() -> dict:
    """Phase 9: falcon-mamba-7b trained at full width, its depth cut to
    SSM_TRAIN_LAYERS, with the scan kernel in every Mamba forward."""
    from repro_torch.configs import get_config
    from repro_torch.device import describe
    from repro_torch.kernels.mamba_scan import mamba_scan as ms
    from repro_torch.launch import train as launch
    from repro_torch.models import init_params
    from repro_torch.models.model import make_train_step
    from repro_torch.train import adamw, train

    dev = torch.device("cuda", 0)
    full = get_config(SSM_ARCH).with_(use_mamba_kernel=True)
    cfg = full.with_(n_layers=SSM_TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    embed = 2 * full.vocab_size * full.d_model
    per_layer = (full.param_count() - embed) // full.n_layers
    reckon = {n: 12 * (embed + n * per_layer) for n in (full.n_layers,
                                                       SSM_TRAIN_LAYERS)}
    log(f"[ssm-train] {cfg.name} at its published widths: d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, state {cfg.ssm_state}, "
        f"dt_rank {cfg.dt_rank}, conv {cfg.ssm_conv}, vocab {cfg.vocab_size} untied, "
        f"ssm_chunk {cfg.ssm_chunk}; {per_layer:,} parameters a layer, "
        f"{embed:,} in the embeddings; 12 B of state a parameter (bf16 "
        f"weight and gradient, fp32 AdamW m and v): {full.n_layers} layers "
        f"{reckon[full.n_layers] / 1e9:.1f} GB, {SSM_TRAIN_LAYERS} layers "
        f"{reckon[SSM_TRAIN_LAYERS] / 1e9:.1f} GB, the card {total / 1e9:.1f}"
        f" GB ({free / 1e9:.1f} free, {held / 2**30:.3f} GiB held from "
        f"earlier phases): depth cut to {SSM_TRAIN_LAYERS} layers "
        f"({cfg.param_count():,} parameters), remat {cfg.remat}, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ + 1} tokens from {TRAIN_SHARDS} shards "
        f"over {TRAIN_HOSTS} executors on the card")
    opt = adamw(TRAIN_LR, warmup=TRAIN_WARMUP, total=TRAIN_TOTAL)
    pipeline = launch.make_pipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_HOSTS,
                                    SERVE_POLICY, 64, TRAIN_SHARDS,
                                    TRAIN_SEED, dev)
    failures = []
    card = describe(dev)
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.monotonic()
        result = train(cfg, pipeline, TRAIN_STEPS, optimizer=opt,
                       seed=TRAIN_SEED, log_every=1, log=log, device=dev)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        counts = _read_launches()
        peak = torch.cuda.max_memory_allocated()
        for line in launch.report(result, cfg, TRAIN_BATCH, TRAIN_SEQ, dev,
                                  peak):
            log(line)
        path = ms.kernel_path(TRAIN_BATCH, cfg.d_inner)
        n_scan = 2 * cfg.n_layers * TRAIN_STEPS
        expected = dict.fromkeys(counts, 0)
        expected.update({"mamba_scan": n_scan, f"mamba_scan/{path}": n_scan})
        log(f"[ssm-train] launches {counts} (mamba_scan: 2 x layers x steps "
            f"= 2 x {cfg.n_layers} x {TRAIN_STEPS} = {n_scan}, the forward "
            f"and the remat recompute, all on the {path} layout)")
        if counts != expected:
            failures.append(f"launches {counts}, expected {expected}")
        losses = result.losses
        fell = _loss_fell(cfg, result.state.params, pipeline, TRAIN_STEPS,
                          TRAIN_SEED, dev)
        log(f"[ssm-train] losses {', '.join(f'{x:.4f}' for x in losses)}; "
            f"mean loss over the run's {TRAIN_STEPS} batches at the initial "
            f"weights {fell['before']:.4f}, at the trained ones "
            f"{fell['after']:.4f} (must fall)")
        if not (all(np.isfinite(losses)) and fell["fell"]):
            failures.append(f"the loss did not fall ({fell['before']} -> "
                            f"{fell['after']} on the run's batches)")
        step_seconds = result.step_seconds
        step_ms = statistics.median(step_seconds[1:]) * 1e3
        state = result.state
        del result
        step_fn = make_train_step(cfg, opt)
        state, prof = _profile_ssm_train(step_fn, state, pipeline,
                                         TRAIN_STEPS)
        log(f"[ssm-train] 1 train step profiled ({card}): wall "
            f"{prof['wall_ms']:.1f} ms, card busy {prof['busy_ms']:.1f} ms "
            f"({prof['busy_share']:.3f} of the wall), {prof['kernels']} "
            f"kernels, {prof['scan_backward_ranges']} plain backward scans; "
            f"split: " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                   prof["split_ms"].items())
            + "; top: " + "; ".join(f"{k} {v:.2f} ms" for k, v in prof["top"])
            + f" (events read in {prof['read_s']:.1f}s)")
        tokens = pipeline.fetch_step(0)
        grads = _leaf_grads(cfg, state.params, tokens, sorted(
            n for n in state.params["blocks"]["sub0"] if n != "ln1_scale"))
        bad = [f"{r['leaf']}[{r['layer']}]" for r in grads
               if not r["finite"] or not r["max_abs"] > 0]
        leaves = sorted({r["leaf"] for r in grads})
        log(f"[ssm-train] full-width gradient of every Mamba leaf at the "
            f"trained state ({', '.join(leaves)}): {len(grads)} (leaf, layer)"
            f" slices, {len(grads) - len(bad)} finite and non-zero; smallest "
            f"max|g| {min(r['max_abs'] for r in grads):.3g}")
        if bad:
            failures.append(f"Mamba gradients zero or non-finite: {bad}")
        state, dots = _steps_ms(make_train_step(cfg.with_(remat="dots"), opt),
                                state, pipeline, TRAIN_STEPS + 1,
                                SSM_DOTS_STEPS)
        log(f"[ssm-train] remat dots, {SSM_DOTS_STEPS} steps: "
            + ", ".join(f"{t:.1f}" for t in dots["ms_per_step"])
            + f" ms, peak device memory "
            f"{dots['peak_memory_bytes'] / 2**30:.3f} GiB (remat full above: "
            f"{step_ms:.1f} ms, peak {peak / 2**30:.3f} GiB)")
        products = _products_seen(cfg.with_(n_layers=1), {
            k: ({"sub0": {n: v[:1] for n, v in state.params["blocks"][
                "sub0"].items()}} if k == "blocks" else v)
            for k, v in state.params.items()}, tokens[:, :64])
        log(f"[ssm-train] products of a 1-layer forward on the card, by op "
            f"and batch, with remat dots's choice: {products}")
        del state
    finally:
        pipeline.close()
    gc.collect()
    torch.cuda.empty_cache()
    small = _ssm_two_layer_fp32(tokens)
    worst = max(small["grad_rel"].values())
    log(f"[ssm-train] 2 layers at full width in fp32, one batch: loss scan "
        f"kernel {small['loss']['kernel']:.6f} vs plain chunked scan "
        f"{small['loss']['plain']:.6f} (relative {small['loss_rel']:.3g}, "
        f"tolerance 1e-4); gradients, max abs diff / max|g| over "
        f"{len(small['grad_rel'])} leaves {worst:.3g} (tolerance 2e-2); "
        f"launches {small['launches']['kernel']['mamba_scan']} (kernel "
        f"route) and {small['launches']['plain']['mamba_scan']} (plain)")
    if not (small["finite"] and small["loss_rel"] <= 1e-4):
        failures.append(f"2-layer fp32 loss: kernel vs plain "
                        f"{small['loss_rel']}")
    if not worst <= 2e-2:
        failures.append(f"2-layer fp32 gradients: kernel vs plain {worst}")
    if small["launches"]["kernel"]["mamba_scan"] != 4:
        failures.append(f"2-layer fp32: {small['launches']['kernel']} "
                        f"launches, expected 2 x 2")
    tokens_per_step = TRAIN_BATCH * (TRAIN_SEQ + 1)
    log(f"[ssm-train] on {card}: {step_ms:.1f} ms per step (median of steps "
        f"2-{TRAIN_STEPS}), {tokens_per_step / (step_ms * 1e-3):.0f} "
        f"tokens/s at {SSM_TRAIN_LAYERS} of {full.n_layers} layers; peak "
        f"device memory {peak / 2**30:.3f} GiB; train wall {wall_s:.1f}s for "
        f"{TRAIN_STEPS} steps")
    if failures:
        raise AssertionError("ssm train: " + "; ".join(failures))
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "layers_published": full.n_layers, "params": cfg.param_count(),
            "state_bytes_reckoned": reckon, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ + 1, "steps": TRAIN_STEPS, "losses": losses,
            "loss_on_batches": fell, "step_ms": step_ms,
            "step_ms_all": [t * 1e3 for t in step_seconds],
            "tokens_per_s": tokens_per_step / (step_ms * 1e-3),
            "peak_memory_bytes": peak, "held_before_bytes": held,
            "wall_s": wall_s, "launches": counts["mamba_scan"],
            "launches_all": counts, "profile": prof, "mamba_grads": grads,
            "remat_dots": dots,
            "products_seen": products, "two_layer_fp32": small, "card": card}


def _ssm_two_layer_fp32(tokens) -> dict:
    """One batch through a 2-layer falcon-mamba-7b at full width in fp32:
    the loss and every gradient leaf with the scan kernel's route against
    the plain chunked scan's."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    dev = tokens.device
    cfg = get_config(SSM_ARCH).with_(n_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(dev).manual_seed(TRAIN_SEED),
                         dev)
    return _grad_gaps(cfg, params, tokens, {
        "kernel": {"use_mamba_kernel": True},
        "plain": {"use_mamba_kernel": False}})


# --------------------------------------------------------------------------
# phase 10: the encoder-decoder (whisper-base) and the vision model
# (llava-next-mistral-7b) at their published widths
# --------------------------------------------------------------------------

def _stub_embeds(params, shape, seed: int) -> torch.Tensor:
    """A stub frontend's embeddings: normal from a numpy seed at the std of
    the embedding table's entries, in the table's dtype, on its device."""
    table = params["embed"]
    std = float(table.float().std())
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(
        np.float32)).to(table.device, table.dtype)


def _flash_vs_ref(cfg, layers, x, pos, causal: bool, step) -> list[float]:
    """Layer by layer on the flash path's own hidden states: each layer's
    self-attention block with flash against the plain ``ref`` attention on
    the same input (max abs diff / max|ref output|).  ``layers`` are the
    layers' parameters; ``step(x, i)`` runs layer i on the flash path."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    var = T._variant(cfg, cfg.pattern[0], causal)
    out = []
    with torch.inference_mode():
        for i, p in enumerate(layers):
            h = T._norm(cfg, x, p, "ln1")
            a_f, a_r = (L.attention_block(h, p, pos, var, cfg.rope_theta,
                                          use_rope=cfg.use_rope, impl=impl)
                        for impl in ("flash", "ref"))
            out.append(float((a_f - a_r).abs().max() / a_r.abs().max()))
            x = step(x, i)
    return out


def _median_ms(fn, reps: int = 3) -> float:
    """Host-clock ms of ``fn`` ending in a synchronise, median of
    ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _encdec_layer_checks(cfg, params, frames, prompt, enc) -> dict:
    """Whisper's self-attentions layer by layer, flash against ref: the
    encoder's (unmasked) from the framed input, the decoder's (causal)
    from the prompt's embeddings against ``enc``."""
    from repro_torch.models import LayerSpec
    from repro_torch.models import transformer as T

    ecfg = cfg.with_(pattern=(LayerSpec(kind="attn", attn="full",
                                        mlp="dense"),),
                     n_layers=cfg.enc_layers)
    espec = ecfg.pattern[0]
    with torch.inference_mode():
        s_enc = frames.shape[1]
        x = frames + T._sinusoid(s_enc, cfg.d_model, frames.device).to(
            frames.dtype)[None]
        epos = torch.arange(s_enc, device=frames.device)
        elayers = [T._layer(params["encoder"]["sub0"], i)
                   for i in range(cfg.enc_layers)]
        encoder = _flash_vs_ref(
            ecfg, elayers, x, epos, False,
            lambda x, i: T._apply_sub(ecfg, espec, x, elayers[i], epos,
                                      causal=False)[0])
        y = T.embed_inputs(cfg, params, {"tokens": prompt})
        dpos = torch.arange(prompt.shape[1], device=prompt.device)
        block = T._encdec_block_fn(cfg, enc, dpos)
        slayers = [T._layer(params["blocks"]["sub0"], i)
                   for i in range(cfg.n_layers)]
        xlayers = [T._layer(params["cross"]["sub0"], i)
                   for i in range(cfg.n_layers)]
        decoder = _flash_vs_ref(
            cfg, slayers, y, dpos, True,
            lambda x, i: block(x, slayers[i], xlayers[i])[0])
    return {"encoder": encoder, "decoder": decoder}


def _encdec_replay(cfg, params, prompt, enc, new: int = 0):
    """The prompt through the serve step against ``enc`` (the replay),
    then ``new`` greedy steps: (the replay's logits at the last prompt
    position (B, V), the greedy tokens (B, new), replay s, decode s)."""
    from repro_torch.models import init_cache, make_serve_step

    step = make_serve_step(cfg)
    b, n = prompt.shape
    with torch.inference_mode():
        cache = init_cache(cfg, b, n + new, device=prompt.device)
        t0 = time.perf_counter()
        for t in range(n):
            lg, cache = step(params, cache, {"token": prompt[:, t: t + 1],
                                             "pos": t, "enc_out": enc})
        last = lg[:, -1].float()
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        tokens = []
        tok = lg[:, -1:].argmax(-1)
        t0 = time.perf_counter()
        for t in range(new):
            tokens.append(tok)
            lg, cache = step(params, cache, {"token": tok, "pos": n + t,
                                             "enc_out": enc})
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"decode step {t}: non-finite logits")
            tok = lg[:, -1:].argmax(-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    out = torch.cat(tokens, 1) if tokens else prompt[:, :0]
    return last, out, replay_s, decode_s


def _encdec_fp32_replay(cfg, params, frames, prompt, depth: int) -> float:
    """The weights widened to fp32 and cut to the first ``depth`` encoder
    and decoder layers: the serve-step replay's logits at the last prompt
    position against ``decode_train``'s (max abs diff / max|logit|)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import flatten, unflatten

    cut = cfg.with_(dtype="float32", n_layers=depth, enc_layers=depth)
    p32 = unflatten((k, (v[:depth] if k.split("/")[0] in T._STACKED_ROOTS
                         else v).float()) for k, v in flatten(params))
    with torch.inference_mode():
        enc = T.encode(cut, p32, frames.float())
        want = T.decode_train(cut, p32, enc, prompt)[0][:, -1]
    got = _encdec_replay(cut, p32, prompt, enc)[0]
    return float((got - want).abs().max() / want.abs().max())


def _encdec_serve(failures: list) -> dict:
    """whisper-base at full width and depth in bf16: the encoder over 8 x
    1500 frames, ``make_prefill`` on a 64-token prompt (12 flash launches,
    each counted alone), the prompt replayed through the serve step
    against the encoder's output and 8 greedy tokens; each self-attention
    layer by layer against ref; the replay against ``decode_train`` in
    fp32 end to end."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_prefill
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import flatten

    dev = torch.device("cuda", 0)
    cfg = get_config(ENCDEC_ARCH).with_(attn_impl="flash")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SERVE_SEED),
                         dev)
    n_params = sum(t.numel() for _, t in flatten(params))
    B = ENCDEC_BATCH
    frames = _stub_embeds(params, (B, ENCDEC_FRAMES, cfg.d_model), 0)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, ENCDEC_PROMPT))).to(dev)
    batch = {"frame_embeds": frames, "tokens": prompt}
    log(f"[encdec] {cfg.name} at its published widths and depth: "
        f"{cfg.enc_layers} encoder and {cfg.n_layers} decoder layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim_}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, learned positions "
        f"{cfg.max_learned_pos}; {n_params:,} parameters in {cfg.dtype} "
        f"(random, from seed {SERVE_SEED}); frames {tuple(frames.shape)}, "
        f"prompt {tuple(prompt.shape)}; no cut")
    prefill = make_prefill(cfg)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with torch.inference_mode():
        enc = T.encode(cfg, params, frames)
    torch.cuda.synchronize()
    enc_counts = _read_launches()
    _reset_launches()
    with torch.inference_mode():
        last = prefill(params, batch)
    torch.cuda.synchronize()
    counts = _read_launches()
    last_r, generated, replay_s, decode_s = _encdec_replay(
        cfg, params, prompt, enc, ENCDEC_NEW)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.enc_layers + cfg.n_layers
    log(f"[encdec] flash launches: the encoder alone {_nonzero(enc_counts)};"
        f" the prefill (encoder + decoder) {_nonzero(counts)} (expected "
        f"{cfg.enc_layers} "
        f"unmasked + {cfg.n_layers} causal = {L}, all on tensor cores; the "
        f"cross-attention takes the plain path, as in the reference)")
    if (enc_counts["flash_attention"], enc_counts["flash_attention/wgmma"]
            ) != (cfg.enc_layers, cfg.enc_layers):
        failures.append(f"encoder: flash launches {enc_counts}, expected "
                        f"{cfg.enc_layers} on wgmma")
    if (counts["flash_attention"], counts["flash_attention/wgmma"]
            ) != (L, L):
        failures.append(f"whisper prefill: flash launches {counts}, "
                        f"expected {L} on wgmma")
    if not (bool(torch.isfinite(last).all()) and bool(
            ((generated >= 0) & (generated < cfg.vocab_size)).all())):
        failures.append("whisper: non-finite prefill logits or tokens out "
                        "of the vocabulary")
    bf16_rel = float((last[:, -1] - last_r).abs().max()
                     / last[:, -1].abs().max())
    log(f"[encdec] greedy tokens of request 0: "
        f"{generated[0].tolist()}; bf16 prefill vs serve-step replay at the "
        f"last prompt position, max abs diff / max|logit| {bf16_rel:.4g} "
        f"(reported)")
    layers = _encdec_layer_checks(cfg, params, frames, prompt, enc)
    worst = max(layers["encoder"] + layers["decoder"])
    log(f"[encdec] layer by layer on the flash path's hidden states, "
        f"attention block flash vs ref, max abs diff / max|output|: encoder "
        f"(unmasked) " + ", ".join(f"{r:.3g}" for r in layers["encoder"])
        + "; decoder (causal) "
        + ", ".join(f"{r:.3g}" for r in layers["decoder"])
        + " (tolerance 2e-2)")
    if not worst <= 2e-2:
        failures.append(f"whisper attention flash vs ref {worst}")
    with torch.inference_mode():
        enc_ms = _median_ms(lambda: T.encode(cfg, params, frames))
        prefill_ms = _median_ms(lambda: prefill(params, batch))
    fp32 = {d: _encdec_fp32_replay(cfg, params, frames, prompt, d)
            for d in ENCDEC_FP32_DEPTHS}
    held_depth = ENCDEC_FP32_DEPTHS[0]
    log(f"[encdec] fp32, the weights widened, encoder and decoder cut to "
        f"their first d layers at full width: serve-step replay vs "
        f"decode_train at the last prompt position, max abs diff / "
        f"max|logit|: " + ", ".join(f"d={d} {r:.4g}" for d, r in fp32.items())
        + f" (tolerance 2e-2 at d={held_depth}; deeper reported: with these "
        f"random weights rounding grows with depth)")
    if not fp32[held_depth] <= 2e-2:
        failures.append(f"whisper fp32 replay vs decode_train "
                        f"{fp32[held_depth]} at {held_depth} layers")
    decode_ms = decode_s * 1e3 / ENCDEC_NEW
    log(f"[encdec] on {_card()}: encoder {enc_ms:.3f} ms ({B} x "
        f"{ENCDEC_FRAMES} frames), prefill {prefill_ms:.3f} ms (encoder + "
        f"decoder over {ENCDEC_PROMPT} tokens, median of 3), replay "
        f"{replay_s * 1e3 / ENCDEC_PROMPT:.3f} ms per step, decode "
        f"{decode_ms:.3f} ms per step ({ENCDEC_NEW} steps); peak device "
        f"memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB still held "
        f"from earlier phases)")
    return {"arch": cfg.name, "params": n_params,
            "launches_encoder": enc_counts, "launches": counts,
            "bf16_prefill_vs_replay": bf16_rel, "layer_by_layer": layers,
            "fp32_replay_vs_decode_train": fp32, "encoder_ms": enc_ms,
            "prefill_ms": prefill_ms,
            "replay_ms_per_step": replay_s * 1e3 / ENCDEC_PROMPT,
            "decode_ms_per_step": decode_ms, "peak_memory_bytes": peak,
            "held_before_bytes": held,
            "generated": generated.tolist()}


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _card() -> str:
    from repro_torch.device import describe

    return describe(torch.device("cuda", 0))


def _encdec_train(failures: list) -> dict:
    """whisper-base trained 6 steps at full width through the launcher's
    code path (the reference loop's zero frames, remat full): 2 x 12 x 6
    flash launches, the loss falls, every encoder, decoder and
    cross-attention leaf gets a finite gradient."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.models.model import make_loss_fn
    from repro_torch.models.transformer import flatten
    from repro_torch.train import adamw, train
    from repro_torch.train.loop import train_batch

    dev = torch.device("cuda", 0)
    cfg = get_config(ENCDEC_ARCH).with_(attn_impl="flash")
    opt = adamw(TRAIN_LR, warmup=TRAIN_WARMUP, total=TRAIN_TOTAL,
                grad_clip=ENCDEC_TRAIN_CLIP)
    log(f"[encdec] optimizer: adamw(peak_lr={TRAIN_LR}, warmup="
        f"{TRAIN_WARMUP}, total={TRAIN_TOTAL}), clip {opt.grad_clip}")
    pipeline = launch.make_pipeline(cfg, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ,
                                    TRAIN_HOSTS, SERVE_POLICY, 64,
                                    TRAIN_SHARDS, TRAIN_SEED, dev)
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        result = train(cfg, pipeline, TRAIN_STEPS, optimizer=opt,
                       seed=TRAIN_SEED, log_every=1, log=log, device=dev)
        torch.cuda.synchronize()
        counts = _read_launches()
        peak = torch.cuda.max_memory_allocated()
        for line in launch.report(result, cfg, ENCDEC_TRAIN_BATCH,
                                  ENCDEC_TRAIN_SEQ, dev, peak):
            log(line)
        n_flash = 2 * (cfg.enc_layers + cfg.n_layers) * TRAIN_STEPS
        expected = dict.fromkeys(counts, 0)
        expected.update({"flash_attention": n_flash,
                         "flash_attention/wgmma": n_flash})
        log(f"[encdec] train launches {_nonzero(counts)} (flash: 2 x "
            f"(encoder + "
            f"decoder layers) x steps = 2 x {cfg.enc_layers + cfg.n_layers}"
            f" x {TRAIN_STEPS} = {n_flash}, the forward and the remat "
            f"recompute)")
        if counts != expected:
            failures.append(f"whisper train launches {counts}, expected "
                            f"{expected}")
        fell = _loss_fell(cfg, result.state.params, pipeline, TRAIN_STEPS,
                          TRAIN_SEED, dev)
        log(f"[encdec] losses {', '.join(f'{x:.4f}' for x in result.losses)}"
            f"; mean loss over the run's {TRAIN_STEPS} batches at the "
            f"initial weights {fell['before']:.4f}, at the trained ones "
            f"{fell['after']:.4f} (must fall)")
        if not (all(np.isfinite(result.losses)) and fell["fell"]):
            failures.append(f"whisper loss did not fall ({fell})")
        params = result.state.params
        pairs = [(k, t) for k, t in flatten(params)
                 if k.split("/")[0] in ("encoder", "blocks", "cross")]
        leaves = [t.requires_grad_() for _, t in pairs]
        loss = make_loss_fn(cfg)(params, train_batch(
            cfg, pipeline.fetch_step(0)))
        grads = torch.autograd.grad(loss, leaves)
        bad = [k for (k, _), g in zip(pairs, grads)
               if not bool(torch.isfinite(g).all())]
        zero = [k for (k, _), g in zip(pairs, grads)
                if not float(g.abs().max()) > 0]
        norms = {root: float(sum(g.float().square().sum() for (k, _), g
                                 in zip(pairs, grads)
                                 if k.startswith(root + "/")) ** 0.5)
                 for root in ("encoder", "blocks", "cross")}
        log(f"[encdec] gradient at the trained state of every encoder, "
            f"decoder and cross-attention leaf: {len(pairs)} leaves, "
            f"{len(pairs) - len(bad)} finite, {len(zero)} all zero {zero}; "
            f"norms " + ", ".join(f"{k} {v:.4g}" for k, v in norms.items()))
        if bad:
            failures.append(f"whisper gradients not finite: {bad}")
        step_ms = statistics.median(result.step_seconds[1:]) * 1e3
        del params, leaves, grads, result
    finally:
        pipeline.close()
    tokens = ENCDEC_TRAIN_BATCH * (ENCDEC_TRAIN_SEQ + 1)
    log(f"[encdec] on {_card()}: training {step_ms:.1f} ms per step (median "
        f"of steps 2-{TRAIN_STEPS}), {tokens / (step_ms * 1e-3):.0f} "
        f"tokens/s, peak device memory {peak / 2**30:.3f} GiB")
    return {"launches": counts["flash_attention"],
            "launches_all": counts, "loss_on_batches": fell,
            "step_ms": step_ms, "peak_memory_bytes": peak,
            "leaves": len(pairs), "zero_grad_leaves": zero,
            "grad_norms": norms}


def _vision_forward(failures: list) -> dict:
    """llava-next-mistral-7b at full width and depth in bf16:
    ``make_forward`` and ``make_prefill`` at B=2, S=1024 with 576 patch
    embeddings spliced at offset 1 (32 flash launches each); each layer's
    attention against ref; the splice check with a second image."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_forward, make_prefill
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import flatten

    dev = torch.device("cuda", 0)
    cfg = get_config(VISION_ARCH).with_(attn_impl="flash")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SERVE_SEED),
                         dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    leaves = [t for _, t in flatten(params)]
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    del leaves
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (VISION_BATCH, VISION_SEQ))).to(dev)
    shape = (VISION_BATCH, cfg.num_frontend_tokens, cfg.d_model)
    image, other = _stub_embeds(params, shape, 5), _stub_embeds(params,
                                                                 shape, 6)
    batch = {"tokens": tokens, "image_embeds": image}
    log(f"[vision] {cfg.name} at its published widths and depth: "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"over {cfg.n_kv_heads} kv heads of {cfg.head_dim_}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; {n_params:,} parameters "
        f"({param_bytes / 1e9:.3f} GB in {cfg.dtype}) drawn on the card in "
        f"{init_s:.2f}s; tokens {tuple(tokens.shape)}, "
        f"{cfg.num_frontend_tokens} patch embeddings at offset "
        f"{cfg.frontend_offset}; no cut")
    fwd, prefill = make_forward(cfg), make_prefill(cfg)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with torch.inference_mode():
        logits, _ = fwd(params, batch)
    torch.cuda.synchronize()
    fwd_counts = _read_launches()
    _reset_launches()
    with torch.inference_mode():
        last = prefill(params, batch)
    torch.cuda.synchronize()
    counts = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    n = cfg.n_layers
    log(f"[vision] flash launches: make_forward {_nonzero(fwd_counts)}, "
        f"make_prefill {_nonzero(counts)} (expected {n} each, all on tensor "
        f"cores)")
    for label, c in (("forward", fwd_counts), ("prefill", counts)):
        if (c["flash_attention"], c["flash_attention/wgmma"]) != (n, n):
            failures.append(f"llava {label}: flash launches {c}, expected "
                            f"{n} on wgmma")
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(last).all())):
        failures.append("llava: non-finite logits")
    last_rel = float((last[:, -1] - logits[:, -1]).abs().max()
                     / logits[:, -1].abs().max())
    with torch.inference_mode():
        logits2, _ = fwd(params, dict(batch, image_embeds=other))
    first_equal = bool(torch.equal(logits[:, 0], logits2[:, 0]))
    differ = (logits[:, 1:] - logits2[:, 1:]).abs().amax(-1) > 0
    del logits2
    log(f"[vision] splice: with another image, position 0's logits "
        f"bit-identical {first_equal}; positions >= 1 that differ "
        f"{int(differ.sum())} of {differ.numel()}; prefill vs forward at the "
        f"last position, max abs diff / max|logit| {last_rel:.3g}")
    if not (first_equal and bool(differ.all())):
        failures.append("llava splice check failed")
    spec = cfg.pattern[0]
    with torch.inference_mode():
        x = T.embed_inputs(cfg, params, batch)
        pos = torch.arange(x.shape[1], device=dev)
        layers = [T._layer(params["blocks"]["sub0"], i) for i in range(n)]
        rows = _flash_vs_ref(cfg, layers, x, pos, True, lambda x, i:
                             T._apply_sub(cfg, spec, x, layers[i], pos)[0])
        del x
    worst = max(rows)
    log(f"[vision] layer by layer on the flash forward's hidden states, "
        f"attention block flash vs ref, max abs diff / max|output| over the "
        f"{n} layers {worst:.4g} (tolerance 2e-2)")
    if not worst <= 2e-2:
        failures.append(f"llava attention flash vs ref {worst}")
    del logits, last
    with torch.inference_mode():
        prefill_ms = _median_ms(lambda: prefill(params, batch))
    log(f"[vision] on {_card()}: prefill {prefill_ms:.3f} ms ({VISION_BATCH}"
        f" x {VISION_SEQ} tokens, median of 3); peak device memory "
        f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB still held from "
        f"earlier phases)")
    del params
    return {"arch": cfg.name, "params": n_params, "param_bytes": param_bytes,
            "init_s": init_s, "launches_forward": fwd_counts,
            "launches": counts, "splice_first_equal": first_equal,
            "splice_positions_differ": int(differ.sum()),
            "prefill_vs_forward_last": last_rel, "layer_by_layer": rows,
            "prefill_ms": prefill_ms, "peak_memory_bytes": peak,
            "held_before_bytes": held}


def phase_encdec() -> dict:
    """Phase 10: whisper-base served and trained, llava-next-mistral-7b's
    forward; any failure raises at the end."""
    failures: list = []
    t0 = time.monotonic()
    serve = _encdec_serve(failures)
    gc.collect()
    torch.cuda.empty_cache()
    trained = _encdec_train(failures)
    gc.collect()
    torch.cuda.empty_cache()
    vision = _vision_forward(failures)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[encdec] phase 10 took {time.monotonic() - t0:.1f}s")
    if failures:
        raise AssertionError("encdec: " + "; ".join(failures))
    return {"whisper": serve, "whisper_train": trained, "llava": vision,
            "seconds": time.monotonic() - t0}


# --------------------------------------------------------------------------
# phase 11: the stacking workload on an elastic executor pool
# --------------------------------------------------------------------------

class _PoolMonitor(threading.Thread):
    """Samples (pool size, allocated device memory) every ``period_s``
    while a run goes on, for the memory the card holds at the peak pool."""

    def __init__(self, rt, period_s: float = 0.25) -> None:
        super().__init__(daemon=True, name="pool-monitor")
        self.rt, self.period_s = rt, period_s
        self.samples: list[tuple[float, int, int]] = []
        self.stop_evt = threading.Event()

    def run(self) -> None:
        t0 = time.monotonic()
        while not self.stop_evt.wait(self.period_s):
            self.samples.append((time.monotonic() - t0, len(self.rt.workers),
                                 torch.cuda.memory_allocated()))


class _InBackground(threading.Thread):
    """Runs ``fn()`` on its own thread; :meth:`result` joins it and returns
    what ``fn`` returned, or raises what it raised."""

    def __init__(self, fn) -> None:
        super().__init__(daemon=True, name="main-path")
        self.fn = fn
        self.value = None
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            self.value = self.fn()
        except BaseException as e:  # noqa: BLE001 - handed to result()
            self.error = e

    def result(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.value


def _profile_window(length_s: float, clock) -> dict:
    """The card profiled for ``length_s`` of wall time while other threads
    run the main path: its busy time, read as phase 7's ``_profile_train``
    reads it (the sum of the CUDA events' self device time in
    ``key_averages()``), and the same sum over the profiler's raw kernel
    and copy events; and the window's ends on ``clock``.  Only the card's
    activity is traced: recording every host op of 64 executor threads
    slowed the run severalfold in the window.  Called on the main thread
    (the profiler's home)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        begin = clock()
        time.sleep(length_s)
        torch.cuda.synchronize()
        end = clock()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    raw_ms, n_raw = 0.0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            raw_ms += e.duration_ns() / 1e6
            n_raw += 1
    events = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall_ms, "begin": begin, "end": end,
            "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "raw_busy_ms": raw_ms,
            "raw_busy_share": raw_ms / wall_ms, "raw_events": n_raw,
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                    for e in top]}


def _queue_waits(events, workload, period_s: float) -> dict:
    """Queue wait (``task_dispatched`` less ``task_arrived``, from the
    events, to each task's first dispatch) split in two: while the pool is
    growing and the rest.  The sine (phase 0) rises from each trough, at
    three quarters of a period, to its next peak; a wave runs from one
    trough to the next (the first from the start).  In each wave the pool
    falls to its smallest size (the provisioner releases what the last
    wave left idle) and grows from there to the largest size it reaches
    after it; the growing window runs from the wave's first arrival until
    the pool first reaches that size.  Of the rest, the requests that
    arrived while the backlog left at that moment drained (until a pump
    first saw an empty queue) are also summarised apart.  Waves are placed
    on the recorder's clock by the first arrival (the workload's own
    arrival time of the first task marks the run's start), which ``run0``
    returns."""
    from repro_torch.workloads.metrics import latency_quantiles

    arrived, dispatched, pool, pumps = {}, {}, [], []
    for e in events:
        k = e["kind"]
        if k == "task_arrived":
            arrived.setdefault(e["tid"], e["t"])
        elif k == "task_dispatched":
            dispatched.setdefault(e["tid"], e["t"])
        elif k == "pool":
            pool.append((e["t"], e["size"]))
        elif k == "pump":
            pumps.append((e["t"], e["queue"]))
    pumps.sort()
    wl_t = {ev.tid: ev.t for ev in workload.events}
    first = min(arrived, key=arrived.get)
    run0 = arrived[first] - wl_t[first]
    last = max(wl_t.values())
    bounds = [0.0]
    while bounds[-1] <= last:
        bounds.append((len(bounds) - 0.25) * period_s)
    growing = []
    for lo, hi in zip(bounds, bounds[1:]):
        starts = [arrived[tid] for tid, t in wl_t.items() if lo <= t < hi]
        if not starts:
            continue
        begin, end = min(starts), max(starts)
        # the size the pool had at the wave's first arrival, then each
        # change while its requests arrive
        sizes = [(begin, next((n for t, n in reversed(pool) if t <= begin),
                              pool[0][1]))]
        sizes += [(t, n) for t, n in pool if begin < t <= end]
        low = min(n for _, n in sizes)
        after = sizes[next(i for i, (_, n) in enumerate(sizes)
                           if n == low):]
        peak = max(n for _, n in after)
        if peak > low:          # a wave the pool did not grow in has none
            reached = next(t for t, n in after if n == peak)
            backlog = next((q for t, q in reversed(pumps) if t <= reached),
                           0)
            drained = next((t for t, q in pumps if t > reached and q == 0),
                           reached)
            growing.append((begin, reached, low, peak, backlog, drained))
    waits = {"growing": [], "rest": [], "draining": []}
    for tid, t in arrived.items():
        wait = dispatched[tid] - t
        if any(w[0] <= t < w[1] for w in growing):
            waits["growing"].append(wait)
            continue
        waits["rest"].append(wait)
        if any(w[1] <= t < w[5] for w in growing):
            waits["draining"].append(wait)
    return {"run0": run0,
            "windows": [(a - run0, b - run0, lo, n, q, d - run0)
                        for a, b, lo, n, q, d in growing],
            "draining": latency_quantiles(waits["draining"]),
            "growing": latency_quantiles(waits["growing"]),
            "rest": latency_quantiles(waits["rest"]),
            "all": latency_quantiles(waits["growing"] + waits["rest"])}


def phase_elastic(card: str) -> dict:
    import dataclasses

    from repro_torch.apps import astro
    from repro_torch.configs.astro_stacking import WORKLOADS, workload
    from repro_torch.experiments import ObserveSpec, RuntimeEngine
    from repro_torch.kernels.stacking.stacking import launches
    from repro_torch.obs import chrome_trace, quantile

    n_tasks, n_files = WORKLOADS[ELASTIC_LOCALITY]
    prov = astro.ELASTIC_PROVISIONER
    spec = dataclasses.replace(
        astro.elastic_spec(n_tasks, n_files, ELASTIC_ARRIVALS, prov),
        observe=ObserveSpec(events=True, ring_capacity=ELASTIC_RING,
                            metrics=True,
                            metrics_interval_s=ELASTIC_METRICS_S))
    log(f"[elastic] {n_tasks} tasks over {n_files} files (Table 2, locality "
        f"{ELASTIC_LOCALITY}; no cut), sine arrivals mean "
        f"{ELASTIC_ARRIVALS['mean_rate']:.0f}/s amplitude "
        f"{ELASTIC_ARRIVALS['amplitude']:.0f}/s period "
        f"{ELASTIC_PERIOD_S:.0f}s at time scale 1; pool from 1 executor, "
        f"{prov.policy} provisioner {prov.min_executors}-"
        f"{prov.max_executors}, idle timeout {prov.idle_timeout_s}s, "
        f"cooldown {prov.trigger_cooldown_s}s, tick {prov.period_s}s; "
        f"lifecycle events on (ring {ELASTIC_RING}), telemetry every "
        f"{ELASTIC_METRICS_S}s")
    t0 = time.monotonic()
    torch.cuda.empty_cache()
    eng = RuntimeEngine(device="cuda").prepare(spec)
    try:
        rt = eng.runtime
        for ob in eng.workload.objects:
            rt.put_object(ob, astro.make_tiles(ob))
        log(f"[elastic] set-up (catalog made on the host, "
            f"{n_files * astro.FILE_BYTES / 1e9:.3f} GB): "
            f"{time.monotonic() - t0:.2f}s")
        torch.cuda.synchronize()
        mem_start = torch.cuda.memory_allocated()
        monitor = _PoolMonitor(rt)
        monitor.start()
        launches.reset()
        # the run goes on a thread of its own, so that the profiler starts
        # and stops on this one, around the first peak (a quarter period)
        start_s = ELASTIC_PERIOD_S / 4 - ELASTIC_PROFILE_S / 2
        # a process's first profile initialises the card's tracing, which
        # stalls every thread for seconds: do it before the run
        _profile_window(0.1, time.monotonic)
        runner = _InBackground(lambda: eng.run(
            task_fn=astro.decode_and_stack, time_scale=1.0, timeout=600.0))
        try:
            runner.start()
            time.sleep(start_s)
            profiled = dict(_profile_window(ELASTIC_PROFILE_S,
                                            eng.recorder.clock),
                            start_s=start_s)
            rep = runner.result()
            torch.cuda.synchronize()
            n_launch = launches.value
        finally:
            monitor.stop_evt.set()
            monitor.join(5.0)
        rec = eng.recorder
        events = rec.events()      # before the release below adds pool events
        done = rt.dispatcher.completed
        retries = sum(t.attempts for t in rt.dispatcher.tasks.values())
        shape = astro.pool_shape(list(rep.pool_log), ELASTIC_PERIOD_S)
        at_peak = max((m for _, n, m in monitor.samples
                       if n == shape["peak"]), default=0)
        ideal = workload(ELASTIC_LOCALITY).ideal_cache_hit_ratio
        b = rep.bytes_by_kind
        log(f"[elastic] completed {rep.n_completed}/{rep.n_tasks} failed "
            f"{rep.n_failed} | wall {rep.wall_s:.2f}s | "
            f"{rep.tasks_per_second:.1f} tasks/s over the busy span "
            f"({rep.busy_span_s:.2f}s; earlier runs without recording: "
            f"{ELASTIC_UNRECORDED_RATE[0]}-{ELASTIC_UNRECORDED_RATE[1]}) | "
            f"{card}")
        log(f"[elastic] pool: low {shape['low']}, peak {shape['peak']}, "
            f"{shape['rises']} rises and {shape['falls']} falls, grew in "
            f"periods {shape['grew']}, shrank between the peaks "
            f"{shape['shrank']}; allocated {rep.n_allocated}, released "
            f"{rep.n_released}; executor-seconds {rep.executor_seconds:.2f}, "
            f"performance index {rep.performance_index:.4f}")
        # the log has one entry per executor added or removed: print the
        # size it had at the end of each tenth of a second that changed it
        tenths = {round(t, 1): n for t, n in rep.pool_log}
        log("[elastic] pool log (s:executors): "
            + " ".join(f"{t:.1f}:{n}" for t, n in tenths.items()))
        log(f"[elastic] cache hit ratio {rep.cache_hit_ratio:.4f} (ideal "
            f"1-1/L = {ideal:.4f}; local {rep.local_hits}, peer "
            f"{rep.peer_hits}, store {rep.store_reads})")
        log(f"[elastic] bytes: store {b['store_read'] / 1e9:.4f} GB, local "
            f"{b['local'] / 1e9:.4f} GB, cache-to-cache {b['c2c'] / 1e9:.4f} "
            f"GB")
        log(f"[elastic] stack_rois launches {n_launch} (completed "
            f"{rep.n_completed}, attempts run on a released executor "
            f"{rt.dropped_attempts}, re-queued attempts the dispatcher "
            f"counted {retries}); failed provisioning actions "
            f"{len(eng.provision_failures)}")
        failures = []
        if rep.n_completed != n_tasks or rep.n_failed:
            failures.append("not every task completed")
        if not (all(shape["grew"]) and shape["shrank"] and shape["peak"] > 1
                and rep.n_allocated > 0 and rep.n_released > 0):
            failures.append(f"the pool did not grow in each peak and shrink "
                            f"between them ({shape})")
        if n_launch != rep.n_completed + rt.dropped_attempts:
            failures.append(f"{n_launch} launches for {rep.n_completed} "
                            f"tasks and {rt.dropped_attempts} re-run attempts")
        if rt.dropped_attempts > retries:
            failures.append("more attempts ran on released executors than "
                            "the dispatcher re-queued")
        if eng.provision_failures:
            failures.append(f"provisioning failed: {eng.provision_failures}")
        # the recording: nothing dropped, one task_done per completed task,
        # one exec span per kernel launch, pool events as the pool log
        kinds: dict = {}
        done_tids: dict = {}
        for e in events:
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
            if e["kind"] == "task_done":
                done_tids[e["tid"]] = done_tids.get(e["tid"], 0) + 1
        pool_sizes = [e["size"] for e in events if e["kind"] == "pool"]
        log(f"[elastic] recorded {len(events)} events ({rec.emitted} "
            f"emitted, {rec.dropped} dropped): "
            + ", ".join(f"{k} {n}" for k, n in sorted(kinds.items())))
        if rec.dropped:
            failures.append(f"the recorder dropped {rec.dropped} events")
        if (len(done_tids) != rep.n_completed
                or any(n != 1 for n in done_tids.values())
                or set(done_tids) != {t.tid for t in done}):
            failures.append("not one task_done event per completed task")
        if not (kinds.get("exec_start") == kinds.get("exec_end")
                == n_launch):
            failures.append(f"{kinds.get('exec_start')} exec_start and "
                            f"{kinds.get('exec_end')} exec_end events for "
                            f"{n_launch} kernel launches")
        if pool_sizes != [n for _, n in rep.pool_log]:
            failures.append("the pool events' sizes differ from the pool log")
        waits = _queue_waits(events, eng.workload, ELASTIC_PERIOD_S)
        for part in ("growing", "rest", "draining", "all"):
            q = waits[part]
            log(f"[elastic] queue wait ({part}): n {q['n']}, p50 "
                f"{q['p50'] * 1e3:.3f} ms, p90 {q['p90'] * 1e3:.3f} ms, p99 "
                f"{q['p99'] * 1e3:.3f} ms, mean {q['mean'] * 1e3:.3f} ms, "
                f"max {q['max'] * 1e3:.3f} ms")
        log("[elastic] growing windows (s from the run's start: a wave's "
            "first arrival -> the pool at its peak after its low; the "
            "backlog then, drained at): "
            + ", ".join(f"{a:.2f}->{b:.2f} ({lo}->{n} executors; {q} "
                        f"queued, drained at {d:.2f})"
                        for a, b, lo, n, q, d in waits["windows"]))
        tel = rep.telemetry
        merged = tel["merged"]
        pump = merged["histograms"].get("sched.pump_latency_s")
        log(f"[elastic] telemetry: {tel['n_samples']} samples; last merged "
            f"snapshot: counters {json.dumps(merged['counters'])}, gauges "
            f"{json.dumps(merged['gauges'])}, pump latency "
            f"n {pump['count']} p50 <= {quantile(pump, 0.5)} s p99 <= "
            f"{quantile(pump, 0.99)} s; health events: "
            + (", ".join(f"{h['rule']} at {h['t']:.1f}s ({h['detail']})"
                         for h in tel["health_events"]) or "none"))
        if tel["n_samples"] < rep.wall_s / ELASTIC_METRICS_S - 2:
            failures.append(f"{tel['n_samples']} telemetry samples in "
                            f"{rep.wall_s:.1f}s")
        # the profiled window against one as long, unprofiled, around the
        # second peak: requests done in each, and the card time a request
        # takes (profiled) at the unprofiled rate
        second = waits["run0"] + 1.25 * ELASTIC_PERIOD_S
        spans = {"profiled": (profiled["begin"], profiled["end"]),
                 "second peak": (second - ELASTIC_PROFILE_S / 2,
                                 second + ELASTIC_PROFILE_S / 2)}
        done_in = {name: sum(1 for e in events if e["kind"] == "task_done"
                             and a <= e["t"] < b)
                   for name, (a, b) in spans.items()}
        per_request_ms = profiled["busy_ms"] / max(done_in["profiled"], 1)
        rates = {name: n / (spans[name][1] - spans[name][0])
                 for name, n in done_in.items()}
        profiled.update(done_in_window=done_in, done_per_s=rates,
                        device_ms_per_request=per_request_ms,
                        busy_share_at_second_peak_rate=(
                            per_request_ms * rates["second peak"] / 1e3),
                        busy_share_at_run_rate=(
                            per_request_ms * rep.tasks_per_second / 1e3))
        log(f"[elastic] requests done: {done_in['profiled']} in the profiled"
            f" window ({rates['profiled']:.1f}/s), {done_in['second peak']} "
            f"in as long around the second peak, unprofiled "
            f"({rates['second peak']:.1f}/s); card time a request "
            f"{per_request_ms * 1e3:.2f} us, so a busy share of "
            f"{profiled['busy_share_at_second_peak_rate']:.5f} at the second"
            f" peak's rate and {profiled['busy_share_at_run_rate']:.5f} at "
            f"the run's {rep.tasks_per_second:.1f}/s")
        log(f"[elastic] card busy over {profiled['wall_ms']:.1f} ms from "
            f"{profiled['start_s']:.1f}s (the first peak): "
            f"{profiled['busy_ms']:.3f} ms, share "
            f"{profiled['busy_share']:.5f} (key_averages); raw events "
            f"{profiled['raw_events']}, {profiled['raw_busy_ms']:.3f} ms, "
            f"share {profiled['raw_busy_share']:.5f} | {card}")
        log(f"[elastic] profiled kernels: {profiled['top']}")
        trace_path = ROOT / "build" / "chip_smoke_elastic_trace.json"
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        t_trace = time.monotonic()
        trace = chrome_trace(events, trace_path,
                             samples=list(eng.telemetry.series))
        spans = sum(1 for e in trace["traceEvents"] if e["ph"] == "X")
        log(f"[elastic] chrome trace {trace_path.relative_to(ROOT)}: "
            f"{len(trace['traceEvents'])} records, {spans} spans, "
            f"{trace_path.stat().st_size / 1e6:.1f} MB, written in "
            f"{time.monotonic() - t_trace:.2f}s")
        worst = 0.0
        for t in done[:CHECKED_TASKS]:
            want = _recompute(eng, t, [int(oid[3:]) for oid in t.inputs])
            if t.result.device.type != "cuda":
                raise AssertionError(f"{t.tid}: result not on the card")
            worst = max(worst, check_close(t.tid, t.result, want)[0])
        log(f"[elastic] first {CHECKED_TASKS} completed tasks against the "
            f"plain version on the card: max abs err {worst:.3g}")
        # the driver stopped with the tasks; give the idle pool back now
        with rt._lock:
            idle = rt.provision_idle(time.monotonic(), 0.0)
        release = idle[:max(len(idle) - prov.min_executors, 0)]
        held_alone = rt.exclusive_cache_bytes(release)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        rt.provision_release(release)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        results_bytes = sum(t.result.untyped_storage().nbytes()
                            for t in done)
        log(f"[elastic] device memory allocated: {mem_start / 2**30:.3f} GiB "
            f"before the run, {at_peak / 2**30:.3f} GiB at the peak pool "
            f"({shape['peak']} executors), {before / 2**30:.3f} GiB after it "
            f"on {len(release) + len(rt.workers)} executors, "
            f"{after / 2**30:.3f} GiB after releasing {len(release)} "
            f"(fell {(before - after) / 2**20:.2f} MiB; the storages only "
            f"they cached {held_alone / 2**20:.2f} MiB; the results held by "
            f"the dispatcher {results_bytes / 2**30:.3f} GiB) | {card}")
        if len(rt.workers) != prov.min_executors:
            failures.append(f"{len(rt.workers)} executors left after the "
                            f"release, not {prov.min_executors}")
        if not (held_alone > 0 and before - after >= held_alone):
            failures.append(f"releasing {len(release)} executors freed "
                            f"{before - after} bytes of the {held_alone} "
                            f"only they held")
        if failures:
            raise AssertionError("elastic: " + "; ".join(failures))
        return {"tasks": n_tasks, "files": n_files, "card": card,
                "wall_s": rep.wall_s, "busy_span_s": rep.busy_span_s,
                "tasks_per_second": rep.tasks_per_second,
                "pool": shape, "pool_log": rep.pool_log,
                "n_allocated": rep.n_allocated, "n_released": rep.n_released,
                "executor_seconds": rep.executor_seconds,
                "performance_index": rep.performance_index,
                "cache_hit_ratio": rep.cache_hit_ratio, "ideal": ideal,
                "bytes_by_kind": b, "launches": n_launch,
                "dropped_attempts": rt.dropped_attempts,
                "requeued_attempts": retries,
                "memory_start": mem_start, "memory_at_peak_pool": at_peak,
                "memory_before_release": before,
                "memory_after_release": after,
                "released": len(release), "held_alone_bytes": held_alone,
                "results_bytes": results_bytes,
                "checked_max_abs_err": worst,
                "events": {"recorded": len(events), "emitted": rec.emitted,
                           "dropped": rec.dropped, "by_kind": kinds},
                "queue_wait": waits,
                "telemetry": {"n_samples": tel["n_samples"],
                              "merged": merged,
                              "health_events": tel["health_events"]},
                "profile": profiled,
                "chrome_trace": str(trace_path.relative_to(ROOT)),
                "seconds": time.monotonic() - t0}
    finally:
        eng.shutdown()


# --------------------------------------------------------------------------
# phase 12: llava-next-mistral-7b trained at the depth the dry run picks
# --------------------------------------------------------------------------

def _vision_train_depth(full, shape, memory: int) -> dict:
    """The dry run's choice of depth for training ``full`` at ``shape``:
    ``run_cell`` on the meta device at the depths of its own fit
    (``FIT_DEPTHS``) of the plain ``ref`` attention, and the largest depth
    whose peak is within VISION_TRAIN_BUDGET of ``memory``.  Every term of
    the cell is linear in the depth (argument bytes exactly so: each block
    adds the same parameters and state; FLOPs, output and temp bytes by
    ``run_cell``'s own fit), so the two runs give the prediction at that
    depth, the peak the card is held to."""
    from repro_torch.launch.cellrun import FIT_DEPTHS, _depth_variant, run_cell
    from repro_torch.launch.mesh import make_card_mesh

    ref = full.with_(attn_impl="ref")
    mesh = make_card_mesh()
    t0 = time.monotonic()
    (d1, d2), runs = FIT_DEPTHS, [
        run_cell(_depth_variant(ref, d), shape, mesh, "one_card",
                 verbose=False).to_dict() for d in FIT_DEPTHS]
    for r in runs:
        if not r["ok"]:
            raise AssertionError(f"vision train: dry run failed: {r['error']}")
    terms = ("per_device_flops", "argument_bytes", "output_bytes",
             "temp_bytes", "peak_bytes_per_device")

    def at(k: int) -> dict:
        return {t: runs[0][t] + (runs[1][t] - runs[0][t]) * (k - d1)
                / (d2 - d1) for t in terms}
    budget = VISION_TRAIN_BUDGET * memory
    fitting = [k for k in range(1, full.n_blocks + 1)
               if at(k)["peak_bytes_per_device"] <= budget]
    if not fitting:
        raise AssertionError(f"vision train: not one block of {full.name} "
                             f"fits {budget / 1e9:.1f} GB at {shape}")
    k = max(fitting)
    return {"k": k, "prediction": at(k), "depths": FIT_DEPTHS, "runs": runs,
            "peak_per_block_bytes": (at(2)["peak_bytes_per_device"]
                                     - at(1)["peak_bytes_per_device"]),
            "budget_bytes": budget, "seconds": time.monotonic() - t0}


def phase_vision_train(card: str) -> dict:
    """Phase 12: llava-next-mistral-7b trained at its published widths,
    its depth the dry run's choice, the flash kernel in every attention
    forward."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import train as launch
    from repro_torch.launch.cellrun import _depth_variant
    from repro_torch.models.model import make_train_step
    from repro_torch.train import adamw, train

    dev = torch.device("cuda", 0)
    full = get_config(VISION_ARCH).with_(attn_impl="flash")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    memory = torch.cuda.get_device_properties(dev).total_memory
    shape = ShapeSpec("train_4x2048", TRAIN_SEQ + 1, TRAIN_BATCH, "train")
    embed = 2 * full.vocab_size * full.d_model
    per_layer = (full.param_count() - embed) // full.n_layers
    reckon = {n: 12 * (embed + n * per_layer) for n in (16, 20, 24, 32)}
    log(f"[vision-train] {full.name} at its published widths: d_model "
        f"{full.d_model}, {full.n_heads} heads over {full.n_kv_heads} kv "
        f"heads of {full.head_dim_}, d_ff {full.d_ff}, vocab "
        f"{full.vocab_size}, {full.num_frontend_tokens} zero patch "
        f"embeddings at offset {full.frontend_offset} (the train loop's "
        f"stub); {per_layer:,} parameters a layer, {embed:,} in the "
        f"embeddings; 12 B of state a parameter (bf16 weight and gradient, "
        f"fp32 AdamW m and v): "
        + ", ".join(f"{n} layers {b / 1e9:.1f} GB" for n, b in reckon.items())
        + f"; the card {memory / 1e9:.2f} GB ({held / 2**30:.3f} GiB held "
        f"from earlier phases)")
    dry = _vision_train_depth(full, shape, memory)
    k, pred = dry["k"], dry["prediction"]
    cfg = _depth_variant(full, k)
    log(f"[vision-train] dry run (meta device, attn ref, {shape.global_batch}"
        f" x {shape.seq_len}, remat {full.remat}): peak "
        + ", ".join(f"{r['peak_bytes_per_device'] / 1e9:.2f} GB at {d} "
                    f"layers" for d, r in zip(dry["depths"], dry["runs"]))
        + f" ({dry['peak_per_block_bytes'] / 1e9:.3f} GB a layer); the most "
        f"layers within {VISION_TRAIN_BUDGET} of the card "
        f"({dry['budget_bytes'] / 1e9:.2f} GB): k = {k}; predicted at k: "
        f"argument {pred['argument_bytes'] / 1e9:.2f} GB, temp "
        f"{pred['temp_bytes'] / 1e9:.2f} GB, peak "
        f"{pred['peak_bytes_per_device'] / 1e9:.2f} GB, "
        f"{pred['per_device_flops'] / 1e12:.1f} TFLOP a step (products, "
        f"remat recompute included); meta passes {dry['seconds']:.1f}s")
    opt = adamw(TRAIN_LR, warmup=TRAIN_WARMUP, total=TRAIN_TOTAL)
    pipeline = launch.make_pipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_HOSTS,
                                    SERVE_POLICY, 64, TRAIN_SHARDS,
                                    TRAIN_SEED, dev)
    failures = []
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.monotonic()
        result = train(cfg, pipeline, TRAIN_STEPS, optimizer=opt,
                       seed=TRAIN_SEED, log_every=1, log=log, device=dev)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        counts = _read_launches()
        peak = torch.cuda.max_memory_allocated() - held
        for line in launch.report(result, cfg, TRAIN_BATCH, TRAIN_SEQ, dev,
                                  peak + held):
            log(line)
        miss = pred["peak_bytes_per_device"] / peak - 1
        log(f"[vision-train] peak device memory of the run {peak / 1e9:.2f} "
            f"GB (torch.cuda.max_memory_allocated less the "
            f"{held / 1e9:.3f} GB held before it); the dry run's "
            f"{pred['peak_bytes_per_device'] / 1e9:.2f} GB misses it by "
            f"{miss:+.3f} (band +-{VISION_PEAK_BAND})")
        if abs(miss) > VISION_PEAK_BAND:
            failures.append(f"the dry run's peak misses the card's by "
                            f"{miss:+.3f}")
        n_flash = 2 * cfg.n_layers * TRAIN_STEPS
        expected = dict.fromkeys(counts, 0)
        expected.update({"flash_attention": n_flash,
                         "flash_attention/wgmma": n_flash})
        log(f"[vision-train] launches {_nonzero(counts)} (flash_attention: "
            f"2 x layers x steps = 2 x {cfg.n_layers} x {TRAIN_STEPS} = "
            f"{n_flash}, the forward and the remat recompute, all on tensor "
            f"cores)")
        if counts != expected:
            failures.append(f"launches {counts}, expected {expected}")
        losses = result.losses
        fell = _loss_fell(cfg, result.state.params, pipeline, TRAIN_STEPS,
                          TRAIN_SEED, dev)
        log(f"[vision-train] losses {', '.join(f'{x:.4f}' for x in losses)};"
            f" mean loss over the run's {TRAIN_STEPS} batches at the initial "
            f"weights {fell['before']:.4f}, at the trained ones "
            f"{fell['after']:.4f} (must fall)")
        if not (all(np.isfinite(losses)) and fell["fell"]):
            failures.append(f"the loss did not fall ({fell['before']} -> "
                            f"{fell['after']} on the run's batches)")
        step_seconds = result.step_seconds
        step_ms = statistics.median(step_seconds[1:]) * 1e3
        flops = train_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ + 1)
        step_fn = make_train_step(cfg, opt)
        state, prof = _profile_train(cfg, step_fn, result.state, pipeline,
                                     TRAIN_STEPS, steps=1)
        del result, state
        log(f"[vision-train] 1 train step profiled ({card}): wall "
            f"{prof['wall_ms_per_step']:.1f} ms, card busy "
            f"{prof['busy_ms_per_step']:.1f} ms ({prof['busy_share']:.3f} of "
            f"the wall), {prof['kernels_per_step']:.0f} kernels; by kind: "
            + ", ".join(f"{k} {ms:.2f} ms" for k, ms in
                        prof["ms_per_step_by_kind"].items())
            + "; top: "
            + "; ".join(f"{k} {ms:.2f} ms" for k, ms in prof["top"]))
    finally:
        pipeline.close()
    gc.collect()
    torch.cuda.empty_cache()
    tokens_per_step = TRAIN_BATCH * (TRAIN_SEQ + 1)
    log(f"[vision-train] on {card}: {step_ms:.1f} ms per step (median of "
        f"steps 2-{TRAIN_STEPS}), {tokens_per_step / (step_ms * 1e-3):.0f} "
        f"tokens/s at {k} of {full.n_layers} layers; model FLOPs "
        f"{flops:.4g} a step, {flops / (step_ms * 1e-3) / BF16_OPS_PER_S:.3f}"
        f" of the card's {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16 peak; card"
        f" busy {prof['busy_share']:.3f}; peak {peak / 1e9:.2f} GB "
        f"(predicted {pred['peak_bytes_per_device'] / 1e9:.2f}); train wall "
        f"{wall_s:.1f}s for {TRAIN_STEPS} steps")
    if failures:
        raise AssertionError("vision train: " + "; ".join(failures))
    return {"arch": cfg.name, "layers": k, "layers_published": full.n_layers,
            "params": cfg.param_count(), "state_bytes_reckoned": reckon,
            "dry_run": dry, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ + 1,
            "steps": TRAIN_STEPS, "losses": losses, "loss_on_batches": fell,
            "step_ms": step_ms,
            "step_ms_all": [t * 1e3 for t in step_seconds],
            "tokens_per_s": tokens_per_step / (step_ms * 1e-3),
            "model_flops_per_step": flops, "peak_memory_bytes": peak,
            "peak_predicted_bytes": pred["peak_bytes_per_device"],
            "peak_miss": miss, "held_before_bytes": held, "wall_s": wall_s,
            "launches": counts["flash_attention"],
            "launches_wgmma": counts["flash_attention/wgmma"],
            "launches_all": counts, "profile": prof, "card": card}



# --------------------------------------------------------------------------
# phase 13: serving over diffusion, KV pages on the card
# --------------------------------------------------------------------------

class _CopyCounter:
    """While active, counts the bytes the runtime really copies onto its
    device (``core.runtime.on_device`` moving a tensor from elsewhere), and
    the calls that found the tensor already there (a cache admission, or a
    page taken from a peer's cache, which on one card is the same tensor)."""

    def __enter__(self):
        from repro_torch.core import runtime

        self.module, self.real = runtime, runtime.on_device
        self.lock = threading.Lock()
        self.copied_bytes = self.copies = self.in_place = 0

        def counting(payload, device):
            if isinstance(payload, torch.Tensor):
                with self.lock:
                    if payload.device != device:
                        self.copies += 1
                        self.copied_bytes += payload.untyped_storage().nbytes()
                    else:
                        self.in_place += 1
            return self.real(payload, device)
        runtime.on_device = counting
        return self

    def __exit__(self, *exc):
        self.module.on_device = self.real


def _kv_pages(objects) -> tuple[dict, dict]:
    """One host ``uint8`` tensor of each page's bytes, its first 16 bytes
    the page's index (little-endian), the rest a constant; and each page's
    stamp."""
    pages, stamps = {}, {}
    for i, ob in enumerate(objects):
        stamp = i.to_bytes(16, "little")
        t = torch.empty(ob.size_bytes, dtype=torch.uint8)
        t.fill_(0xA5)
        t[:16] = torch.frombuffer(bytearray(stamp), dtype=torch.uint8)
        pages[ob.oid], stamps[ob.oid] = t, stamp
    return pages, stamps


def _cached_storages(rt) -> dict[int, int]:
    """Device storages the replicas' caches hold, by address: a page two
    replicas hold (one took it from the other) is one storage."""
    out = {}
    for w in rt.workers.values():
        with w.lock:
            payloads = list(w.payloads.values())
        for t in payloads:
            st = t.untyped_storage()
            out[st.data_ptr()] = st.nbytes()
    return out


def _serve_diffusion_run(spec, pages: dict, stamps: dict,
                         barrier_every) -> dict:
    """One run of ``spec`` through the serve engine on the card, pages
    from ``pages``, every input checked by the task fn; what it moved.  The
    replicas' caches are emptied when it returns, so the next run starts
    from the same device memory."""
    from repro_torch.serve.diffusion import ServeDiffusionEngine, kv_summary

    dev = torch.device("cuda", 0)
    page = next(iter(pages.values())).numel()
    checked = []
    lock = threading.Lock()

    def check_inputs(inputs):
        """A check harness, not a feature: every page on the card, of the
        page's bytes, carrying its stamp."""
        for oid, t in inputs.items():
            if t.device != dev or t.dtype != torch.uint8 \
                    or t.numel() != page:
                raise AssertionError(f"{oid}: {t.device} {t.dtype} "
                                     f"{t.numel()} bytes")
            if bytes(t[:16].tolist()) != stamps[oid]:
                raise AssertionError(f"{oid}: wrong stamp")
        with lock:
            checked.append(len(inputs))

    eng = ServeDiffusionEngine(device="cuda").prepare(spec)
    try:
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        with _CopyCounter() as copies:
            rep = eng.run(task_fn=check_inputs,
                          payload_factory=lambda ob: pages[ob.oid],
                          barrier_every=barrier_every, timeout=600.0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        gc.collect()
        mem1 = torch.cuda.memory_allocated()
        peak = torch.cuda.max_memory_allocated()
        rt = eng.runtime
        held = _cached_storages(rt)
        entries = sum(len(w.payloads) for w in rt.workers.values())
        evictions = sum(w.cache.stats.evictions for w in rt.workers.values())
        placements = {t.tid: t.executor for t in rt.dispatcher.completed}
        by_replica = {eid: sum(1 for e in placements.values() if e == eid)
                      for eid in sorted(rt.workers)}
        return {"report": rep, "summary": kv_summary(rep),
                "placements": placements, "by_replica": by_replica,
                "checked_requests": len(checked),
                "checked_inputs": sum(checked),
                "h2d_bytes": copies.copied_bytes, "h2d_copies": copies.copies,
                "in_place": copies.in_place,
                "memory_before": mem0, "memory_after": mem1,
                "peak_memory": peak, "cached_storages": len(held),
                "cached_storage_bytes": sum(held.values()),
                "cache_entries": entries, "evictions": evictions,
                "events": eng.recorder.events() if eng.recorder else None,
                "outcomes": eng.last_outcomes, "wall_s": wall}
    finally:
        eng.shutdown()
        for w in eng.runtime.workers.values():
            w.drop_cache()


def phase_serve_diffusion(card: str) -> dict:
    from repro_torch.experiments import ObserveSpec, build_workload
    from repro_torch.obs import (diff_outcomes, format_divergence,
                                 sim_replay_outcomes)
    from repro_torch.serve.diffusion import (ServeDiffusionEngine,
                                             kv_summary, session_spec)

    t0 = time.monotonic()
    spec = session_spec("serve-diffusion", SERVE_DIFFUSION_SESSIONS,
                        n_replicas=SERVE_DIFFUSION_REPLICAS,
                        replica_cache_bytes=SERVE_DIFFUSION_CACHE, seed=0,
                        observe=ObserveSpec(events=True))
    wl = build_workload(spec.workload)
    page = wl.objects[0].size_bytes
    widths = sorted({len(e.inputs) for e in wl.events})
    sess = SERVE_DIFFUSION_SESSIONS
    log(f"[serve-diffusion] {len(wl)} requests ({sess['n_sessions']} "
        f"sessions x {sess['turns_per_session']} turns) "
        f"reading {widths} pages of {page} B "
        f"({sess['model']}: {page // sess['block']} B a token, "
        f"{sess['block']}-token pages); {len(wl.objects)} "
        f"pages, {len(wl.objects) * page / 1e9:.3f} GB in the store; "
        f"{SERVE_DIFFUSION_REPLICAS} replicas with "
        f"{SERVE_DIFFUSION_CACHE / 2**30:.2f} GiB caches on the card; "
        f"batch-synchronous replay (barrier every request)")
    t_pages = time.monotonic()
    pages, stamps = _kv_pages(wl.objects)
    log(f"[serve-diffusion] pages made on the host in "
        f"{time.monotonic() - t_pages:.2f}s")
    run = _serve_diffusion_run(spec, pages, stamps, barrier_every=1)
    rep, s = run["report"], run["summary"]
    # the same spec on the CPU, shape-only, as the reference runs it
    cpu = ServeDiffusionEngine(device="cpu").prepare(spec)
    try:
        cpu_rep = cpu.run(barrier_every=1, timeout=600.0)
        cpu_placements = {t.tid: t.executor
                          for t in cpu.runtime.dispatcher.completed}
    finally:
        cpu.shutdown()
    gb = 1e9
    log(f"[serve-diffusion] completed {rep.n_completed}/{rep.n_tasks} "
        f"failed {rep.n_failed}; requests checked on the card "
        f"{run['checked_requests']} ({run['checked_inputs']} pages); "
        f"requests by replica {run['by_replica']} | {card}")
    log(f"[serve-diffusion] reused token fraction "
        f"{s['reused_token_fraction']:.4f}; KV bytes local "
        f"{s['local_kv_bytes'] / gb:.4f} GB, from peers "
        f"{s['peer_kv_bytes'] / gb:.4f} GB, recomputed "
        f"{s['recomputed_kv_bytes'] / gb:.4f} GB; requests "
        f"{s['full_reuse_requests']} full / {s['partial_reuse_requests']} "
        f"partial / {s['cold_requests']} cold")
    log(f"[serve-diffusion] host-to-device bytes copied "
        f"{run['h2d_bytes'] / gb:.4f} GB in {run['h2d_copies']} copies "
        f"({run['in_place']} tensors already on the card); evictions "
        f"{run['evictions']}; the caches hold {run['cache_entries']} pages in "
        f"{run['cached_storages']} storages, "
        f"{run['cached_storage_bytes'] / gb:.4f} GB; device memory "
        f"{run['memory_before'] / gb:.4f} GB before, "
        f"{run['memory_after'] / gb:.4f} GB after, peak "
        f"{run['peak_memory'] / gb:.4f} GB; run wall {run['wall_s']:.2f}s "
        f"| {card}")
    failures = []
    if rep.n_completed != len(wl) or rep.n_failed:
        failures.append("not every request completed")
    if run["checked_requests"] != rep.n_completed:
        failures.append(f"{run['checked_requests']} requests checked")
    if s != kv_summary(cpu_rep):
        failures.append(f"kv_summary {s} differs from the CPU shape-only "
                        f"run's {kv_summary(cpu_rep)}")
    if run["placements"] != cpu_placements:
        failures.append("placements differ from the CPU shape-only run's")
    grown = run["memory_after"] - run["memory_before"]
    if grown != run["cached_storage_bytes"]:
        failures.append(f"device memory grew {grown} B for "
                        f"{run['cached_storage_bytes']} B of cached storages")
    if run["h2d_bytes"] != s["recomputed_kv_bytes"]:
        failures.append(f"{run['h2d_bytes']} B copied to the card for "
                        f"{s['recomputed_kv_bytes']} B of store reads")
    measured = run["outcomes"]
    div = diff_outcomes(measured, sim_replay_outcomes(spec))
    log("[serve-diffusion] against the sim twin: "
        + "; ".join(format_divergence(div).splitlines()))
    kinds: dict = {}
    for e in run["events"]:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    log("[serve-diffusion] lifecycle events: "
        + ", ".join(f"{k} {n}" for k, n in sorted(kinds.items())))
    if kinds.get("task_done") != rep.n_completed:
        failures.append("not one task_done event per request")
    # the same traffic without the barrier: the replicas work at once, so
    # requests take pages from their peers' caches; on one card such a
    # page is the tensor the peer holds, and nothing is copied for it
    spec_free = session_spec("serve-diffusion-free", SERVE_DIFFUSION_SESSIONS,
                             n_replicas=SERVE_DIFFUSION_REPLICAS,
                             replica_cache_bytes=SERVE_DIFFUSION_CACHE,
                             seed=0)
    free = _serve_diffusion_run(spec_free, pages, stamps,
                                barrier_every=None)
    fs = free["summary"]
    free_grown = free["memory_after"] - free["memory_before"]
    log(f"[serve-diffusion] without the barrier: completed "
        f"{free['report'].n_completed}, requests by replica "
        f"{free['by_replica']}; KV bytes local {fs['local_kv_bytes'] / gb:.4f}"
        f" GB, from peers {fs['peer_kv_bytes'] / gb:.4f} GB "
        f"({free['report'].peer_hits} pages), recomputed "
        f"{fs['recomputed_kv_bytes'] / gb:.4f} GB; host-to-device bytes "
        f"copied {free['h2d_bytes'] / gb:.4f} GB; the caches hold "
        f"{free['cache_entries']} pages in {free['cached_storages']} "
        f"storages ({free['cached_storage_bytes'] / gb:.4f} GB), device "
        f"memory grew {free_grown / gb:.4f} GB; peak "
        f"{free['peak_memory'] / gb:.4f} GB; run wall "
        f"{free['wall_s']:.2f}s | {card}")
    if free["report"].n_completed != len(wl) or free["report"].n_failed:
        failures.append("not every request completed without the barrier")
    free_div = diff_outcomes(free["outcomes"],
                             sim_replay_outcomes(spec_free))
    log("[serve-diffusion] without the barrier, against the sim twin: "
        + "; ".join(format_divergence(free_div).splitlines()))
    if free["checked_requests"] != len(wl):
        failures.append(f"{free['checked_requests']} requests checked "
                        f"without the barrier")
    if free["h2d_bytes"] != fs["recomputed_kv_bytes"]:
        failures.append(f"without the barrier {free['h2d_bytes']} B copied "
                        f"for {fs['recomputed_kv_bytes']} B of store reads")
    if free_grown != free["cached_storage_bytes"]:
        failures.append("without the barrier the device memory did not "
                        "grow by the cached storages' bytes")
    seconds = time.monotonic() - t0
    log(f"[serve-diffusion] phase wall {seconds:.1f}s")
    del pages
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("serve-diffusion: " + "; ".join(failures))
    keep = ("summary", "by_replica", "checked_requests", "checked_inputs",
            "h2d_bytes", "h2d_copies", "in_place", "memory_before",
            "memory_after", "peak_memory", "cached_storages",
            "cached_storage_bytes", "cache_entries", "evictions", "wall_s")
    return {"requests": len(wl), "pages": len(wl.objects), "page_bytes": page,
            "store_bytes": len(wl.objects) * page, "card": card,
            "barrier": {k: run[k] for k in keep},
            "no_barrier": {k: free[k] for k in keep},
            "events_by_kind": kinds, "divergence": div,
            "divergence_no_barrier": free_div,
            "seconds": seconds}

# --------------------------------------------------------------------------
# phase 14: stacking on a fleet of host processes that share the card
# --------------------------------------------------------------------------

def _fleet_spec(hosts: int, tph: int, observe=None):
    """Table 2's locality-30 row (``astro.flat_spec(23_695, 30, 64)`` with
    the table's 790 files), each request writing its coadd (40,000 B) as
    an output the executor caches, laid out as ``hosts`` x ``tph``."""
    import dataclasses

    from repro_torch.apps import astro
    from repro_torch.configs.astro_stacking import WORKLOADS
    from repro_torch.experiments import ObserveSpec

    n_tasks, n_files = WORKLOADS[FLEET_LOCALITY]
    spec = astro.flat_spec(n_tasks, FLEET_LOCALITY, hosts * tph)
    return dataclasses.replace(
        spec, hosts=hosts, threads_per_host=tph,
        workload=dataclasses.replace(spec.workload, n_objects=n_files,
                                     output_bytes=astro.H * astro.W * 4),
        observe=observe if observe is not None else ObserveSpec())


def _fleet_engine(spec, tiles: dict, workload=None):
    """A RuntimeEngine on the card for ``spec`` (a fleet when
    ``spec.hosts``), its store holding every file's tiles."""
    from repro_torch.experiments import RuntimeEngine

    name = FLEET_TASK_FN if spec.hosts else None
    eng = RuntimeEngine(task_fn_name=name, device="cuda").prepare(
        spec, workload)
    for ob in eng.workload.objects:
        eng.runtime.put_object(ob, tiles[ob.oid])
    return eng


def _placements(rt) -> list:
    return sorted((t.tid, t.executor, t.cache_hits, t.peer_hits,
                   t.cache_misses) for t in rt.dispatcher.completed)


def _host_launches(per_host: dict) -> dict:
    """Each host's own count of stacking-kernel launches, from the stats
    frame it answered the engine's final barrier with."""
    return {h: int(d["metrics"]["gauges"].get(
                "kernel.stack_rois.launches", 0))
            for h, d in sorted(per_host.items())}


def _compute_apps() -> list[tuple[str, str]]:
    """``nvidia-smi --query-compute-apps=pid,used_memory``: one (pid,
    memory) per process that holds a context on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [tuple(x.strip() for x in line.split(",", 1))
            for line in out.splitlines() if line.strip()]


def _fleet_memory(rt, per_host: dict) -> dict:
    """Each host process's device memory: nvidia-smi's line for its pid
    where nvidia-smi shows the processes' pids, and what its own caching
    allocator holds (from its stats frame).  Where nvidia-smi runs in
    another PID namespace than the processes it lists, it shows each as
    pid 1, and no line maps to a host."""
    apps = _compute_apps()
    by_pid = dict(apps)
    out = {"nvidia_smi": apps, "hosts": {}}
    for h in rt.manager.live_handles():
        g = per_host.get(h.host_id, {}).get("metrics", {}).get("gauges", {})
        out["hosts"][h.host_id] = {
            "pid": h.proc.pid, "nvidia_smi": by_pid.get(str(h.proc.pid)),
            "allocated": int(g.get("device.memory_allocated", 0)),
            "reserved": int(g.get("device.memory_reserved", 0))}
    return out


def _socket_bytes(rt, events) -> tuple[int, int]:
    """Bytes of the peer hits that crossed a socket (the peer executor on
    another host than the reader's) and of those served in one host, from
    the recorder's ``input`` events."""
    host_of = {eid: h.host_id for h in rt.manager.handles.values()
               for eid in h.eids}
    crossed = same = 0
    for e in events:
        if e["kind"] == "input" and e.get("source") == "peer":
            if host_of.get(e["peer"]) != host_of.get(e["eid"]):
                crossed += e["bytes"]
            else:
                same += e["bytes"]
    return crossed, same


def _fleet_parity(tiles: dict) -> dict:
    """(a): the trace replayed batch-synchronously (a barrier every 64
    requests) on the in-process runtime with 64 executors and on a 2 x 32
    fleet: the scheduling-determined fields and every task's placement and
    input split must be equal."""
    import dataclasses

    from repro_torch.apps import astro
    from repro_torch.experiments import ObserveSpec
    from repro_torch.fleet import reports_scheduling_equal
    from repro_torch.kernels.stacking.stacking import launches

    hosts, tph = FLEET_PARITY
    spec = _fleet_spec(hosts, tph, ObserveSpec(metrics=True,
                                               metrics_interval_s=1.0))
    barrier = hosts * tph
    eng = _fleet_engine(dataclasses.replace(spec, hosts=0,
                                            threads_per_host=1,
                                            observe=ObserveSpec()), tiles)
    try:
        launches.reset()
        r1 = eng.run(task_fn=astro.stack_object, barrier_every=barrier,
                     timeout=900.0)
        torch.cuda.synchronize()
        n_in = launches.value
        per1 = _placements(eng.runtime)
    finally:
        eng.shutdown()
    t0 = time.monotonic()
    eng = _fleet_engine(spec, tiles)
    try:
        up_s = time.monotonic() - t0
        r2 = eng.run(barrier_every=barrier, timeout=900.0)
        per2 = _placements(eng.runtime)
        host_launch = _host_launches(eng.runtime.manager.cluster.per_host())
        codec = eng.runtime.manager.codec
    finally:
        eng.shutdown()
    diff = reports_scheduling_equal(r1, r2)
    n_diff = sum(a != b for a, b in zip(per1, per2)) + abs(len(per1)
                                                         - len(per2))
    log(f"[fleet] (a) barrier every {barrier}: in-process 64 executors "
        f"{r1.wall_s:.2f}s, {n_in} launches; {hosts} x {tph} fleet "
        f"(codec {codec}, hosts up and catalog replicated in "
        f"{up_s:.2f}s) {r2.wall_s:.2f}s, launches per host {host_launch}")
    log(f"[fleet] (a) hit ratio {r1.cache_hit_ratio:.4f} vs "
        f"{r2.cache_hit_ratio:.4f}; bytes {r1.bytes_by_kind} vs "
        f"{r2.bytes_by_kind}; scheduling fields differing: "
        f"{sorted(diff) or 'none'}; tasks placed differently: {n_diff} "
        f"of {len(per1)}")
    if diff or n_diff:
        raise AssertionError(f"fleet parity: fields {diff}, {n_diff} tasks "
                             f"placed differently")
    if r2.n_completed != len(per1) or r2.n_failed:
        raise AssertionError("fleet parity: not every task completed")
    if n_in != r1.n_completed or sum(host_launch.values()) != r2.n_completed:
        raise AssertionError(f"fleet parity: launches {n_in} in process, "
                             f"{host_launch} in the hosts, for "
                             f"{r2.n_completed} tasks")
    return {"barrier_every": barrier, "codec": codec,
            "inprocess_wall_s": r1.wall_s, "fleet_wall_s": r2.wall_s,
            "fleet_up_s": up_s, "cache_hit_ratio": r2.cache_hit_ratio,
            "bytes_by_kind": r2.bytes_by_kind, "diff_fields": sorted(diff),
            "placements_differing": n_diff,
            "launches_inprocess": n_in, "launches_hosts": host_launch}


def _fleet_free(tiles: dict, ideal: float) -> dict:
    """(b): the trace free-running on a 4 x 16 fleet, recorded."""
    from repro_torch.experiments import ObserveSpec
    from repro_torch.fleet.host import PeerClient

    hosts, tph = FLEET_FREE
    spec = _fleet_spec(hosts, tph, ObserveSpec(
        events=True, ring_capacity=FLEET_RING, metrics=True,
        metrics_interval_s=1.0))
    t0 = time.monotonic()
    eng = _fleet_engine(spec, tiles)
    client = None
    try:
        rt = eng.runtime
        up_s = time.monotonic() - t0
        rep = eng.run(time_scale=0.0, timeout=900.0)
        per_host = rt.manager.cluster.per_host()
        host_launch = _host_launches(per_host)
        memory = _fleet_memory(rt, per_host)
        events = eng.recorder.events()
        spans = {k: sum(e["kind"] == k for e in events)
                 for k in ("exec_start", "exec_end", "task_done")}
        crossed, same = _socket_bytes(rt, events)
        b = rep.bytes_by_kind
        log(f"[fleet] (b) {hosts} x {tph} free-running: completed "
            f"{rep.n_completed}/{rep.n_tasks} failed {rep.n_failed} | "
            f"{rep.tasks_per_second:.1f} tasks/s over the busy span "
            f"({rep.busy_span_s:.2f}s; hosts up and catalog replicated in "
            f"{up_s:.2f}s)")
        log(f"[fleet] (b) cache hit ratio {rep.cache_hit_ratio:.4f} (ideal "
            f"{ideal:.4f}; local {rep.local_hits}, peer {rep.peer_hits}, "
            f"store {rep.store_reads}); bytes local {b['local'] / 1e9:.4f} "
            f"GB, cache-to-cache {b['c2c'] / 1e9:.4f} GB ({crossed / 1e9:.4f}"
            f" GB across a socket, {same / 1e9:.4f} GB within a host), "
            f"store {b['store_read'] / 1e9:.4f} GB")
        log(f"[fleet] (b) recorder: {spans['exec_start']} exec_start, "
            f"{spans['exec_end']} exec_end, {spans['task_done']} task_done "
            f"for {rep.n_completed} completed attempts, "
            f"{eng.recorder.dropped} dropped; launches per host "
            f"{host_launch}")
        for h, m in memory["hosts"].items():
            log(f"[fleet] (b) {h} pid {m['pid']}: allocator "
                f"{m['allocated'] / 2**30:.3f} GiB allocated, "
                f"{m['reserved'] / 2**30:.3f} GiB reserved; nvidia-smi "
                f"{m['nvidia_smi'] or 'shows no line for this pid'}")
        log(f"[fleet] (b) nvidia-smi compute apps (pid, used memory): "
            f"{memory['nvidia_smi']}")
        if rep.n_completed != rep.n_tasks or rep.n_failed:
            raise AssertionError("fleet free run: not every task completed")
        if rep.cache_hit_ratio < 0.9 * ideal:
            raise AssertionError(f"fleet free run: hit ratio "
                                 f"{rep.cache_hit_ratio} below 90% of {ideal}")
        if not (spans["exec_start"] == spans["exec_end"]
                == spans["task_done"] == rep.n_completed) \
                or eng.recorder.dropped:
            raise AssertionError(f"fleet free run: spans {spans} for "
                                 f"{rep.n_completed} attempts")
        if sum(host_launch.values()) != rep.n_completed \
                or len(host_launch) != hosts:
            raise AssertionError(f"fleet free run: launches {host_launch} "
                                 f"for {rep.n_completed} tasks")
        client = PeerClient(rt.manager.codec)
        worst = 0.0
        for t in rt.dispatcher.completed[:CHECKED_TASKS]:
            host = rt.workers[t.executor].host
            got = client.fetch((host.peer_host, host.peer_port), t.executor,
                               f"{t.tid}.out")
            if got is None:
                raise AssertionError(f"{t.tid}: its coadd is not in "
                                     f"{t.executor}'s cache")
            want = _recompute(eng, t, [int(oid[3:]) for oid in t.inputs])
            worst = max(worst, check_close(t.tid, got.to(want.device),
                                           want)[0])
        log(f"[fleet] (b) first {CHECKED_TASKS} completed tasks' coadds, "
            f"fetched through the hosts' peer servers, against the plain "
            f"version on the card: max abs err {worst:.3g}")
        return {"hosts": hosts, "threads_per_host": tph, "up_s": up_s,
                "wall_s": rep.wall_s, "busy_span_s": rep.busy_span_s,
                "tasks_per_second": rep.tasks_per_second,
                "cache_hit_ratio": rep.cache_hit_ratio, "ideal": ideal,
                "local_hits": rep.local_hits, "peer_hits": rep.peer_hits,
                "store_reads": rep.store_reads, "bytes_by_kind": b,
                "bytes_c2c_socket": crossed, "bytes_c2c_same_host": same,
                "spans": spans, "launches_hosts": host_launch,
                "memory": memory, "checked_max_abs_err": worst}
    finally:
        if client is not None:
            client.close()
        eng.shutdown()


def _fleet_failure(tiles: dict) -> dict:
    """(c): the trace's first requests on a 2 x 8 fleet; ``h1`` is
    SIGKILLed once work is spread.  The run must drain with every task
    accounted, the victim's executors leave the pool, and its process
    holds no device memory afterwards."""
    from repro_torch.experiments import build_workload
    from repro_torch.workloads import Workload

    hosts, tph = FLEET_FAILURE
    spec = _fleet_spec(hosts, tph)
    full = build_workload(spec.workload)
    wl = Workload(full.name, full.objects,
                  full.events[:FLEET_FAILURE_TASKS], full.spec)
    eng = _fleet_engine(spec, tiles, wl)
    try:
        rt = eng.runtime
        victim = rt.manager.handles["h1"]
        victim_eids = set(victim.eids)
        run = _InBackground(lambda: eng.run(time_scale=0.0, timeout=600.0))
        run.start()
        deadline = time.monotonic() + 300.0
        while (len(rt.dispatcher.completed) < FLEET_KILL_AFTER
               and run.is_alive() and time.monotonic() < deadline):
            time.sleep(0.005)
        done_at_kill = len(rt.dispatcher.completed)
        with rt._lock:
            running = {eid: len(st.running)
                       for eid, st in rt.dispatcher.executors.items()}
        in_flight = sum(running.get(e, 0) for e in victim_eids)
        apps_before = _compute_apps()
        pid = rt.manager.kill_host("h1")
        rep = run.result()
        victim.proc.join(30.0)
        apps_after = _compute_apps()
        t_wait = time.monotonic() + 15.0
        while len(apps_after) >= len(apps_before) \
                and time.monotonic() < t_wait:
            time.sleep(0.25)
            apps_after = _compute_apps()
        pid_listed = [p for p, _ in apps_before]
        retried = sum(t.attempts > 0 for t in rt.dispatcher.completed)
        log(f"[fleet] (c) {hosts} x {tph} on the first "
            f"{FLEET_FAILURE_TASKS} requests: SIGKILL h1 (pid {pid}) after "
            f"{done_at_kill} completions with {in_flight} of its tasks in "
            f"flight; completed {rep.n_completed}, failed {rep.n_failed}, "
            f"{retried} completed on a later attempt; executors left "
            f"{len(rt.workers)}; victim exit code {victim.proc.exitcode}")
        log(f"[fleet] (c) nvidia-smi compute apps before the kill "
            f"{apps_before}, after {apps_after}")
        if rep.n_completed + rep.n_failed != FLEET_FAILURE_TASKS \
                or rep.n_failed:
            raise AssertionError("fleet failure run: tasks not accounted")
        if not victim_eids.isdisjoint(rt.workers) \
                or len(rt.workers) != tph:
            raise AssertionError("fleet failure run: the victim's executors "
                                 "are still in the pool")
        if victim.proc.exitcode != -9:
            raise AssertionError(f"fleet failure run: victim exit code "
                                 f"{victim.proc.exitcode}")
        if str(pid) in pid_listed:
            held = any(p == str(pid) for p, _ in apps_after)
        else:
            # nvidia-smi shows another pid namespace's numbers: the killed
            # process holds nothing when its line is gone
            held = len(apps_after) != len(apps_before) - 1
        if held:
            raise AssertionError("fleet failure run: the killed host still "
                                 "holds device memory")
        return {"tasks": FLEET_FAILURE_TASKS, "killed_pid": pid,
                "completed_at_kill": done_at_kill,
                "victim_in_flight": in_flight,
                "n_completed": rep.n_completed, "n_failed": rep.n_failed,
                "retried": retried,
                "wall_s": rep.wall_s, "executors_left": len(rt.workers),
                "nvidia_smi_before": apps_before,
                "nvidia_smi_after": apps_after}
    finally:
        eng.shutdown()


def phase_fleet(card: str) -> dict:
    from repro_torch.apps import astro
    from repro_torch.configs.astro_stacking import WORKLOADS, workload
    from repro_torch.core import DataObject
    from repro_torch.fleet import wire

    t0 = time.monotonic()
    n_tasks, n_files = WORKLOADS[FLEET_LOCALITY]
    ideal = workload(FLEET_LOCALITY).ideal_cache_hit_ratio
    objects = _fleet_spec(1, 1).workload
    log(f"[fleet] {n_tasks} requests over {n_files} files of "
        f"{astro.FILE_BYTES} B (Table 2, locality {FLEET_LOCALITY}; "
        f"{n_files * astro.FILE_BYTES / 1e6:.1f} MB catalog; no cut), each "
        f"writing its {astro.H * astro.W * 4} B coadd to its executor's "
        f"cache; 1 GiB caches on the card; {objects.popularity['kind']} "
        f"popularity, max-compute-util; hosts are spawned processes "
        f"running {FLEET_TASK_FN}; wire codec 'auto' = "
        f"{'msgpack' if wire.HAVE_MSGPACK else 'json'}; {card}")
    tiles = {f"img{i}": astro.make_tiles(DataObject(f"img{i}", 0))
             for i in range(n_files)}
    log(f"[fleet] catalog made on the host in {time.monotonic() - t0:.2f}s")
    parity = _fleet_parity(tiles)
    free = _fleet_free(tiles, ideal)
    failure = _fleet_failure(tiles)
    wall = time.monotonic() - t0
    log(f"[fleet] phase 14 took {wall:.1f}s")
    return {"parity": parity, "free": free, "failure": failure,
            "wall_s": wall,
            "launches": (parity["launches_inprocess"]
                         + sum(parity["launches_hosts"].values())
                         + sum(free["launches_hosts"].values()))}


# --------------------------------------------------------------------------
# phase 15: the command line, run as a user types it
# --------------------------------------------------------------------------

def _cli_start(app: str, *args) -> dict:
    """Start ``python -m repro_torch.apps.<app> args`` from the checkout's
    root with ``PYTHONPATH=src``."""
    import os

    argv = [sys.executable, "-m", f"repro_torch.apps.{app}", *map(str, args)]
    proc = subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    return {"argv": argv[2:], "proc": proc, "t0": time.monotonic()}


def _cli_stop(run: dict) -> None:
    """Kill a started CLI that is still running (a check failed first)."""
    if run["proc"].poll() is None:
        run["proc"].kill()
        run["proc"].wait()


def _cli_done(run: dict, check: bool = True) -> dict:
    """Wait for a started CLI: its stdout, stderr and wall seconds.
    Raises on a non-zero exit unless ``check`` is off."""
    proc = run["proc"]
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        _cli_stop(run)
    if check and proc.returncode != 0:
        raise AssertionError(f"{' '.join(run['argv'])} exited "
                             f"{proc.returncode}: {stderr[-2000:]}")
    return {"stdout": stdout, "stderr": stderr, "rc": proc.returncode,
            "seconds": time.monotonic() - run["t0"]}


def _cli(app: str, *args, check: bool = True) -> dict:
    return _cli_done(_cli_start(app, *args), check)


def _cli_report(path: Path):
    from repro_torch.experiments import RunReport

    return RunReport.from_dict(json.loads(path.read_text()))


def _device_line(out: dict, card: str) -> str:
    """The run's device line on stderr; it must name the card as
    nvidia-smi does."""
    lines = [ln for ln in out["stderr"].splitlines()
             if ln.startswith("# device: ")]
    if lines != [f"# device: {card}"]:
        raise AssertionError(f"CLI device line {lines}, want the card "
                             f"{card!r}")
    return lines[0]


def _outcome_placements(trace: Path) -> list:
    from repro_torch.workloads import read_outcomes

    return sorted((o["tid"], o["executor"], o["cache_hits"], o["peer_hits"],
                   o["cache_misses"]) for o in read_outcomes(trace))


def _n_differing(a: list, b: list) -> int:
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _frame_numbers(frame: str) -> dict:
    """The queue depth, pool size and completions a monitor frame shows."""
    import re

    out = {}
    for key in ("queue", "pool", "completed"):
        m = re.search(rf"\b{key}=\s*(\d+)", frame)
        if m is None:
            raise AssertionError(f"monitor frame shows no {key}: {frame!r}")
        out[key] = int(m.group(1))
    return out


def _cli_specs(workdir: Path) -> dict:
    """Phase 14 (c)'s traffic as spec files: the first CLI_TASKS requests
    of the locality-30 trace recorded to a trace the specs name, on 64
    executors in process and on CLI_FLEET hosts x threads (with its
    telemetry sink, where each host's stats frames land)."""
    import dataclasses

    from repro_torch.experiments import (ObserveSpec, WorkloadSpec,
                                         build_workload)
    from repro_torch.workloads import Workload, record

    hosts, tph = CLI_FLEET
    fleet = _fleet_spec(hosts, tph)
    full = build_workload(fleet.workload)
    trace = workdir / "locality30_first4000.jsonl"
    record(Workload(full.name, full.objects, full.events[:CLI_TASKS],
                    full.spec), trace)
    fleet = dataclasses.replace(
        fleet, workload=WorkloadSpec(name="astro", trace_path=str(trace)))
    flat = dataclasses.replace(fleet, hosts=0, threads_per_host=1)
    specs = {"flat": flat, "fleet": dataclasses.replace(
        fleet, observe=ObserveSpec(
            metrics=True, metrics_interval_s=0.5,
            metrics_sink_path=str(workdir / "fleet.metrics.jsonl")))}
    paths = {}
    for name, spec in specs.items():
        paths[name] = workdir / f"{name}.json"
        spec.save(paths[name])
    return {**specs, "paths": paths, "trace": trace}


def _in_process(specs: dict, workdir: Path) -> dict:
    """What the CLIs are held to: the simulator and a
    ``RuntimeEngine(device="cuda")`` on the flat spec in this process,
    and an in-process ``record`` of the generator ``mk_workload
    generate`` is given (MK_FLAGS, at the CLI's defaults)."""
    from repro_torch import workloads as W
    from repro_torch.experiments import RuntimeEngine, run_experiment
    from repro_torch.kernels.build import COUNTERS

    sim = run_experiment(specs["flat"], engine="sim")
    for c in COUNTERS.values():
        c.reset()
    eng = RuntimeEngine(device="cuda").prepare(specs["flat"])
    try:
        rt = eng.run(barrier_every=CLI_BARRIER, timeout=600.0)
        placements = _placements(eng.runtime)
    finally:
        eng.shutdown()
    launched = {k: c.value for k, c in COUNTERS.items() if c.value}
    rate, mb = 8.0, 10**6
    record = workdir / "gen_record.jsonl"
    W.record(W.generate(
        "wl", W.SineWaveArrivals(mean_rate=rate, amplitude=0.9 * rate,
                                 period_s=120.0),
        W.ZipfPopularity(alpha=1.1, k=3, corr=0.8),
        n_tasks=MK_TASKS, n_objects=250, object_bytes=int(10.0 * mb),
        compute_seconds=0.5, store_metadata_ops=0, seed=0), record)
    return {"sim": sim, "runtime": rt, "placements": placements,
            "launched": launched, "record": record}


def _check_experiment(card: str, runs: dict, ref: dict, specs: dict,
                      workdir: Path) -> dict:
    """(a)-(c): the CLI's describe, sim, runtime and fleet runs against
    the in-process engines."""
    from repro_torch.fleet import reports_scheduling_equal

    flat = specs["flat"]
    d = _cli_done(runs["describe"])
    desc = json.loads(d["stdout"])
    if (desc["fingerprint"] != flat.fingerprint()
            or desc["workload"]["n_tasks"] != CLI_TASKS):
        raise AssertionError(f"describe: {desc['fingerprint']} "
                             f"{desc['workload']}")
    r = _cli_done(runs["sim"])
    json.loads(r["stdout"])                      # stdout is pure JSON
    sim_cli = _cli_report(workdir / "sim.json")
    sim_diff = sim_cli.diff(ref["sim"], ignore=("wall_s",))
    log(f"[cli] (a) describe {desc['fingerprint']}: {CLI_TASKS} requests "
        f"over {desc['workload']['n_objects']} files "
        f"({d['seconds']:.1f}s); run --engine sim ({r['seconds']:.1f}s): "
        f"hit ratio {sim_cli.cache_hit_ratio:.4f}, fields differing from "
        f"the in-process sim: {sorted(sim_diff) or 'none'}")
    if sim_diff:
        raise AssertionError(f"CLI sim report differs: {sim_diff}")
    out = {"describe": {"fingerprint": desc["fingerprint"],
                        "workload": desc["workload"],
                        "seconds": d["seconds"]},
           "sim": {"cache_hit_ratio": sim_cli.cache_hit_ratio,
                   "seconds": r["seconds"], "diff_fields": sorted(sim_diff)}}
    # (b) no --device: the card, against RuntimeEngine(device="cuda")
    r = _cli_done(runs["runtime"])
    json.loads(r["stdout"])
    line = _device_line(r, card)
    rt_cli = _cli_report(workdir / "runtime.json")
    rt_diff = reports_scheduling_equal(rt_cli, ref["runtime"])
    per_b = _outcome_placements(workdir / "runtime.trace.jsonl")
    n_moved = _n_differing(per_b, ref["placements"])
    log(f"[cli] (b) run --engine runtime --barrier-every {CLI_BARRIER} "
        f"({r['seconds']:.1f}s, no --device): stderr {line!r}; "
        f"{rt_cli.n_completed} completed, hit ratio "
        f"{rt_cli.cache_hit_ratio:.4f}, bytes {rt_cli.bytes_by_kind}; "
        f"scheduling fields differing from RuntimeEngine(device='cuda'): "
        f"{sorted(rt_diff) or 'none'}; tasks placed differently: "
        f"{n_moved}; kernel launches in process (shape-only): "
        f"{ref['launched'] or 'none'}")
    if rt_diff or n_moved or rt_cli.n_completed != CLI_TASKS:
        raise AssertionError(f"CLI runtime report differs: {rt_diff}, "
                             f"{n_moved} tasks placed differently")
    if ref["launched"]:
        raise AssertionError(f"a shape-only run launched kernels: "
                             f"{ref['launched']}")
    out["runtime"] = {"device_line": line, "seconds": r["seconds"],
                      "n_completed": rt_cli.n_completed,
                      "cache_hit_ratio": rt_cli.cache_hit_ratio,
                      "bytes_by_kind": rt_cli.bytes_by_kind,
                      "diff_fields": sorted(rt_diff),
                      "placements_differing": n_moved}
    # (c) the same spec on host processes through the CLI
    hosts, tph = CLI_FLEET
    r = _cli_done(runs["fleet"])
    line_c = _device_line(r, card)
    fl_cli = _cli_report(workdir / "fleet.json")
    n_moved_c = _n_differing(
        _outcome_placements(workdir / "fleet.trace.jsonl"), per_b)
    fl_diff = reports_scheduling_equal(fl_cli, ref["runtime"])
    host_dev = {}
    for ln in (workdir / "fleet.metrics.jsonl").read_text().splitlines():
        for h, snap in json.loads(ln).get("hosts", {}).items():
            g = snap.get("metrics", {}).get("gauges", {})
            seen = host_dev.setdefault(h, {"reserved": 0, "launches": {}})
            seen["reserved"] = max(seen["reserved"],
                                   int(g.get("device.memory_reserved", 0)))
            seen["launches"].update({k: v for k, v in g.items()
                                     if k.startswith("kernel.")})
    log(f"[cli] (c) {hosts} hosts x {tph} threads through the CLI "
        f"({r['seconds']:.1f}s, spawn included): stderr {line_c!r}; "
        f"{fl_cli.n_completed} completed; tasks placed differently from "
        f"(b): {n_moved_c}; scheduling fields differing from the "
        f"in-process run: {sorted(fl_diff) or 'none'}; each host's device "
        f"memory reserved and kernel launches, from its stats frames: "
        f"{dict(sorted(host_dev.items()))}")
    if n_moved_c or fl_diff or fl_cli.n_completed != CLI_TASKS:
        raise AssertionError(f"CLI fleet run differs: {fl_diff}, "
                             f"{n_moved_c} tasks placed differently")
    if sorted(host_dev) != [f"h{i}" for i in range(hosts)] or any(
            v["reserved"] <= 0 or v["launches"] for v in host_dev.values()):
        raise AssertionError(f"fleet hosts not on the card, or launching "
                             f"kernels: {host_dev}")
    out["fleet"] = {"layout": [hosts, tph], "device_line": line_c,
                    "seconds": r["seconds"],
                    "n_completed": fl_cli.n_completed,
                    "placements_differing": n_moved_c,
                    "diff_fields": sorted(fl_diff), "hosts": host_dev}
    return out


def _check_generate(run: dict, ref: dict, workdir: Path) -> dict:
    """(d), first half: ``mk_workload generate`` against ``record``."""
    g = _cli_done(run)
    same = (workdir / "gen_cli.jsonl").read_bytes() \
        == ref["record"].read_bytes()
    log(f"[cli] (d) mk_workload generate {' '.join(map(str, MK_FLAGS))} "
        f"({g['seconds']:.1f}s): {g['stderr'].strip()}; byte-identical "
        f"to an in-process record: {same}")
    if not same:
        raise AssertionError("mk_workload generate differs from record")
    return {"byte_identical": same, "generate_seconds": g["seconds"]}


def _check_mk_run(card: str, run: dict) -> dict:
    """(d), second half: ``mk_workload run`` of that trace on the card."""
    r = _cli_done(run)
    line = _device_line(r, card)
    rep = json.loads(r["stdout"])
    log(f"[cli] (d) mk_workload run --engine runtime (done within "
        f"{r['seconds']:.1f}s, beside (e)): "
        f"stderr {line!r}; {rep['n_completed']} completed, mean inputs "
        f"{rep['mean_inputs_per_task']:.3f}, hit ratio "
        f"{rep['cache_hit_ratio']:.4f}, full/partial/zero-hit tasks "
        f"{rep['full_hit_tasks']}/{rep['partial_hit_tasks']}/"
        f"{rep['zero_hit_tasks']}")
    if rep["n_completed"] != MK_TASKS or rep["engine"] != "runtime":
        raise AssertionError(f"mk_workload run: {rep['n_completed']}")
    return {"run_seconds": r["seconds"], "device_line": line,
            "n_completed": rep["n_completed"],
            "cache_hit_ratio": rep["cache_hit_ratio"]}


def _check_diff(run: dict) -> dict:
    """(b), last: ``diff SPEC TRACE`` of the runtime run's trace."""
    dv = _cli_done(run)
    log(f"[cli] (b) diff SPEC TRACE (done within {dv['seconds']:.1f}s, "
        f"beside (e)):")
    for ln in dv["stdout"].splitlines():
        log(f"[cli]     {ln}")
    if not dv["stdout"].startswith(f"matched {CLI_TASKS} task(s)"):
        raise AssertionError(f"diff matched otherwise: {dv['stdout']!r}")
    return {"divergence": dv["stdout"].splitlines(),
            "seconds": dv["seconds"]}


def _cli_monitor(card: str, specs: dict, workdir: Path) -> dict:
    """(e): a run with the telemetry plane on, paced on the wall clock;
    ``monitor --attach`` while it runs and ``monitor --tail`` after."""
    import dataclasses
    import socket

    from repro_torch.experiments import ObserveSpec, build_workload

    port = _free_port()
    spec = dataclasses.replace(specs["flat"], observe=ObserveSpec(
        metrics=True, metrics_interval_s=0.25, metrics_port=port,
        metrics_sink_path=str(workdir / "observed.metrics.jsonl")))
    spec.save(workdir / "observed.json")
    scale = CLI_OBSERVED_S / build_workload(spec.workload).duration
    run = _cli_start("run_experiment", "run", workdir / "observed.json",
                     "--engine", "runtime", "--time-scale", f"{scale:.3f}")
    attached = None
    deadline = time.monotonic() + 120.0
    try:
        while (attached is None and run["proc"].poll() is None
               and time.monotonic() < deadline):
            try:      # the endpoint is up once the run's engine is prepared
                socket.create_connection(("127.0.0.1", port), 0.5).close()
            except OSError:
                time.sleep(0.1)
                continue
            a = _cli("monitor", "--attach", f"127.0.0.1:{port}", "--once",
                     check=False)
            if "queue=" in a["stdout"]:
                attached = a
        r = _cli_done(run)
    finally:
        _cli_stop(run)
    if attached is None:
        raise AssertionError("monitor --attach never drew a frame while "
                             "the run was live")
    line = _device_line(r, card)
    rep = json.loads(r["stdout"])
    tail = _cli("monitor", "--tail", spec.observe.metrics_sink_path,
                "--once")
    live, final = (_frame_numbers(x["stdout"]) for x in (attached, tail))
    log(f"[cli] (e) observed run at time scale {scale:.3f} "
        f"({r['seconds']:.1f}s, stderr {line!r}): {rep['n_completed']} "
        f"completed, {rep['telemetry'].get('n_samples')} telemetry samples")
    for name, x in (("attach", attached), ("tail", tail)):
        log(f"[cli] (e) monitor --{name} --once ({x['seconds']:.1f}s):")
        for ln in x["stdout"].splitlines():
            log(f"[cli]     {ln}")
    if (live["pool"] != spec.cluster.n_nodes
            or final["pool"] != spec.cluster.n_nodes
            or final["queue"] != 0 or final["completed"] != CLI_TASKS
            or rep["n_completed"] != CLI_TASKS):
        raise AssertionError(f"monitor frames: live {live}, final {final}")
    return {"time_scale": scale, "seconds": r["seconds"],
            "device_line": line, "attached": live, "tailed": final,
            "n_samples": rep["telemetry"].get("n_samples")}


def _index_timing() -> dict:
    """(f): the location index's Figure 2 timing on the host, as
    benchmarks/bench_index.py takes it, and the P-RLS model."""
    from repro_torch.core import (LocationIndex, ShardedIndex,
                                  prls_aggregate_throughput)

    central = LocationIndex().time_ops(INDEX_OPS)
    sharded_ix = ShardedIndex(n_shards=INDEX_SHARDS)
    sharded = sharded_ix.time_ops(INDEX_OPS)
    ops = sharded_ix.n_inserts + sharded_ix.n_lookups + sharded_ix.n_removes
    prls = {n: prls_aggregate_throughput(n) for n in PRLS_NODES}
    lookups_s = 1.0 / central["lookup_s"]
    log(f"[cli] (f) index timing on the host CPU of the card's machine "
        f"(host clock, not a device metric), {INDEX_OPS} ops each: central "
        f"insert {central['insert_s'] * 1e6:.4f} us, lookup "
        f"{central['lookup_s'] * 1e6:.4f} us, {lookups_s:.0f} lookups/s "
        f"(paper: 4.18M/s, Java 2008); {INDEX_SHARDS}-shard insert "
        f"{sharded['insert_s'] * 1e6:.4f} us, lookup "
        f"{sharded['lookup_s'] * 1e6:.4f} us, {ops} ops counted")
    log("[cli] (f) P-RLS model, aggregate lookups/s: " + ", ".join(
        f"{n} nodes {v:.0f}" for n, v in prls.items()))
    if ops != 3 * INDEX_OPS:
        raise AssertionError(f"sharded index counted {ops} ops")
    return {"clock": "host", "n": INDEX_OPS,
            "central_insert_us": central["insert_s"] * 1e6,
            "central_lookup_us": central["lookup_s"] * 1e6,
            "central_lookups_per_s": lookups_s,
            "sharded_insert_us": sharded["insert_s"] * 1e6,
            "sharded_lookup_us": sharded["lookup_s"] * 1e6,
            "prls_aggregate_lookups_per_s": prls}


def phase_cli(card: str) -> dict:
    """The CLIs in two waves of concurrent subprocesses (each costs
    seconds of interpreter and torch import before it works): describe,
    the sim, the runtime, the fleet and generate, with the in-process
    runs beside them; then diff, mk_workload run and the observed run
    with its monitors; then the index timing alone."""
    import shutil

    t0 = time.monotonic()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    specs = _cli_specs(CLI_DIR)
    paths, w = specs["paths"], CLI_DIR
    log(f"[cli] the first {CLI_TASKS} requests of Table 2's locality-"
        f"{FLEET_LOCALITY} trace, shape-only (the CLI passes no payload "
        f"factory, so no tensor moves and no kernel launches), 1 GiB caches, "
        f"written to {specs['trace'].relative_to(ROOT)} and named by the "
        f"spec files; each CLI is a `python -m repro_torch.apps.<cli>` "
        f"subprocess with PYTHONPATH=src; {card}")
    first = {
        "describe": ("run_experiment", "describe", paths["flat"]),
        "sim": ("run_experiment", "run", paths["flat"], "--engine", "sim",
                "--out", w / "sim.json"),
        "runtime": ("run_experiment", "run", paths["flat"], "--engine",
                    "runtime", "--barrier-every", CLI_BARRIER,
                    "--trace-out", w / "runtime.trace.jsonl",
                    "--out", w / "runtime.json"),
        "fleet": ("run_experiment", "run", paths["fleet"], "--engine",
                  "runtime", "--barrier-every", CLI_BARRIER, "--trace-out",
                  w / "fleet.trace.jsonl", "--out", w / "fleet.json"),
        "generate": ("mk_workload", "generate", *MK_FLAGS,
                     "--out", w / "gen_cli.jsonl")}
    runs, later = {}, {}
    try:
        for name, argv in first.items():
            runs[name] = _cli_start(*argv)
        ref = _in_process(specs, w)
        out = _check_experiment(card, runs, ref, specs, w)
        out["workload"] = _check_generate(runs["generate"], ref, w)
        later["diff"] = _cli_start("run_experiment", "diff", paths["flat"],
                                   w / "runtime.trace.jsonl")
        later["mk_run"] = _cli_start("mk_workload", "run",
                                     w / "gen_cli.jsonl", "--engine",
                                     "runtime")
        out["monitor"] = _cli_monitor(card, specs, w)
        out["runtime"]["diff"] = _check_diff(later["diff"])
        out["workload"].update(_check_mk_run(card, later["mk_run"]))
    finally:
        for run in (*runs.values(), *later.values()):
            _cli_stop(run)
    out["index"] = _index_timing()
    out["wall_s"] = time.monotonic() - t0
    log(f"[cli] phase 15 took {out['wall_s']:.1f}s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every measurement to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card only", file=sys.stderr)
        return 1
    # the plain versions' fp32 products must be full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    env = phase_environment()
    log("[env] TF32 off for matmuls and cuDNN: fp32 products run in fp32")
    kernels = phase_kernels()
    kernels["flash_attention"] = phase_flash_kernel()
    kernels["mamba_scan"] = phase_mamba_kernel()
    flat = phase_flat()
    pipe = phase_pipeline()
    serve = phase_serve()
    ssm = phase_ssm_serve()
    trained = phase_train()
    moe = phase_moe()
    ssm_trained = phase_ssm_train()
    encdec = phase_encdec()
    elastic = phase_elastic(env["nvidia_smi"])
    vision = phase_vision_train(env["nvidia_smi"])
    serve_diffusion = phase_serve_diffusion(env["nvidia_smi"])
    fleet = phase_fleet(env["nvidia_smi"])
    cli = phase_cli(env["nvidia_smi"])

    main_row = next(r for r in kernels["stack_rois"]
                    if r["case"].startswith("main/flat"))
    stack_row = next(r for r in kernels["stack_rois"]
                     if r["case"].startswith("main/stack"))
    main_err = max(r["max_abs_err"] for r in kernels["stack_rois"]
                   if r["case"].startswith("main/"))
    line = {"kernels": [{
        "name": "stack_rois",
        "route": "cuda",
        "source": STACKING_SOURCE,
        "replaces": STACKING_TPU_KERNEL,
        "launches": (flat["launches"] + pipe["launches"]
                     + elastic["launches"] + fleet["launches"]),
        "launches_flat": flat["launches"],
        "launches_pipeline": pipe["launches"],
        "launches_elastic": elastic["launches"],
        "launches_fleet": fleet["launches"],
        "shape": main_row["shape"],
        "max_abs_err": main_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "host_ms": main_row["host_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "launch_floor_ms": main_row["launch_floor_ms"],
        "pipeline_stack": {k: stack_row[k] for k in (
            "shape", "max_abs_err", "ms", "host_ms", "bound_ms",
            "bound_by")},
        "launches_one_call": flat["one_call_coadds"],
        "one_call_coadd": [{k: r[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "stack_alone_ms",
            "prep_ms", "host_ms", "former_host_ms", "bound_ms", "bound_by")}
            for r in kernels["coadd"]],
    }]}
    fa_rows = {r["case"]: r for r in kernels["flash_attention"]}
    fa_main, fa_prefill = fa_rows["main/serve"], fa_rows["main/prefill"]
    fa_train = fa_rows["main/train"]
    fa_moe = fa_rows["main/serve qwen3-moe"]
    fa_encoder = fa_rows["main/encoder whisper-base"]
    fa_llava = fa_rows["main/prefill llava"]
    fa_llava_train = fa_rows["main/train llava"]
    launches_encdec = (
        encdec["whisper"]["launches_encoder"]["flash_attention"]
        + encdec["whisper"]["launches"]["flash_attention"]
        + encdec["whisper_train"]["launches"]
        + encdec["llava"]["launches_forward"]["flash_attention"]
        + encdec["llava"]["launches"]["flash_attention"])
    hybrid = list(moe["hybrid"].values()) + [moe["hybrid_train"]]
    launches_hybrid = {k: sum(h["launches"][k] for h in hybrid)
                       for k in ("flash_attention", "flash_attention/wgmma",
                                 "mamba_scan")}
    line["kernels"].append({
        "name": "flash_attention",
        "route": "cuda",
        "source": FLASH_SOURCE,
        "replaces": FLASH_TPU_KERNEL,
        "launches": (serve["launches"] + trained["launches"]
                     + moe["serve"]["launches"]
                     + launches_hybrid["flash_attention"]
                     + moe["train"]["launches"] + launches_encdec
                     + vision["launches"]),
        "launches_serve": serve["launches"],
        "launches_train": trained["launches"],
        "launches_moe_serve": moe["serve"]["launches"],
        "launches_hybrid": launches_hybrid["flash_attention"],
        "launches_moe_train": moe["train"]["launches"],
        "launches_encdec": launches_encdec,
        "launches_vision_train": vision["launches"],
        "launches_wgmma": (serve["launches_wgmma"]
                           + trained["launches_wgmma"]
                           + moe["serve"]["launches_wgmma"]
                           + launches_hybrid["flash_attention/wgmma"]
                           + moe["train"]["launches_all"][
                               "flash_attention/wgmma"]
                           + launches_encdec
                           + vision["launches_wgmma"]),
        "path": fa_main["path"],
        "shape": fa_main["shape"],
        "max_abs_err": max(fa_main["max_abs_err"], fa_prefill["max_abs_err"]),
        "ms": fa_main["ms"],
        "plain_ms": fa_main["plain_ms"],
        "host_ms": fa_main["host_ms"],
        "bound_ms": fa_main["bound_ms"],
        "bound_by": fa_main["bound_by"],
        "library_ms": fa_main["library_ms"],
        "sdpa_mask_ms": fa_main["sdpa_mask_ms"],
        "sdpa_flag_ms": fa_main["sdpa_flag_ms"],
        "tflops": fa_main["tflops"],
        "prefill": {k: fa_prefill[k] for k in (
            "path", "shape", "max_abs_err", "ms", "plain_ms", "host_ms",
            "bound_ms", "bound_by", "library_ms", "sdpa_mask_ms",
            "sdpa_flag_ms", "tflops")},
        "train": {k: fa_train[k] for k in (
            "path", "shape", "max_abs_err", "ms", "plain_ms", "host_ms",
            "bound_ms", "bound_by", "library_ms", "sdpa_mask_ms",
            "sdpa_flag_ms", "tflops")},
        "serve_qwen3_moe": {k: fa_moe[k] for k in (
            "path", "shape", "max_abs_err", "ms", "plain_ms", "host_ms",
            "bound_ms", "bound_by", "library_ms", "sdpa_mask_ms",
            "sdpa_flag_ms", "tflops")},
        "encoder_whisper": {k: fa_encoder[k] for k in (
            "path", "shape", "causal", "max_abs_err", "ms", "plain_ms",
            "host_ms", "bound_ms", "bound_by", "library_ms", "sdpa_mask_ms",
            "sdpa_flag_ms", "tflops")},
        "prefill_llava": {k: fa_llava[k] for k in (
            "path", "shape", "causal", "max_abs_err", "ms", "plain_ms",
            "host_ms", "bound_ms", "bound_by", "library_ms", "sdpa_mask_ms",
            "sdpa_flag_ms", "tflops")},
        "train_llava": {k: fa_llava_train[k] for k in (
            "path", "shape", "causal", "max_abs_err", "ms", "plain_ms",
            "host_ms", "bound_ms", "bound_by", "library_ms", "sdpa_mask_ms",
            "sdpa_flag_ms", "tflops")},
    })
    ms_rows = {r["case"]: r for r in kernels["mamba_scan"]}
    ms_main, ms_prefill = ms_rows["main/serve"], ms_rows["main/prefill"]
    ms_train = ms_rows["main/train"]
    ms_back = ms_rows["main/train backward (plain chunked scan)"]
    line["kernels"].append({
        "name": "mamba_scan",
        "route": "cuda",
        "source": MAMBA_SOURCE,
        "replaces": MAMBA_TPU_KERNEL,
        "launches": (ssm["launches"] + launches_hybrid["mamba_scan"]
                     + ssm_trained["launches"]),
        "launches_ssm_serve": ssm["launches"],
        "launches_hybrid": launches_hybrid["mamba_scan"],
        "launches_ssm_train": ssm_trained["launches"],
        "launches_by_path": ssm["launches_by_path"],
        "path": ms_main["path"],
        "bound_share": ms_main["bound_share"],
        "shape": ms_main["shape"],
        "max_abs_err": max(ms_main["max_abs_err"], ms_prefill["max_abs_err"]),
        "ms": ms_main["ms"],
        "plain_ms": ms_main["plain_ms"],
        "host_ms": ms_main["host_ms"],
        "bound_ms": ms_main["bound_ms"],
        "bound_by": ms_main["bound_by"],
        "library_ms": None,
        "prefill": {k: ms_prefill[k] for k in (
            "path", "shape", "max_abs_err", "ms", "plain_ms", "host_ms",
            "bound_ms", "bound_by", "bound_share", "library_ms")},
        "train": dict({k: ms_train[k] for k in (
            "path", "shape", "max_abs_err", "ms", "plain_ms", "host_ms",
            "bound_ms", "bound_by", "bound_share", "library_ms",
            "other_path", "other_path_ms")},
            plain_backward_ms=ms_back["host_ms"],
            plain_backward_device_ms=ms_back["device_ms"]),
    })
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"env": env, "kernels": kernels, "flat": flat, "pipeline": pipe,
             "serve": serve, "ssm_serve": ssm, "train": trained,
             "moe": moe, "ssm_train": ssm_trained, "encdec": encdec,
             "elastic": elastic, "vision_train": vision,
             "serve_diffusion": serve_diffusion, "fleet": fleet,
             "cli": cli, "kernels_line": line,
             "seconds": time.monotonic() - t_start},
            indent=2, default=str) + "\n")
    log(f"[done] all phases passed in {time.monotonic() - t_start:.1f}s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
