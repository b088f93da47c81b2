#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. environment: torch / CUDA versions, the card's name and power limit;
  1. build: compile the CUDA kernels from src/repro_torch/csrc;
  2. one phase per kernel at the shapes of the main path (the 26 sparse
     buckets of lm-100m, R = 4 replicas): each kernel is held against its
     plain PyTorch version on the card, and timed with CUDA events beside
     the plain version, a PyTorch library call where one computes the
     same function, and the memory-bandwidth bound; bucket_scatter_sum,
     qsgd_pack and qsgd_unpack are timed as the main path calls them, one
     grouped launch over the 26 buckets (the fused densify + rank-order
     sum into one step buffer, the pack reading those sums where they
     lie, the unpack writing the reduced buffers; the first also with
     duplicates and sentinels, bit-equal); the single-source
     bucket_scatter on the 26 buckets' streams, the single-bucket pack on
     contiguous copies of the same QSGD rows, and the single-bucket unpack
     checked on every bucket and timed alone on the largest. Every kernel
     is also timed as its launches replayed from a CUDA graph (the device
     alone) and as the host's enqueue time. Then bucket_topk's k sweep: at
     the Fig. 3 rows
     (262144, 512) with k in {1, 4, 8, 16, 32, 64, 128, 512} and at
     (131072, 1024) with k in {16, 128}, each point bit-equal to the plain
     version on all three outputs and timed (CUDA events, the device alone
     from a CUDA-graph replay) beside torch.topk(x.abs(), k), the bound
     and a copy of x (the same bytes, device alone); and the adversarial
     row sets of repro_torch.kernels.bucket_topk.cases (one magnitude,
     signed zeros, infinities, denormals, ties at the k-th key, keys
     differing only in their lowest bits) at B in {128, 256, 384, 512,
     640, 1024, 2048, 4096, 8192} with k in {1, 4, 8, 64, B/64, B/2, B},
     bit-equal to the plain version; then the B sweep: at B in {384, 640,
     2048, 4096, 8192} (2^26 entries) with k in {1, 8, B/64, B/2, B}, each
     point bit-equal and timed (CUDA events, the device alone from a
     CUDA-graph replay) beside its bound and torch.topk(x.abs(), k);
  3. main paths, each with every kernel's launch count reset before and
     read after: Trainer.run of lm-100m with SparCML sync (DSAR + 4-bit
     QSGD, k = 8 of 512, R = 4 stacked replicas) for 6 steps (26 launches
     a step of bucket_topk, one each of bucket_scatter_sum, qsgd_pack and
     qsgd_unpack); 3 more under the profiler (the device's idle
     share); then on the same trainer, as the example's --pipeline does,
     Trainer.run_pipelined for 12 more steps (staleness 1, supersteps of
     4, two units deep, the reduce half on a side CUDA stream), with its
     step time, the overlap win, peak memory and the allocator's
     counters; the synchronous step's phases each alone (CUDA events);
     then dense-mode steps for comparison;
  4. small-input check: 3 steps of a 2-layer model on the card (kernels)
     and on the CPU (plain versions, the path the tests hold against the
     JAX package) with the same QSGD bits must give the same losses;
  5. overlap race check at lm-100m: 8 staleness-1 steps through the async
     driver (K = 4, depth 2, telemetry on, under the profiler: the
     streams' busy and overlapping shares) must equal, bit for bit, the
     same step function
     called 8 times with a device synchronisation after each (losses,
     final params, EF residuals, in-flight buffers); two such sequential
     runs show whether the sequential run is itself reproducible. No
     host synchronisation may happen inside a step (CUDA sync debug
     mode). Also the host's time to enqueue one step, at a batch so
     small that the card waits for the host;
  6. small-model runtime checks: staleness-0 pipelined equals Trainer.run
     bit for bit; staleness 1 on the card equals the CPU path within rtol
     2e-4 with the same QSGD bits; a pipelined run with checkpoints and a
     fresh Trainer resumed from them hold the same state bit for bit;
  7. the sparse allreduce library at the paper's Fig. 3 size:
     make_sparse_allreduce over StackedCollectives(8) at N = 2^24, k = 4
     and 64 of 512, for every algorithm (DSAR also with 4-bit QSGD),
     each held against the exact f64 sum of the 8 ranks' TopK streams,
     built with the plain versions alone (the clamped ones with their
     folds; DSAR + QSGD also against the same pipeline through the plain
     versions with the same rounding bits), bit-equal across two calls,
     timed (CUDA events, and the device alone from a CUDA-graph replay)
     with the kernels' launches, and one call of each profiled (device
     time, the costliest kernels; valid only where the trace holds the
     launches the counters saw); recursive doubling's switch to dense at
     k = 64; at both densities the kernels held against their plain
     versions on the tensors this path hands them (the owner densify is
     bucket_scatter_sum, G = S = 8), then timed at these shapes beside
     their bounds;
  8. the per-rank lm-100m step: Trainer.run with lowering="manual" (the
     wire protocols over the 4 stacked ranks: 26 launches a step of
     bucket_topk, bucket_scatter_sum and qsgd_pack, one grouped
     qsgd_unpack) for 6 steps, bit-equal to phase 3's stacked run (same
     seed, same QSGD bits); both executors' reduce halves alone, in turns; the
     per-rank half's grouped qsgd_unpack segments (the received row-major
     layout) captured from one call and the CUDA launch held bit for bit
     against qsgd_unpack_grouped_ref on them; both synchronous steps
     timed in turns from one state;
  9. sparse classification (run_classify) at full size on the card:
     ssar_split_allgather's accuracy within 0.01 of dense's, and the
     weights after 2 steps within rtol 1e-5 of the CPU path;
 10. the pipelined per-rank lm-100m step: phase 8's trainer takes the 3
     more synchronous steps phase 3's did, then Trainer.run_pipelined with
     lowering="manual" for the same 12 steps (K = 4, depth 2), against
     phase 3's pipelined losses, with its launch counts, step time, peak
     memory and overlap win;
 11. telemetry: the stacked pipelined lm-100m step through the driver
     with telemetry off, on, on, off (20 steps each after a warm-up run:
     step times, losses bit-equal), and the reduce half alone the same
     way; one step's 26 rows checked (finite, 0 <= nnz <= n,
     0 < coverage <= 1, DSAR wire bytes summing to the plan's); on the
     small model, both executors' rows on the card against the CPU
     path's on the same gradients;
 12. NCCL: a one-process NCCL group (world size 1) runs 2 synchronous and
     2 pipelined per-rank steps of the small model, bit-equal to the
     same steps over StackedCollectives(1);
 13. observability and the adaptive loop on the pipelined lm-100m step
     (stacked, K = 4, depth 2): 12 steps with observability off and on
     (trace, metrics, drift auditor, health rules, telemetry rows) from
     one state, bit-equal losses, exactly one host wait a retired unit
     (a counter on the driver's wait) and no synchronising call flagged
     (CUDA sync debug mode); the exported trace (span tree valid; dispatch
     and retire spans; the derived device phases) and metrics JSONL (each
     of the 26 EF buckets' four histograms with one sample a step) and
     the health summary; the calibration on the stacked ranks (alpha,
     bandwidth, the ladder and its residuals, its time); a forced swap
     (every EF bucket demoted to dense after step 8, installed at the
     drain barrier of step 12) bit-equal to both plans' steps built by
     hand and switched there, with the launches on each side (no pack or
     unpack after it, bucket_scatter_sum still one a step), the step
     time on each side and the new step's build time; 24 steps of the
     default AdaptConfig on the calibrated parameters (swaps and adapt/*
     events printed); the drift audit of the plan it ended on; and the
     pipelined step with observability on and off in turns, 3 rounds
     each (printed, not gated);
 14. the ZeRO layouts at lm-100m (full width and depth, R = 4, DSAR +
     QSGD-4; phases 3-13 already run ZeRO-1, the default): 6 synchronous
     steps with zero1=True and zero1=False, bit-equal (losses, params,
     residuals), timed in turns, each with its peak memory; the scattered
     output mode, 6 synchronous and 12 pipelined steps (K = 4, depth 2),
     against the replicated ZeRO-1 run within the reference's tolerances
     (losses rtol 1e-5, params rtol 1e-3 atol 1e-4; bit-equality
     printed), with 26 / 1 / 1 / 1 launches a step; the scattered reduce
     half's grouped unpack segments (the chunk layout) held bit for bit
     against qsgd_unpack_grouped_ref and timed beside its bound; a
     checkpoint of each layout at step 2 (its size and save time), at
     lm-100m's widths and 2 of its 12 layers, resumed under the other
     layout (the Trainer's CRC checks and the conversion timed) and
     continued 2 steps bit-equal to the uninterrupted run (checkpoints in
     a temporary directory the phase removes);
 15. faults at lm-100m (full width and depth, ZeRO-1): one NaN step
     through the kernels on both lowerings leaves params, moments,
     residuals and in-flight buffers bit-equal, with no host
     synchronisation inside it (CUDA sync debug mode); the driver's
     recovery matrix at lm-100m's widths and 2 of its 12 layers (its
     checkpoints' saves and restores were most of the phase's time)
     (guarded, injectable step at staleness 0, 6 steps,
     one checkpoint before the fault, two where a corrupted save needs an
     older one; each restore the newest checkpoint whose CRCs verify as
     it is read, one read, as Trainer restores): nonfinite with repeat =
     max_consecutive_nonfinite (escalation, rewind), a collective raise,
     a corrupted save then a collective raise (falls back to the older
     checkpoint), each ending
     bit-equal to the clean run; a straggler and a stall (wall time
     only); every run's events name exactly its planned faults, restarts
     and restores; the pipelined step with an idle injector and with none
     in turns; SIGTERM in a child process (lm-100m's widths at 2 of its
     12 layers), which must die by the signal with its blackbox written;
 16. serving lm-100m (12 layers, d = 768, random weights from seed 0)
     through the port's entry points, with every kernel's launch count
     reset before and read after (no TPU kernel lies on this path):
     ServeEngine.generate of 8 prompts of 128 tokens, 64 new tokens, cache
     1024, twice (the rerun bit-equal; tok/s of each), the prefill timed
     with CUDA events and 63 decode steps one at a time; a step with its
     read-back either way (the greedy tokens taken on the device, or the
     logits copied to the host and np.argmax there, as the reference
     does), 20 steps each in turns (2 rounds) and 40 of each profiled;
     the kernels
     a decode step (10 profiled steps); then
     ContinuousServeEngine.run over 8 slots, cache 1024, of 32 requests
     (Poisson arrivals at 0.5 a decode step, seed 0; prompts of 16-512
     and 32-128 new tokens from numpy.random.default_rng(0)), twice (the
     first run's admissions are first calls at each prompt length, the
     second's the steady state; traced spans give the admission and
     decode-step times): tok/s, the median decode step, TTFT, TPOT and
     e2e p50/p99 in decode steps and in ms, peak memory (all, and above
     what the earlier phases still hold); the second run goes under
     CUDA sync debug mode, which must flag exactly one host
     synchronisation a decode step (and one an admission); each request
     against its own B = 1 generate, token for token, where a differing
     token fails unless the B = 1 run's top-2 logit gap there is below
     1e-4 (printed either way); the card's idle share over the last 20
     of 40 profiled decode steps; a chaos run (three collective raises
     before decode ticks, FaultPlan.chaos seed 0) with the unfaulted
     outputs and the three planned recovery/serve_retry events; a
     queue_limit 2 run that serves or sheds each request exactly once,
     the served ones unchanged; lm-100m at 2 layers on the card against
     the CPU on the same weights (teacher-forced logits within rtol
     1e-5 and a floor of 1e-5 of the largest, greedy tokens by the margin
     rule); the activation exchange at p = 2 and 4, T = 8, d = 768 (the
     row-stream path bit-equal to dense, stacked and per rank; a row
     stream's round trip bit for bit and its clamp over capacity; the
     serve-plan audit on a calibrated network);
 17. the MoE family, moonshot-v1-16b-a3b at its published widths (d =
     2048, 16 heads of 128, 64 experts top-6 of width 1408, a shared
     expert of 2816, vocab 163840; random weights from a seed), with every
     kernel's launch count reset before each run and read after:
     17a: Trainer.run at 1 layer of 48, bf16 as published, under its
     train_config (DSAR + 4-bit QSGD, k = 4 of 512, ZeRO-1, 4
     microbatches), one 512-token row a rank a microbatch (C = 64), R = 2
     stacked replicas (R = 4 does not fit the card), under expandable
     allocator segments (without them the pool fragments and the run
     runs out of memory), 4 steps: finite losses, one
     bucket_topk launch a sparse bucket a step and one grouped call each
     of the fused densify + sum, the pack and the unpack (a grouped call
     launches one kernel for every 64, 48 and 48 of its hundreds of
     buckets); 2 more steps
     timed with CUDA events, the rank grads and the reduce half alone;
     on one step's tensors, every 64th bucket_topk input and the largest,
     and every segment of the three grouped launches, held against the
     plain versions (bit-equal; the pack's 'l2' codes at most one level on
     at most 1e-4 of them); the peak memory allocated and reserved against
     the card's, the state's size and each half's peak. 17b: serving at 4
     layers of 48 in
     f32, the expert combine over 2 stacked shards: ServeEngine.generate
     of 8 prompts of 128 tokens, 32 new, cache 1024, twice (bit-equal), the
     prefill and 31 decode steps timed (CUDA events) beside the decode
     step's bound with every weight read once (all 64 experts at C = 8,
     the whole cache) and the bound of what the steps' data needs (the
     distinct experts the router picked in each layer, read from a replay
     of the same steps, and the filled cache positions), the
     kernels of 10 profiled decode steps; ContinuousServeEngine over 8
     slots on the first 16 of phase 16's requests, dense twice (the rerun
     bit-equal; traced spans give the decode-step and admission times) and
     adaptive on network parameters calibrated on the stacked shards,
     under CUDA sync debug mode (exactly one host synchronisation a decode
     step), its tokens equal to dense's and some of its steps on the
     row-stream wire; the wire bytes and the swap log; a dense engine
     pinned to the row-stream plan on the first 4 requests (never more
     live than the stream's capacity), every step on the stream, tokens
     equal to dense's;
     each request against its own B = 1 generate (phase 16's margin rule);
     the idle share over the last 20 of 40 profiled decode steps; peak
     memory; moe_apply on 512 tokens twice, bit-equal. 17c: moonshot's
     smoke config (f32) on the card against the CPU: forward logits and a
     prefill + 8 decode steps (rtol 1e-5, floor 1e-5 of the largest), 3
     SparCML steps with the same QSGD bits (the first at lr 0; losses
     within rtol 2e-4, the final params, moments and EF residuals within
     rtol 2e-4 and 2e-4 of each tensor's largest magnitude), and
     moe_apply twice on the card, bit-equal;
 18. the ssm, hybrid, vlm and encoder families at their published widths
     (random weights from a seed), every kernel's launch count reset
     before each run and read after: 18a: mamba2-370m at full width and
     depth (48 layers, d = 1024, 32 SSM heads of 64, state 128, chunk
     256, vocab 50280), bf16, Trainer.run under its train_config (DSAR +
     4-bit QSGD, k = 4 of 512, ZeRO-1, 16 microbatches, remat on), R = 4
     stacked, one 512-token row a rank a microbatch, 3 steps: finite
     losses, launches a step, step times, peak memory beside the state's
     size, the rank grads and the reduce half alone, each kernel against
     its plain version on one step's tensors (17a's rules); 18b: serving
     it at full width and depth in bf16: ServeEngine.generate of 8 x
     256-token prompts, 32 new, twice (bit-equal), the prefill and each
     decode step timed beside the step's bound (the weights and 8 slots'
     SSM states), 10 profiled steps (kernels, idle share);
     ContinuousServeEngine over 8 slots, cache 1024, 16 requests
     (Poisson 0.5 a step, prompts of 256 or 512 tokens, whole SSD chunks,
     32-128 new), traced, then again under CUDA sync debug mode (exactly
     one host synchronisation a decode step), each request against its
     B = 1 generate (phase 16's margin rule); 18c: zamba2-2.7b at full
     width, 6 layers of 54 (1 superblock, for the smoke's time; the
     shared block's gradient over two call sites is 18f's smoke
     config, card against CPU), as 18a for 3 steps at R = 4 (R =
     2 if R = 4 peaks above 70 GB or runs out of memory, the reason
     recorded), then
     18b's requests served continuously, each against its B = 1
     generate; 18d: llama-3.2-vision-11b at full width, 5 layers of 40 (4
     self-attention layers and one gated cross-attention layer, the gates
     opened), bf16: static serving of 8 x 128-token prompts with 1600 x
     1280 image embeddings, 32 new, as 18b's static run, and other image
     embeddings must change the tokens; 18e: hubert-xlarge at full width,
     12 layers of 48, as 18a for 3 steps on 512-frame rows; 18f: each
     family's smoke config (f32) on the card against the CPU: logits (and
     a prefill + 8 decode steps), 3 SparCML steps with the same QSGD bits
     (losses within rtol 2e-4; the final params, moments and EF residuals
     within rtol 2e-4 and 2e-4 of each tensor's largest magnitude), and
     remat on against off through rank_grads on the card, bit-equal;
 19. long-sequence training, the chunked attention's recomputing
     backward and the dry run: 19a: the chunked attention
     (layers.flash_attention, the GQA repeat outside it) against the
     plain path's autograd on the same q, k, v, forward and the three
     gradients, at qwen3-4b's widths (32 heads of 128, kv 8), S = 4096,
     causal, in bf16 and f32, at hubert-xlarge's (16 heads of 80)
     non-causal at S = 2048 in f32, and with a 1024-key sliding window at
     S = 4096 in bf16 (tolerances by dtype at LONG_ATTN_TOL; in bf16 the
     chunked path's error against an f32 computation must also stay
     within 1.5x the plain path's), each path's time (CUDA events) and
     peak memory; 19b: qwen3-4b at full width, 2 layers of 36, bf16,
     Trainer.run under its train_config (DSAR + 4-bit QSGD, k = 4 of 512,
     ZeRO-1, 8 microbatches, remat on), R = 2 stacked, one 4096-token
     row a rank a microbatch (65,536 tokens a step), 3 steps, as 18a
     (finite losses, launches a step, step times, peaks, each kernel
     against its plain version on one step's tensors), then two steps
     with the chunked path forced off (the module's threshold raised),
     its peak beside the chunked one (running out of memory recorded);
     19c: launch.dryrun.run_cell of qwen3-4b train_4k at 2 layers and R
     = 2 on the meta device: its state (without the in-flight buffers
     Trainer.run does not hold) within 5 % of the bytes init_or_resume
     allocated, and the measured step's share of the bound of its own
     shape (dryrun.train_cost; the unfused eager ops' bound, whose memory
     term counts every op's operands and results, and its compute term
     alone) and its model-FLOP share of the bf16 peak (printed);
 20. one rank a process, finished: fsdp (ZeRO-3), and checkpoints and
     chaos over a process group, every kernel's launch count reset
     before each run and read after: 20a: dbrx-132b's own train_config
     (dense sync, fsdp, bf16 moments, 8 microbatches) at its published
     widths (d = 6144, 16 experts of 10752, vocab 100352), 1 layer of 40,
     one 4096-token row a microbatch (2048, then 1024, where the dry
     run's peak estimate does not fit or the card runs out of memory,
     then qwen3-4b at 2 layers under the dry run's dense override;
     recorded under "reduced"), 3 steps over a one-process NCCL group,
     bit-equal to the same 3 steps over StackedCollectives(1) (two
     64-bit sums of each state tensor's words, one position-weighted,
     taken on the card), the step time and the peak
     memory allocated and reserved beside the fsdp-aware dry run's
     estimate of the same cell (dryrun.train_cost); 20b: lm-100m, dense
     sync, fsdp over StackedCollectives(4), 3 steps, within rtol 1e-5
     and a floor of 1e-5 of each tensor's largest magnitude of the
     replicated dense step (losses and gathered params), the time a
     step; 20c: lm-100m's widths at 2 of its 12 layers, SparCML, over
     the NCCL world of 1: a Trainer with ckpt_dir writes the arrays the
     stacked run's checkpoint holds, and a fresh process-group Trainer
     resumed from it runs on bit-equal to the stacked run; then run_lm
     --lowering manual --pipeline --chaos 4 (30 steps, its checkpoints
     every 10) in this process under torchrun's variables for a world of
     1, which must end with exactly its planned faults, one
     restart a planned collective raise, the corrupted save skipped
     once, and the four kernels launched ("launches_fsdp_restore": the
     two paths' counts);
 22. run before the kernels line (21), which stays last: 22a, the main
     path under algorithm="auto": lm-100m as phases 3-5 run it (12
     layers, d = 768, f32, R = 4, k = 8 of 512, QSGD-4) with the
     algorithm left at "auto", the Trainer fitting the network on the
     stacked ranks (alpha, bandwidth and the buckets by algorithm
     printed), 3 steps through the kernels with each kernel's launches
     equal to the resolved plan's (a bucket_topk an EF bucket, a grouped
     densify + sum for every 64, a grouped pack and unpack for every 48
     quantized DSAR buckets) and the median step, bit-equal (losses,
     params, EF residuals) to the same steps with the resolved algorithm
     named; then make_sparse_allreduce("auto") at Fig. 3's shapes (N =
     2^24, P = 8, k = 4 and 64) on a fit over its 8 stacked ranks: the
     algorithm it picks, its time, the sum against the exact f64 sum as
     phase 7 checks it; 22b, serving with fsdp: llama3-405b at its
     published widths (d = 16384, 128 heads of 128, kv 8, d_ff 53248,
     vocab 128256), 2 of its 126 layers, random bf16 weights from a
     seed: a prefill of 8 prompts of 128 tokens and 16 greedy decode
     steps at cache 2048 with the params replicated, as fsdp shards over
     2 stacked ranks and over a one-process NCCL group (a world of 1
     takes the stacked branches: the per-process row split runs only in
     the CPU's gloo world of 2), logits and tokens bit-equal across the
     three; each form's decode step (CUDA events, median of 16) and peak
     above what it holds, beside the dry run's one gathered layer
     ("launches_auto" and "launches_serve_fsdp" in the kernels line);
 21. the kernels line (a kernel's "launches" are the main path's, or,
     for one the main path does not run, those of the first later path
     that runs it, named in "launches_path"; "launches_moe_train" and
     "launches_moe_serve" those of phase 17's runs, "launches_ssm_train",
     "launches_hybrid_train", "launches_encoder_train" and
     "launches_ssm_serve" those of phase 18's, "launches_long_train"
     phase 19b's, "launches_fsdp_restore" phase 20c's), the card line,
     and last the result line {"ok": true, "device": {...}}.

It imports torch and the port (``src/repro_torch``), never JAX. A longer
record of the run goes to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
STEPS = 6
REPS = 5
K_UNIT = 4           # superstep of the pipelined runs, as the example's
PIPE_STEPS = 12      # pipelined steps after phase 3's synchronous ones
RACE_STEPS = 8
OBS_STEPS = 12       # phase 13: observability off / on, from one state
SWAP_AT = 8          # phase 13: the demotion after the unit ending here,
SWAP_STEPS = 24      # installed at the next drain barrier (step 12)
NATURAL_STEPS = 24   # phase 13: the adaptive loop, default AdaptConfig
COST_STEPS = 16      # phase 13: observability on / off in turns,
COST_ROUNDS = 3      # this many rounds of each

# bucket_topk's k sweep: (rows, B, k); the Fig. 3 rows, then B = 1024
TOPK_SWEEP = tuple((262144, 512, k) for k in (1, 4, 8, 16, 32, 64, 128, 512)
                   ) + ((131072, 1024, 16), (131072, 1024, 128))
# its B sweep: the bucket sizes beyond the main path's, 2^26 entries each
TOPK_B_SWEEP = tuple((2**26 // b, b, k) for b in (384, 640, 2048, 4096, 8192)
                     for k in sorted({1, 8, b // 64, b // 2, b}))
TOPK_ADVERSARIAL_B = (128, 256, 384, 512, 640, 1024, 2048, 4096, 8192)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks_for(name: str) -> tuple[float, float]:
    """The card's published memory bytes/s and f32 (non-tensor) FLOP/s,
    from the port's one table of peaks (``repro_torch.utils.roofline``);
    an unknown card is refused rather than measured against the wrong
    roofline."""
    from repro_torch.utils import roofline

    try:
        peaks = roofline.peaks_for(name)
    except KeyError as exc:
        fail(str(exc))
    return peaks.hbm, peaks.f32


def time_ms(torch, fn, reps: int = REPS) -> float:
    """Median over ``reps`` runs of CUDA-event time of fn() (after one
    warm-up run)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def host_ms(torch, fn, reps: int = REPS) -> float:
    """Median host-clock time fn() takes to return (to enqueue its work),
    starting each run with the card idle."""
    out = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out[1:])


def graph_ms(torch, fn, replays: int = 10) -> float:
    """CUDA-event time of fn()'s work replayed from a CUDA graph, ``replays``
    times back to back, per replay: the device's time without the host's."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(torch, lambda: [graph.replay() for _ in range(replays)])
    del graph
    return ms / replays


def steady_ms(times) -> tuple[float, list]:
    """ms a step of a pipelined run of K-step units, from the units'
    retire intervals (each step time is its unit's / K). The host runs
    only as far ahead as the launch queue lets it, so the first interval
    holds the fill (the first unit and most of the second) and the last
    one only the drain; the median of the units between them is the
    steady state. Returns (ms a step, the units' intervals in ms)."""
    units = [times[i] * K_UNIT * 1e3 for i in range(0, len(times), K_UNIT)]
    return statistics.median(units[1:-1]) / K_UNIT, units


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    import torch

    card = f"{torch.cuda.get_device_name(0)}, power limit not read"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            card = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired) as exc:
        card += f" ({exc})"
    return card


def lm_sparse_buckets():
    """lm-100m's sparse buckets and its sync config: the main path's
    kernel shapes."""
    from repro_torch.models.model import build_model
    from repro_torch.train import run_lm
    from repro_torch.train.train_step import build_plan

    cfg, _ = run_lm.lm_config(fast=False)
    tcfg = run_lm.train_config(STEPS)
    plan = build_plan(build_model(cfg), tcfg, run_lm.DP)
    return [bk for bk in plan.buckets if bk.sparse], tcfg.sync


def topk_inputs(torch, dev, sparse, r, b):
    """bucket_topk's inputs at the main path's shapes, one (R * rows *
    cols / B, B) tensor a bucket, normal values with magnitude ties in
    every 7th row and all-zero rows; and the generator, to draw on."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    xs = []
    for bk in sparse:
        x = torch.randn((r * bk.rows * (bk.cols // b), b), device=dev,
                        generator=gen)
        x[::7] = torch.round(x[::7] * 4) / 4          # magnitude ties
        x[::101] = 0.0                                # all-zero buckets
        xs.append(x)
    return xs, gen


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail("src/repro_torch not found next to chip_smoke.py: run it from "
             "a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.bucket_scatter import ops as scatter_ops
    from repro_torch.kernels.bucket_scatter.ref import ScatterSumSegment
    from repro_torch.kernels.bucket_topk import ops as topk_ops
    from repro_torch.kernels.qsgd_pack import ops as pack_ops
    from repro_torch.kernels.qsgd_pack.ref import (PackSegment, pack_rows,
                                                   u32_to_i64)
    from repro_torch.kernels.qsgd_unpack import ops as unpack_ops
    from repro_torch.kernels.qsgd_unpack.ref import (UnpackSegment,
                                                     qsgd_unpack_ref)
    from repro_torch.core.qsgd import random_bits
    from repro_torch.train import run_classify
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import build_model
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.comm.executor import reduce_buckets_spmd
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.runtime.driver import DriverConfig, run_pipelined
    from repro_torch.runtime.pipeline import attach_inflight, build_superstep
    from repro_torch.train import run_lm
    from repro_torch.train import train_step as ts
    from repro_torch.train.train_step import init_state
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_leaves

    record: dict = {}
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- 0
    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    bw, f32_peak = peaks_for(name)
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[0] card: {card} (peaks used: {bw / 1e12:.2f} TB/s, "
        f"{f32_peak / 1e12:.0f} TFLOP/s f32)")
    record["env"] = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "card": card, "bw": bw, "f32_peak": f32_peak}

    # ---------------------------------------------------------------- 1
    _build.lib()
    info = dict(_build.build_info)
    log(f"[1] build: {info['seconds']:.1f} s (cached={info['cached']})")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or line.startswith("=="):
            log(f"[1]   {line.strip()}")
    record["build"] = info

    # ---------------------------------------------------------------- 2
    sparse, sync = lm_sparse_buckets()
    r, b, k = run_lm.DP, sync.bucket_size, sync.k_per_bucket
    bq, bits = sync.qsgd_bucket, sync.qsgd_bits
    if len(sparse) != 26:
        fail(f"lm-100m plan has {len(sparse)} sparse buckets, expected 26")
    big = max(range(len(sparse)), key=lambda i: sparse[i].n)
    log(f"[2] {len(sparse)} sparse buckets; largest {sparse[big].name} "
        f"({sparse[big].rows} x {sparse[big].cols}) = "
        f"{sparse[big].n / sum(bk.n for bk in sparse):.1%} of the entries")

    xs, gen = topk_inputs(torch, dev, sparse, r, b)
    n_top = sum(x.numel() for x in xs)
    rows_top = sum(x.shape[0] for x in xs)
    kernels = []

    def entry(kname, route_src, replaces, checked, ms_step, plain_step,
              lib_step, nbytes, nops, err, ms_big, plain_big, **extra):
        t_bytes = nbytes / bw * 1e3
        t_ops = nops / f32_peak * 1e3
        row = {"name": kname, "route": "cuda", "source": route_src,
               "replaces": replaces, "launches": None, "max_abs_err": err,
               "ms": ms_step, "plain_ms": plain_step,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_step, "checked_by": checked,
               "launches_per_step": len(sparse),
               "largest_bucket": {"name": sparse[big].name, "ms": ms_big,
                                  "plain_ms": plain_big}}
        row.update(extra)
        kernels.append(row)
        log(json.dumps({"kernel": kname, "kernel_ms": ms_step,
                        "plain_ms": plain_step, "library_ms": lib_step,
                        "bound_ms": row["bound_ms"],
                        "device_ms": extra.get("device_ms"),
                        "host_ms": extra.get("host_ms"),
                        "g4b0_kernel_ms": ms_big, "g4b0_plain_ms": plain_big,
                        "max_abs_err": err}))

    # -- bucket_topk: bit-equal with ties injected
    outs = [topk_ops.bucket_topk(x, k, impl="cuda") for x in xs]
    for x, got in zip(xs, outs):
        want = topk_ops.bucket_topk(x, k, impl="ref")
        for g_, w_ in zip(got, want):
            if not torch.equal(g_, w_):
                fail("bucket_topk kernel differs from its plain version")
        del want
    entry("bucket_topk", "src/repro_torch/csrc/bucket_topk.cu",
          "src/repro/kernels/bucket_topk/kernel.py:47",
          "phase 2: bit-equal to bucket_topk_ref on the 26 bucket shapes, "
          "ties injected",
          time_ms(torch, lambda: [topk_ops.bucket_topk(x, k, impl="cuda")
                                  for x in xs]),
          time_ms(torch, lambda: [topk_ops.bucket_topk(x, k, impl="ref")
                                  for x in xs], reps=3),
          time_ms(torch, lambda: [torch.topk(x.abs(), k, dim=1)
                                  for x in xs]),
          8 * n_top + 8 * rows_top * k, rows_top * b, 0.0,
          time_ms(torch, lambda: topk_ops.bucket_topk(xs[big], k,
                                                      impl="cuda")),
          time_ms(torch, lambda: topk_ops.bucket_topk(xs[big], k,
                                                      impl="ref"), reps=3),
          device_ms=graph_ms(torch, lambda: [
              topk_ops.bucket_topk(x, k, impl="cuda") for x in xs]),
          host_ms=host_ms(torch, lambda: [
              topk_ops.bucket_topk(x, k, impl="cuda") for x in xs]))
    streams = [(o[1], o[0]) for o in outs]   # (lidx, val) of the path
    del outs
    gc.collect()

    # -- bucket_scatter (one source): bit-equal on the path's (distinct)
    #    indices, and with duplicates and sentinels
    dens = [scatter_ops.bucket_scatter(li, va, b, impl="cuda")
            for li, va in streams]
    for (li, va), got in zip(streams, dens):
        if not torch.equal(got, scatter_ops.bucket_scatter(li, va, b,
                                                           impl="ref")):
            fail("bucket_scatter kernel differs from its plain version")
    del dens
    li, va = streams[big]
    dup = torch.randint(-2, 24, li.shape, dtype=torch.int32, device=dev,
                        generator=gen)
    dup[dup >= 16] = b + 3
    if not torch.equal(scatter_ops.bucket_scatter(dup, va, b, impl="cuda"),
                       scatter_ops.bucket_scatter(dup, va, b, impl="ref")):
        fail("bucket_scatter with duplicates and sentinels differs from its "
             "plain version")
    idx64 = [li_.to(torch.int64) for li_, _ in streams]
    lib_out = [torch.empty((li_.shape[0], b), device=dev) for li_, _ in streams]

    def lib_scatter():
        for o, ix, (_, va_) in zip(lib_out, idx64, streams):
            o.zero_().scatter_add_(1, ix, va_)

    entry("bucket_scatter", "src/repro_torch/csrc/bucket_scatter.cu",
          "src/repro/kernels/bucket_scatter/kernel.py:29",
          "phase 2: bit-equal to bucket_scatter_ref on the path's streams "
          "(26 buckets) and with duplicates + sentinels",
          time_ms(torch, lambda: [scatter_ops.bucket_scatter(
              li_, va_, b, impl="cuda") for li_, va_ in streams]),
          time_ms(torch, lambda: [scatter_ops.bucket_scatter(
              li_, va_, b, impl="ref") for li_, va_ in streams], reps=3),
          time_ms(torch, lib_scatter),
          4 * n_top + 8 * rows_top * k, rows_top * k, 0.0,
          time_ms(torch, lambda: scatter_ops.bucket_scatter(
              *streams[big], b, impl="cuda")),
          time_ms(torch, lambda: scatter_ops.bucket_scatter(
              *streams[big], b, impl="ref"), reps=3),
          device_ms=graph_ms(torch, lambda: [scatter_ops.bucket_scatter(
              li_, va_, b, impl="cuda") for li_, va_ in streams]),
          host_ms=host_ms(torch, lambda: [scatter_ops.bucket_scatter(
              li_, va_, b, impl="cuda") for li_, va_ in streams]))
    del lib_out, idx64
    gc.collect()

    # -- bucket_scatter_sum: the executor's one grouped launch a step (G =
    #    p_pod = 1, S = R ranks), bit-equal on the path's streams, and with
    #    duplicates and sentinels; beside one scatter_add_ a bucket into a
    #    zeroed (G, nb, B) with the R ranks' indices side by side
    ssegs = [ScatterSumSegment(li_.view(1, r, -1, k), va_.view(1, r, -1, k), b)
             for li_, va_ in streams]
    sums = scatter_ops.bucket_scatter_sum_grouped(ssegs, impl="cuda")
    for sg, got in zip(ssegs, sums):
        if not torch.equal(got, scatter_ops.bucket_scatter_sum(
                *sg, impl="ref")):
            fail("bucket_scatter_sum differs from its plain version")
    dseg = ssegs[big]._replace(lidx=dup.view(1, r, -1, k))
    if not torch.equal(scatter_ops.bucket_scatter_sum(*dseg, impl="cuda"),
                       scatter_ops.bucket_scatter_sum(*dseg, impl="ref")):
        fail("bucket_scatter_sum with duplicates and sentinels differs from "
             "its plain version")
    del dseg
    n_sum = n_top // r                       # the pod sums' entries
    side = [(sg.lidx.permute(0, 2, 1, 3).reshape(1, -1, r * k).to(torch.int64),
             sg.val.permute(0, 2, 1, 3).reshape(1, -1, r * k))
            for sg in ssegs]
    lib_sum = [torch.empty(g_.shape, device=dev) for g_ in sums]

    def lib_scatter_sum():
        for o, (ix, va_) in zip(lib_sum, side):
            o.zero_().scatter_add_(2, ix, va_)

    grouped_sum = lambda: scatter_ops.bucket_scatter_sum_grouped(
        ssegs, impl="cuda")
    entry("bucket_scatter_sum", "src/repro_torch/csrc/bucket_scatter.cu",
          "src/repro/kernels/bucket_scatter/kernel.py:29",
          f"phase 2: the grouped launch bit-equal to bucket_scatter_sum_ref "
          f"(each rank densified, summed in rank order) on the path's "
          f"streams (26 buckets, G 1, S {r}), and with duplicates + "
          "sentinels",
          time_ms(torch, grouped_sum),
          time_ms(torch, lambda: scatter_ops.bucket_scatter_sum_grouped(
              ssegs, impl="ref"), reps=3),
          time_ms(torch, lib_scatter_sum),
          4 * n_sum + 8 * rows_top * k, rows_top * k, 0.0,
          time_ms(torch, lambda: scatter_ops.bucket_scatter_sum(
              *ssegs[big], impl="cuda")),
          time_ms(torch, lambda: scatter_ops.bucket_scatter_sum(
              *ssegs[big], impl="ref"), reps=3),
          launches_per_step=1,
          device_ms=graph_ms(torch, grouped_sum),
          host_ms=host_ms(torch, grouped_sum))
    del lib_sum, side, ssegs, streams, xs
    gc.collect()

    # -- qsgd_pack: the executor's one grouped launch a step, reading each
    #    bucket's pod sum where it lies ((1, rows, R*shard), the reference's
    #    transposed QSGD-row order); then the single-bucket API on
    #    contiguous copies of the same rows
    qr = [random_bits(sm.numel(), gen, dev) for sm in sums]
    psegs = [PackSegment(sm.view(1, bk.rows, bk.cols), rd, 1, r, bk.rows,
                         bk.cols // r, bq)
             for bk, sm, rd in zip(sparse, sums, qr)]
    n_q = n_sum
    rows_q = n_q // bq
    vpw = 32 // bits
    shifts = torch.arange(vpw, device=dev) * bits

    def codes(words):
        return (u32_to_i64(words)[..., None] >> shifts) & (2**bits - 1)

    got = pack_ops.qsgd_pack_grouped(psegs, bits, "max", impl="cuda")
    want = pack_ops.qsgd_pack_grouped(psegs, bits, "max", impl="ref")
    for (p, sc), (pr, scr) in zip(got, want):       # 'max': bit-equal
        if not (torch.equal(sc, scr)
                and torch.equal(p.view(torch.int32), pr.view(torch.int32))):
            fail("qsgd_pack ('max') differs from its plain version")
    mode = sync.qsgd_scale
    packs = pack_ops.qsgd_pack_grouped(psegs, bits, mode, impl="cuda")
    want = pack_ops.qsgd_pack_grouped(psegs, bits, mode, impl="ref")
    pack_err, flips, n_codes = 0.0, 0, 0
    for (p, sc), (pr, scr) in zip(packs, want):     # 'l2': the path's mode
        dc = (codes(p) - codes(pr)).abs()
        if int(dc.max()) > 1:
            fail(f"qsgd_pack ('{mode}') codes differ by more than one level")
        flips += int((dc > 0).sum())
        n_codes += dc.numel()
        pack_err = max(pack_err, float(
            (qsgd_unpack_ref(p, sc, bits) - qsgd_unpack_ref(pr, scr, bits))
            .abs().max()))
    if flips > 1e-4 * n_codes:
        fail(f"qsgd_pack ('{mode}'): {flips} of {n_codes} codes moved a level")
    del got, want, dc
    qx = [pack_rows(ps).contiguous() for ps in psegs]
    qrr = [rd.view(-1, bq) for rd in qr]
    for x, rd in zip(qx, qrr):                     # the single-bucket API
        p, sc = pack_ops.qsgd_pack(x, rd, bits, "max", impl="cuda")
        pr, scr = pack_ops.qsgd_pack(x, rd, bits, "max", impl="ref")
        if not (torch.equal(sc, scr)
                and torch.equal(p.view(torch.int32), pr.view(torch.int32))):
            fail("single-bucket qsgd_pack ('max') differs from its plain "
                 "version")
    singles = lambda: [pack_ops.qsgd_pack(x, rd, bits, mode, impl="cuda")
                       for x, rd in zip(qx, qrr)]
    single_bucket = {"ms": time_ms(torch, singles),
                     "device_ms": graph_ms(torch, singles),
                     "host_ms": host_ms(torch, singles),
                     "launches_per_step": len(sparse),
                     "what": "26 one-segment calls on contiguous copies of "
                             "the same QSGD rows"}
    grouped_pack = lambda: pack_ops.qsgd_pack_grouped(psegs, bits, mode,
                                                      impl="cuda")
    entry("qsgd_pack", "src/repro_torch/csrc/qsgd_pack.cu",
          "src/repro/kernels/qsgd_pack/kernel.py:46",
          "phase 2: the grouped launch on the path's pod sums read in place "
          "bit-equal to qsgd_pack_grouped_ref in 'max' mode; in "
          f"'{mode}' mode {flips} of {n_codes} codes one level apart (limit "
          "1e-4); the single-bucket API bit-equal in 'max' mode on every "
          "bucket",
          time_ms(torch, grouped_pack),
          time_ms(torch, lambda: pack_ops.qsgd_pack_grouped(
              psegs, bits, mode, impl="ref"), reps=3),
          None,
          8 * n_q + n_q * bits // 8 + 4 * rows_q, 6 * n_q, pack_err,
          time_ms(torch, lambda: pack_ops.qsgd_pack_grouped(
              psegs[big:big + 1], bits, mode, impl="cuda")),
          time_ms(torch, lambda: pack_ops.qsgd_pack_grouped(
              psegs[big:big + 1], bits, mode, impl="ref"), reps=3),
          launches_per_step=1,
          device_ms=graph_ms(torch, grouped_pack),
          host_ms=host_ms(torch, grouped_pack),
          single_bucket=single_bucket)
    del qx, qrr, singles, sums, psegs, qr
    gc.collect()
    # -- qsgd_unpack: the single-bucket API on the path's packed shards,
    #    then the grouped launch the executor makes, at its geometry
    for p, sc in packs:
        if not torch.equal(unpack_ops.qsgd_unpack(p, sc, bits, impl="cuda"),
                           unpack_ops.qsgd_unpack(p, sc, bits, impl="ref")):
            fail("qsgd_unpack kernel differs from its plain version")
    mean = 1.0 / r
    segs = [UnpackSegment(p, sc, 1, r, bk.rows, bk.cols // r, bq, mean)
            for bk, (p, sc) in zip(sparse, packs)]
    got = unpack_ops.qsgd_unpack_grouped(segs, bits, impl="cuda")
    want = unpack_ops.qsgd_unpack_grouped(segs, bits, impl="ref")
    for g_, w_ in zip(got, want):
        if not torch.equal(g_, w_):
            fail("grouped qsgd_unpack differs from its plain version")
    del got, want
    gc.collect()
    entry("qsgd_unpack", "src/repro_torch/csrc/qsgd_unpack.cu",
          "src/repro/kernels/qsgd_unpack/kernel.py:27",
          "phase 2: the grouped launch bit-equal to qsgd_unpack_grouped_ref "
          "on the 26 buckets at the executor's geometry (p_pod 1, p_data "
          f"{r}, shard = cols/{r}, bq {bq}, mean 1/{r}); the single-bucket "
          "API bit-equal to qsgd_unpack_ref on the path's packed shards",
          time_ms(torch, lambda: unpack_ops.qsgd_unpack_grouped(
              segs, bits, impl="cuda")),
          time_ms(torch, lambda: unpack_ops.qsgd_unpack_grouped(
              segs, bits, impl="ref"), reps=3),
          None,
          n_q * bits // 8 + 4 * rows_q + 4 * n_q, 2 * n_q, 0.0,
          time_ms(torch, lambda: unpack_ops.qsgd_unpack(*packs[big], bits,
                                                        impl="cuda")),
          time_ms(torch, lambda: unpack_ops.qsgd_unpack(*packs[big], bits,
                                                        impl="ref"), reps=3),
          launches_per_step=1,
          device_ms=graph_ms(torch, lambda: unpack_ops.qsgd_unpack_grouped(
              segs, bits, impl="cuda")),
          host_ms=host_ms(torch, lambda: unpack_ops.qsgd_unpack_grouped(
              segs, bits, impl="cuda")))
    # the loops' variables still hold the last bucket's tensors (gigabytes
    # at lm-100m): drop them before the paths' memory is measured
    del segs, packs, x, g_, w_, li, va, dup, rd, p, sc, pr, scr, gen
    gc.collect()
    torch.cuda.empty_cache()
    record["topk_sweep"] = phase_topk_sweep(torch, dev, bw, f32_peak)
    kernels[0]["k_sweep"] = [
        {key: row[key] for key in ("shape", "k", "ms", "device_ms",
                                   "bound_ms", "library_ms")}
        for row in record["topk_sweep"]["sweep"]]
    kernels[0]["b_sweep"] = [
        {key: row[key] for key in ("shape", "k", "ms", "device_ms",
                                   "bound_ms", "library_ms")}
        for row in record["topk_sweep"]["b_sweep"]]
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 3
    wrappers = {"bucket_topk": topk_ops.bucket_topk,
                "bucket_scatter": scatter_ops.bucket_scatter,
                "bucket_scatter_sum": scatter_ops.bucket_scatter_sum,
                "qsgd_pack": pack_ops.qsgd_pack,
                "qsgd_unpack": unpack_ops.qsgd_unpack,
                "qsgd_unpack_grouped": unpack_ops.qsgd_unpack_grouped}
    # a step: a bucket_topk a sparse bucket, then one grouped launch each
    # of the fused densify + sum, the pack and the unpack
    expect = {"bucket_topk": len(sparse) * STEPS,
              "bucket_scatter": 0,                  # the fused form instead
              "bucket_scatter_sum": STEPS,
              "qsgd_pack": STEPS,
              "qsgd_unpack": 0,                     # the grouped form instead
              "qsgd_unpack_grouped": STEPS}
    cfg, data = run_lm.lm_config(fast=False)
    log(f"[3] device memory in use before the main path: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    trainer = Trainer(build_model(cfg), run_lm.train_config(STEPS), data,
                      dp_total=run_lm.DP, device=dev)
    trainer.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    tlog = trainer.run(STEPS)
    launches = {n: w.launches for n, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(tlog.step_times[1:]) * 1e3
    log(f"[3] {cfg.name} sparcml DSAR+QSGD4 R={run_lm.DP}: losses "
        f"{[round(x, 5) for x in tlog.losses]}")
    log(f"[3] step times ms {[round(t * 1e3, 1) for t in tlog.step_times]}; "
        f"median of steps 2-{STEPS}: {step_ms:.1f} ms; peak memory "
        f"{peak_gb:.2f} GB; launches {launches}")
    if not all(math.isfinite(v) for v in tlog.losses):
        fail(f"non-finite losses {tlog.losses}")
    for n, c in launches.items():
        if c != expect[n]:
            fail(f"{n} launched {c} times in {STEPS} steps, expected "
                 f"{expect[n]}")
    for row in kernels:
        row["launches"] = launches[row["name"]]
        row["launches_path"] = "main (phase 3)"
        if row["name"] == "qsgd_unpack":
            row["launches"] = launches["qsgd_unpack_grouped"]
            row["single_bucket_launches"] = launches["qsgd_unpack"]
    record["main_path"] = {"losses": list(tlog.losses), "step_times_s":
                           list(tlog.step_times), "median_step_ms": step_ms,
                           "peak_memory_gb": peak_gb, "launches": launches}

    # -- the card's kernels over 3 more synchronous steps, from a trace
    scratch = ROOT / "chiprun_out"
    scratch.mkdir(exist_ok=True)
    shares = {"synchronous": stream_shares(
        torch, lambda: trainer.run(STEPS + 3), scratch)}
    log(f"[3] profiler, second half of 3 synchronous steps: "
        f"{shares['synchronous']}")

    # -- the pipelined runtime on the same trainer, as the example's
    #    --pipeline runs it after its synchronous probe
    pipe_expect = {n: c // STEPS * PIPE_STEPS for n, c in expect.items()}
    n_sync = len(tlog.step_times)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    alloc0 = torch.cuda.memory_stats()
    trainer.run_pipelined(trainer.state.step + PIPE_STEPS, staleness=1,
                          superstep=K_UNIT, depth=2)
    pipe_launches = {n: w.launches for n, w in wrappers.items()}
    torch.cuda.synchronize()
    pipe_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    alloc1 = torch.cuda.memory_stats()
    allocator = {k: alloc1.get(k, 0) - alloc0.get(k, 0) for k in (
        "num_alloc_retries", "num_device_alloc", "num_device_free",
        "num_sync_all_streams")}
    allocator["max_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    pipe_losses = tlog.losses[n_sync:]
    pipe_times = tlog.step_times[n_sync:]
    pipe_ms, units_ms = steady_ms(pipe_times)
    pipe_all_ms = sum(pipe_times) / len(pipe_times) * 1e3
    log(f"[3] pipelined (staleness 1, superstep {K_UNIT}, depth 2): losses "
        f"{[round(x, 5) for x in pipe_losses]}")
    log(f"[3] pipelined unit retire intervals ms "
        f"{[round(u, 1) for u in units_ms]}; ms a step (units between the "
        f"first and the last / {K_UNIT}): {pipe_ms:.1f}; all {PIPE_STEPS} "
        f"steps: {pipe_all_ms:.1f} ms a step; peak memory "
        f"{pipe_peak_gb:.2f} GB; launches {pipe_launches}; allocator "
        f"{allocator}")
    log(f"overlap win: sync {step_ms:.1f} ms/step -> pipelined "
        f"{pipe_ms:.1f} ms/step ({step_ms / pipe_ms:.2f}x, staleness=1, "
        f"superstep={K_UNIT}, depth=2)")
    if len(pipe_losses) != PIPE_STEPS or not all(
            math.isfinite(v) for v in pipe_losses):
        fail(f"pipelined run: losses {pipe_losses}")
    for n, c in pipe_launches.items():
        if c != pipe_expect[n]:
            fail(f"{n} launched {c} times in {PIPE_STEPS} pipelined steps, "
                 f"expected {pipe_expect[n]}")
    for row in kernels:
        row["launches_pipelined"] = pipe_launches[row["name"]]
        if row["name"] == "qsgd_unpack":
            row["launches_pipelined"] = pipe_launches["qsgd_unpack_grouped"]
            row["single_bucket_launches_pipelined"] = \
                pipe_launches["qsgd_unpack"]
    record["pipelined"] = {"losses": pipe_losses, "step_times_s": pipe_times,
                           "unit_retire_ms": units_ms, "ms_a_step": pipe_ms,
                           "ms_a_step_all": pipe_all_ms,
                           "sync_ms_a_step": step_ms,
                           "overlap_win": step_ms / pipe_ms,
                           "peak_memory_gb": pipe_peak_gb,
                           "allocator": allocator,
                           "launches": pipe_launches}

    # -- the synchronous step's phases, each alone on the device
    st = trainer.state
    tcfg3 = trainer.tcfg
    batch0 = ts.batch_to_device(synthetic_batch(data, 0), dev)
    grads = lambda: ts.rank_grads(trainer.model, st.params, batch0,
                                  run_lm.DP, tcfg3.microbatches)
    grads_ms = time_ms(torch, grads, reps=3)
    _, leaves_r = grads()
    rand0 = ts.StepBits(tcfg3.seed, 0, dev, run_lm.DP)
    reduce = lambda: reduce_buckets_spmd(trainer.plan, leaves_r,
                                         st.residuals, p_data=run_lm.DP,
                                         rand_fn=rand0, telemetry=False)
    reduce_ms = time_ms(torch, reduce, reps=3)
    reduced, new_res, _ = reduce()
    lr0 = torch.tensor(1e-4)
    update_ms = time_ms(torch, lambda: ts.optimizer_half(
        st, reduced, leaves_r, lr0, tcfg3, trainer.plan, None), reps=3)
    fin = ts.all_finite_leaves(leaves_r)
    guard_main_ms = time_ms(torch, lambda: (
        ts.all_finite_leaves(leaves_r),
        ts.guard_select(fin, st.params, st.params),
        ts.guard_select(fin, st.opt, st.opt)), reps=3)
    guard_side_ms = time_ms(torch, lambda: (
        ts.guard_select(fin, new_res, st.residuals),
        ts.guard_select(fin, reduced, reduced)), reps=3)
    split = {"grads_ms": grads_ms, "reduce_ms": reduce_ms,
             "apply_update_ms": update_ms, "guard_main_ms": guard_main_ms,
             "guard_side_ms": guard_side_ms}
    log(f"[3] phases alone (CUDA events): rank grads (vmap over "
        f"{run_lm.DP} ranks) {grads_ms:.1f} ms, reduce half {reduce_ms:.1f} "
        f"ms, apply + clip + AdamW {update_ms:.1f} ms; guard: finite check "
        f"+ select of params and moments {guard_main_ms:.1f} ms, select of "
        f"residuals and in-flight {guard_side_ms:.1f} ms")
    del leaves_r, reduced, new_res, fin, batch0, st
    gc.collect()

    record["phase_split"] = split
    del trainer, tlog
    gc.collect()
    torch.cuda.empty_cache()

    dense = Trainer(build_model(cfg), run_lm.train_config(STEPS, "dense"),
                    data, dp_total=run_lm.DP, device=dev)
    dense.init()
    dlog = dense.run(STEPS)
    dense_ms = statistics.median(dlog.step_times[1:]) * 1e3
    log(f"[3] dense comparison: losses {[round(x, 5) for x in dlog.losses]} "
        f"step times ms {[round(t * 1e3, 1) for t in dlog.step_times]}; "
        f"median of steps 2-{STEPS}: {dense_ms:.1f} ms")
    record["dense"] = {"losses": dlog.losses, "step_times_s": dlog.step_times,
                       "median_step_ms": dense_ms}
    del dense
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 4
    tiny = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=1024, vocab_size=512,
                       dtype=torch.float32, param_dtype=torch.float32,
                       max_seq_len=64)
    tiny_data = DataConfig(global_batch=8, seq_len=32, vocab_size=512)

    def bits_for(step, device):
        """The same QSGD bits on both devices: drawn on the CPU."""
        def rand_fn(bucket_idx, n):
            g = torch.Generator().manual_seed(step * 1000 + bucket_idx)
            return random_bits(n, g, "cpu").to(device)
        return rand_fn

    params0 = build_model(tiny).init(torch.Generator().manual_seed(7),
                                     device="cpu")
    small = {}
    for where in ("cpu", "cuda"):
        t = Trainer(build_model(tiny), run_lm.train_config(STEPS), tiny_data,
                    dp_total=run_lm.DP, device=where)
        if not any(bk.sparse for bk in t.plan.buckets):
            fail("small check: the plan has no sparse bucket")
        t.init(params=_to(params0, where))
        small[where] = t.run(3, rand_fn_for_step=lambda s, w=where:
                             bits_for(s, w)).losses
    rel = max(abs(a - c) / abs(c) for a, c in zip(small["cuda"], small["cpu"]))
    log(f"[4] small model, card vs CPU plain path: {small['cuda']} vs "
        f"{small['cpu']} (max rel diff {rel:.2e}, limit 2e-4)")
    if not rel <= 2e-4:
        fail("small-input check: card and CPU losses disagree")
    record["small_check"] = {"cuda": small["cuda"], "cpu": small["cpu"],
                             "max_rel": rel}

    # ---------------------------------------------------------------- 5
    race_tcfg = run_lm.train_config(RACE_STEPS)
    race_model = build_model(cfg)
    sup, race_plan = build_superstep(race_model, race_tcfg, run_lm.DP, dev,
                                     steps=K_UNIT, guard=True,
                                     telemetry=True)

    def fresh_state():
        return attach_inflight(init_state(race_model, race_tcfg, race_plan,
                                          dev), race_plan)

    def to_host(state, losses):
        return {"losses": list(losses),
                **{f: [t.cpu() for t in tree_leaves(getattr(state, f))]
                   for f in ("params", "residuals", "inflight")}}

    race_batch = lambda step: synthetic_batch(data, step)
    driven = {}

    def drive():
        driven["state"], driven["log"] = run_pipelined(
            sup, fresh_state(), start_step=0, num_steps=RACE_STEPS,
            batch_fn=race_batch,
            cfg=DriverConfig(depth=2, steps_per_unit=K_UNIT))

    shares["pipelined"] = stream_shares(torch, drive, scratch)
    log(f"[5] profiler, second half of the driver's {RACE_STEPS} pipelined "
        f"steps: {shares['pipelined']}")
    record["stream_shares"] = shares
    runs = {"driver": to_host(driven["state"], driven["log"].losses)}
    del driven
    syncs_in_step = []
    for run in ("sequential", "sequential again"):
        state, losses = fresh_state(), []
        for i in range(RACE_STEPS):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    state, m = sup.step(state, race_batch(i))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs_in_step += [str(w.message) for w in caught if
                              "called a synchronizing" in str(w.message)]
            torch.cuda.synchronize()
            losses.append(float(m["loss"]))
        runs[run] = to_host(state, losses)
        del state, m

    # -- the host's cost of one step: the same step at a batch so small
    #    that the card waits for the host, never the other way round
    small_batch = DataConfig(global_batch=8, seq_len=16,
                             vocab_size=data.vocab_size)
    state = fresh_state()
    for i in range(6):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = sup.step(state, synthetic_batch(small_batch, i))
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    host_step_ms = (t1 - t0) / 4 * 1e3
    host_wall_ms = (time.perf_counter() - t0) / 4 * 1e3
    del state, m
    log(f"[5] host enqueue of one pipelined step (lm-100m widths, global "
        f"batch 8 x 16): {host_step_ms:.1f} ms; with the card's tail "
        f"{host_wall_ms:.1f} ms")

    def diff(a, b):
        """(bit-equal?, max rel loss diff, max abs diff of the tensors
        over their own largest magnitude)."""
        rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                      b["losses"]))
        worst, same = 0.0, a["losses"] == b["losses"]
        for f in ("params", "residuals", "inflight"):
            for x, y in zip(a[f], b[f]):
                if not torch.equal(x, y):
                    same = False
                    scale = float(y.abs().max()) or 1.0
                    worst = max(worst, float((x - y).abs().max()) / scale)
        return same, rel, worst

    seq_same, seq_rel, seq_worst = diff(runs["sequential again"],
                                        runs["sequential"])
    race_same, race_rel, race_worst = diff(runs["driver"], runs["sequential"])
    log(f"[5] race check, lm-100m, {RACE_STEPS} staleness-1 steps: driver "
        f"losses {[round(x, 6) for x in runs['driver']['losses']]}")
    log(f"[5] driver vs sequential: bit-equal {race_same} (max rel loss diff "
        f"{race_rel:.2e}, max tensor diff / magnitude {race_worst:.2e}); "
        f"sequential run reproducible: {seq_same} ({seq_rel:.2e}, "
        f"{seq_worst:.2e}); host syncs inside a step: {len(syncs_in_step)}")
    record["race_check"] = {
        "losses": {k: r["losses"] for k, r in runs.items()},
        "bit_equal": race_same, "max_rel_loss": race_rel,
        "max_tensor_diff": race_worst, "sequential_reproducible": seq_same,
        "sequential_max_rel_loss": seq_rel,
        "sequential_max_tensor_diff": seq_worst,
        "syncs_in_step": syncs_in_step[:10],
        "host_enqueue_ms_a_step_small_batch": host_step_ms,
        "host_wall_ms_a_step_small_batch": host_wall_ms}
    del runs, sup
    gc.collect()
    torch.cuda.empty_cache()
    if syncs_in_step:
        fail(f"the pipelined step synchronised the host: {syncs_in_step[:3]}")
    if seq_same and not race_same:
        fail("race check: the driver's run differs from the sequential one")
    if not seq_same and not (race_rel <= 2e-4 and race_worst <= 2e-4):
        fail("race check: driver and sequential runs differ beyond rtol 2e-4")

    # ---------------------------------------------------------------- 6
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    small_tcfg = run_lm.train_config(STEPS)

    def small_trainer(where, **kw):
        t = Trainer(build_model(tiny), small_tcfg, tiny_data,
                    dp_total=run_lm.DP, device=where, **kw)
        t.init(params=_to(params0, where))
        return t

    def same_state(a, b):
        return a.step == b.step and all(
            torch.equal(x, y) for f in ("params", "opt", "residuals")
            for x, y in zip(tree_leaves(getattr(a, f)),
                            tree_leaves(getattr(b, f))))

    bits_cuda = lambda s: bits_for(s, "cuda")
    ta, tb = small_trainer(dev), small_trainer(dev)
    ta.run(3, rand_fn_for_step=bits_cuda)
    tb.run_pipelined(3, staleness=0, superstep=3, rand_fn_for_step=bits_cuda)
    stale0_same = ta.log.losses == tb.log.losses and same_state(ta.state,
                                                                tb.state)
    log(f"[6] small model, staleness-0 pipelined vs Trainer.run: bit-equal "
        f"{stale0_same} ({tb.log.losses} vs {ta.log.losses})")
    if not stale0_same:
        fail("staleness-0 pipelined run differs from Trainer.run")
    stale1 = {}
    for where in ("cpu", "cuda"):
        t = small_trainer(where)
        t.run_pipelined(3, staleness=1, superstep=1,
                        rand_fn_for_step=lambda s, w=where: bits_for(s, w))
        stale1[where] = t.log.losses
    rel1 = max(abs(a - c) / abs(c) for a, c in zip(stale1["cuda"],
                                                   stale1["cpu"]))
    log(f"[6] small model, staleness 1, card vs CPU path: {stale1['cuda']} "
        f"vs {stale1['cpu']} (max rel diff {rel1:.2e}, limit 2e-4)")
    if not rel1 <= 2e-4:
        fail("staleness-1 card and CPU losses disagree")
    with tempfile.TemporaryDirectory(dir=out_dir) as ckpt_dir:
        t1 = small_trainer(dev, ckpt_dir=ckpt_dir, ckpt_every=4)
        t1.run_pipelined(8, staleness=1, superstep=2,
                         rand_fn_for_step=bits_cuda)
        t2 = Trainer(build_model(tiny), small_tcfg, tiny_data,
                     dp_total=run_lm.DP, device=dev, ckpt_dir=ckpt_dir)
        resumed_at = t2.init_or_resume()
        resume_same = resumed_at == 8 and same_state(t1.state, t2.state)
    log(f"[6] small model, pipelined run with checkpoints -> fresh Trainer "
        f"resumed at step {resumed_at}: state bit-equal {resume_same}")
    if not resume_same:
        fail("checkpoint resume does not give back the pipelined run's state")
    record["small_runtime"] = {"staleness0_bit_equal": stale0_same,
                               "staleness1": stale1, "staleness1_max_rel": rel1,
                               "resumed_at": resumed_at,
                               "resume_bit_equal": resume_same}

    # ---------------------------------------------------------------- 7
    new_paths = {}
    record["fig3"], new_paths["fig3"] = phase_fig3(torch, dev, wrappers,
                                                   kernels, bw, f32_peak,
                                                   profile=scratch)
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 8
    record["manual_lm100m"], new_paths["manual_lm100m"], manual = \
        phase_manual(torch, dev, wrappers, record["main_path"])
    for row in kernels:
        if row["name"] == "qsgd_unpack":
            row["checked_by"] += (
                "; phase 8: the grouped launch bit-equal to "
                "qsgd_unpack_grouped_ref on one step's segments of the "
                "per-rank reduce half at lm-100m (row-major, p_pod 1, "
                f"p_data {run_lm.DP}, rows = held x r, shard = cols/"
                f"{run_lm.DP}, mean 1)")
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 9
    record["classify"], new_paths["classify"] = phase_classify(
        torch, dev, wrappers, run_classify)
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 10
    (record["manual_pipelined_lm100m"],
     new_paths["manual_pipelined_lm100m"]) = phase_manual_pipelined(
        torch, dev, wrappers, manual, record["pipelined"],
        record["manual_lm100m"]["median_step_ms"])
    for row in kernels:
        row["launches_pipelined_manual"] = new_paths[
            "manual_pipelined_lm100m"][row["name"]]
        if row["name"] == "qsgd_unpack":
            row["launches_pipelined_manual"] = new_paths[
                "manual_pipelined_lm100m"]["qsgd_unpack_grouped"]
            row["single_bucket_launches_pipelined_manual"] = new_paths[
                "manual_pipelined_lm100m"]["qsgd_unpack"]
    manual.state = None
    del manual
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 11
    record["telemetry"], new_paths["telemetry"] = phase_telemetry(
        torch, dev, wrappers, tiny, tiny_data, params0, bits_for)
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 12
    record["nccl"], new_paths["nccl"] = phase_nccl(
        torch, dev, wrappers, tiny, tiny_data, params0, bits_for)
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 13
    record["obs_adapt"], new_paths["obs_adapt"] = phase_obs_adapt(
        torch, dev, wrappers, out_dir)
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 14
    t_phase = time.perf_counter()
    record["zero"], new_paths["zero"] = phase_zero(torch, dev, wrappers,
                                                   out_dir, bw)
    record["zero"]["seconds"] = time.perf_counter() - t_phase
    for row in kernels:
        if row["name"] == "qsgd_unpack":
            row["chunk_layout"] = record["zero"]["chunk_unpack"]
            row["checked_by"] += (
                "; phase 14: the grouped launch bit-equal to "
                "qsgd_unpack_grouped_ref on one step's segments of the "
                "scattered stacked reduce half at lm-100m (chunk layout: "
                f"p_pod 1, p_data 1, rows = {run_lm.DP} x r, shard = "
                f"cols/{run_lm.DP}, mean 1/{run_lm.DP})")
    log(f"[14] phase took {record['zero']['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 15
    t_phase = time.perf_counter()
    record["faults"], new_paths["chaos"] = phase_faults(torch, dev, wrappers,
                                                        out_dir)
    record["faults"]["seconds"] = time.perf_counter() - t_phase
    log(f"[15] phase took {record['faults']['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 16
    t_phase = time.perf_counter()
    record["serve"], new_paths["serve"] = phase_serve(torch, dev, wrappers,
                                                      out_dir)
    record["serve"]["seconds"] = time.perf_counter() - t_phase
    log(f"[16] phase took {record['serve']['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 17
    t_phase = time.perf_counter()
    record["moe"], moe_paths = phase_moe(torch, dev, wrappers, out_dir, bw,
                                         f32_peak)
    new_paths.update(moe_paths)
    record["moe"]["seconds"] = time.perf_counter() - t_phase
    for row in kernels:
        grouped = "qsgd_unpack_grouped" if row["name"] == "qsgd_unpack" \
            else row["name"]
        row["launches_moe_train"] = moe_paths["moe_train"][grouped]
        row["launches_moe_serve"] = moe_paths["moe_serve"][grouped]
        if row["name"] in ("bucket_topk", "bucket_scatter_sum", "qsgd_pack",
                           "qsgd_unpack") and not row["launches_moe_train"]:
            fail(f"17a: {row['name']} was not launched on the MoE training "
                 "path")
    log(f"[17] phase took {record['moe']['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 18
    t_phase = time.perf_counter()
    record["families"], fam_paths = phase_families(torch, dev, wrappers,
                                                   out_dir, bw, f32_peak)
    new_paths.update(fam_paths)
    record["families"]["seconds"] = time.perf_counter() - t_phase
    for row in kernels:
        grouped = "qsgd_unpack_grouped" if row["name"] == "qsgd_unpack" \
            else row["name"]
        for path in ("ssm_train", "hybrid_train", "encoder_train",
                     "ssm_serve"):
            row[f"launches_{path}"] = fam_paths[path][grouped]
        if row["name"] in ("bucket_topk", "bucket_scatter_sum", "qsgd_pack",
                           "qsgd_unpack") and not row["launches_ssm_train"]:
            fail(f"18a: {row['name']} was not launched on the mamba2 "
                 "training path")
    log(f"[18] phase took {record['families']['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 19
    t_phase = time.perf_counter()
    record["long"], long_paths = phase_long(torch, dev, wrappers)
    new_paths.update(long_paths)
    record["long"]["seconds"] = time.perf_counter() - t_phase
    for row in kernels:
        grouped = "qsgd_unpack_grouped" if row["name"] == "qsgd_unpack" \
            else row["name"]
        row["launches_long_train"] = long_paths["long_train"][grouped]
        if row["name"] in ("bucket_topk", "bucket_scatter_sum", "qsgd_pack",
                           "qsgd_unpack") and not row["launches_long_train"]:
            fail(f"19b: {row['name']} was not launched on the long-sequence "
                 "training path")
    log(f"[19] phase took {record['long']['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 20
    t_phase = time.perf_counter()
    record["fsdp"], fsdp_paths = phase_fsdp(torch, dev, wrappers, out_dir)
    new_paths.update(fsdp_paths)
    record["fsdp"]["seconds"] = time.perf_counter() - t_phase
    for row in kernels:
        grouped = "qsgd_unpack_grouped" if row["name"] == "qsgd_unpack" \
            else row["name"]
        row["launches_fsdp_restore"] = {
            path: counts[grouped] for path, counts in fsdp_paths.items()}
        if row["name"] in ("bucket_topk", "bucket_scatter_sum", "qsgd_pack",
                           "qsgd_unpack") and not all(
                               row["launches_fsdp_restore"].values()):
            fail(f"20c: {row['name']} was not launched on the process-group "
                 "checkpoint and chaos paths")
    log(f"[20] phase took {record['fsdp']['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 22
    t_phase = time.perf_counter()
    record["auto_fsdp"], auto_paths = phase_auto_fsdp(torch, dev, wrappers,
                                                      out_dir)
    new_paths.update(auto_paths)
    record["auto_fsdp"]["seconds"] = time.perf_counter() - t_phase
    for row in kernels:
        grouped = "qsgd_unpack_grouped" if row["name"] == "qsgd_unpack" \
            else row["name"]
        row["launches_auto"] = {path: auto_paths[path][grouped]
                                for path in ("auto_main", "auto_fig3")}
        row["launches_serve_fsdp"] = auto_paths["serve_fsdp"][grouped]
        if row["name"] in ("bucket_topk", "bucket_scatter_sum", "qsgd_pack",
                           "qsgd_unpack") and not row["launches_auto"][
                               "auto_main"]:
            fail(f"22a: {row['name']} was not launched on the main path "
                 "under 'auto'")
    log(f"[22] phase took {record['auto_fsdp']['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 21
    for row in kernels:
        row["launches_new_paths"] = {
            path: counts[row["name"]] for path, counts in new_paths.items()}
        if row["name"] == "qsgd_unpack":
            row["grouped_launches_new_paths"] = {
                path: counts["qsgd_unpack_grouped"]
                for path, counts in new_paths.items()}
        if not row["launches"]:
            # a kernel the main path no longer runs (the single-source
            # densify): its launches are those of the first path that runs it
            ran = [(path, c) for path, c in row["launches_new_paths"].items()
                   if c]
            if not ran:
                fail(f"{row['name']} was launched on no path")
            row["launches_path"], row["launches"] = ran[0]
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def phase_topk_sweep(torch, dev, bw, f32_peak):
    """bucket_topk's k sweep and its adversarial rows (phase 2, see the
    module docstring). The bound counts each input byte read once and each
    output byte written once (x and res 8 bytes an entry, val and lidx 8
    a selected entry) and B operations a row."""
    from repro_torch.kernels.bucket_topk import ops as topk_ops
    from repro_torch.kernels.bucket_topk.cases import adversarial_rows

    def same_bits(got, want):
        return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want))

    rec = {"sweep": [], "b_sweep": []}
    gen = torch.Generator(device=dev).manual_seed(99)
    for n, b, k in TOPK_SWEEP + TOPK_B_SWEEP:
        x = torch.randn((n, b), device=dev, generator=gen)
        kern = lambda: topk_ops.bucket_topk(x, k, impl="cuda")
        if not same_bits(kern(), topk_ops.bucket_topk(x, k, impl="ref")):
            fail(f"bucket_topk at ({n}, {b}) k={k} differs from its plain "
                 "version")
        t_b = (8 * n * b + 8 * n * k) / bw * 1e3
        t_o = n * b / f32_peak * 1e3
        row = {"shape": [n, b], "k": k, "ms": time_ms(torch, kern),
               "device_ms": graph_ms(torch, kern),
               "library_ms": time_ms(torch, lambda: torch.topk(
                   x.abs(), k, dim=1)),
               "bound_ms": max(t_b, t_o),
               "bound_by": "bytes" if t_b >= t_o else "operations"}
        row["device_share_of_bound"] = row["bound_ms"] / row["device_ms"]
        # what the card reaches on the same bytes: x read, res written
        out = torch.empty_like(x)
        row["copy_device_ms"] = graph_ms(torch, lambda: out.copy_(x))
        rec["sweep" if (n, b, k) in TOPK_SWEEP else "b_sweep"].append(row)
        log(f"[2] bucket_topk ({n}, {b}) k={k}: bit-equal; {row['ms']:.4f} "
            f"ms, device alone {row['device_ms']:.4f} ms "
            f"({row['device_share_of_bound']:.0%} of the bound "
            f"{row['bound_ms']:.4f} ms, {row['bound_by']}); torch.topk "
            f"{row['library_ms']:.4f} ms; a copy of x, device alone "
            f"{row['copy_device_ms']:.4f} ms")
        del x, out
    cases = []
    for b in TOPK_ADVERSARIAL_B:
        sets = {nm: rows.to(dev) for nm, rows in
                adversarial_rows(64, b, seed=b).items()}
        for k in sorted({1, 4, 8, 64, max(1, b // 64), b // 2, b}):
            bad = [nm for nm, x in sets.items() if not same_bits(
                topk_ops.bucket_topk(x, k, impl="cuda"),
                topk_ops.bucket_topk(x, k, impl="ref"))]
            if bad:
                fail(f"bucket_topk B={b} k={k} differs from its plain "
                     f"version on the adversarial rows {bad}")
            cases.append([b, k])
    rec["adversarial"] = {"sets": list(sets), "rows_a_set": 64,
                          "cases_b_k": cases}
    log(f"[2] bucket_topk bit-equal to its plain version on the adversarial "
        f"rows {list(sets)} (64 rows each) at {len(cases)} (B, k) cases")
    return rec


def fig3_bounds(n, p, b, k, bits, bq, bw, f32_peak) -> dict:
    """Each kernel's least time at the Fig. 3 shapes (N = n per rank, p
    ranks stacked): the larger of its bytes (each input read once, each
    output written once) over the memory rate and its operations over the
    f32 peak, as phase 2 counts them."""
    rows = p * n // b                        # bucket rows of all ranks
    shard = n // p                           # an owner's range
    qn = p * shard                           # entries quantized (all owners)
    qrows = qn // bq

    def bound(nbytes, nops):
        t_b, t_o = nbytes / bw * 1e3, nops / f32_peak * 1e3
        return {"bound_ms": max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations"}

    return {
        # operations: the function's own, one look at each entry
        "bucket_topk": dict(shape=f"({rows}, {b}) k={k}", **bound(
            8 * p * n + 8 * rows * k, rows * b)),
        # the split phase's owner densify, one source at a time: every
        # source's rows of my range
        "bucket_scatter": dict(shape=f"({rows}, {k}) -> ({rows}, {b})",
                               **bound(4 * rows * b + 8 * rows * k,
                                       rows * k)),
        # the same, fused with the sum over the p sources: each owner's
        # range written once
        "bucket_scatter_sum": dict(
            shape=f"({p}, {p}, {rows // p // p}, {k}) -> "
                  f"({p}, {rows // p // p}, {b})",
            **bound(4 * n + 8 * rows * k, rows * k)),
        "qsgd_pack": dict(shape=f"({qrows}, {bq})", **bound(
            8 * qn + qn * bits // 8 + 4 * qrows, 6 * qn)),
        # the gathered codes are unpacked once (the stacked ranks share them)
        "qsgd_unpack": dict(shape=f"({n // bq}, {bq * bits // 32})", **bound(
            n * bits // 8 + 4 * (n // bq) + 4 * n, 2 * n)),
    }


# the CUDA kernel each launch counter counts, by its name in a trace
KERNEL_OF = {"bucket_topk": "bucket_topk_kernel",
             "bucket_scatter": "bucket_scatter_sum_kernel",
             "bucket_scatter_sum": "bucket_scatter_sum_kernel",
             "qsgd_pack": "qsgd_pack_grouped_kernel",
             "qsgd_unpack": "qsgd_unpack_grouped_kernel",
             "qsgd_unpack_grouped": "qsgd_unpack_grouped_kernel"}


def kernel_breakdown(torch, fn, scratch: Path, launches: dict,
                     top: int = 6) -> dict:
    """fn() under torch.profiler: the device's kernel time, the kernel
    count, and the ``top`` kernels by summed time (name, ms, count), read
    from the trace. A trace can lose its first kernels, so fn() runs
    twice, a spin kernel before each, and only the kernels after the last
    spin count. ``valid`` says whether the trace holds a spin marker and,
    of each of the port's kernels, as many launches as ``launches`` (the
    counters of one call) says; only a valid breakdown is evidence."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    events = [e for e in events if "dur" in e and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    spins = [float(e["ts"]) + float(e["dur"]) for e in events
             if "spin" in e.get("name", "")]
    mark = max(spins, default=float("-inf"))
    after = [e for e in events if float(e["ts"]) >= mark]
    by_name: dict = {}
    for e in after:
        c = by_name.setdefault(e.get("name", "?")[:60], [0.0, 0])
        c[0] += float(e["dur"]) / 1e3
        c[1] += 1
    want: dict = {}
    for nm, c in launches.items():
        want[KERNEL_OF[nm]] = want.get(KERNEL_OF[nm], 0) + c
    seen = {kn: sum(kn in e.get("name", "") for e in after) for kn in want}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"valid": bool(spins) and seen == want,
            "spin_markers": len(spins), "port_kernels_in_trace": seen,
            "device_ms": round(sum(v[0] for v in by_name.values()), 3),
            "kernels": sum(v[1] for v in by_name.values()),
            "top": [(nm, round(v[0], 3), v[1]) for nm, v in ranked[:top]]}


def fig3_kernel_checks(torch, ar, coll, u, u_ref, rand, b, bits, bq):
    """The four kernels against their plain versions on the tensors the
    Fig. 3 path hands them at one density: bucket_topk (already compared
    by the caller: ``u`` from the card, ``u_ref`` plain), the owner
    densify of the split phase (bucket_scatter, bit-equal), qsgd_pack on
    the owners' summed shards (bit-equal in 'max' mode; in 'l2' mode, the
    path's, a code may move one level where the L2 scale was summed in
    another order, in at most 1e-4 of the codes) and the single-bucket
    qsgd_unpack of those codes (bit-equal). Returns the inputs (for the
    timings) and a line saying what was checked."""
    from repro_torch.kernels.bucket_scatter import ops as scatter_ops
    from repro_torch.kernels.qsgd_pack import ops as pack_ops
    from repro_torch.kernels.qsgd_pack.ref import u32_to_i64
    from repro_torch.kernels.qsgd_unpack import ops as unpack_ops

    lidx, val = ar._split_uniform(u, coll)
    k2 = lidx.shape[-1]
    li2 = lidx.transpose(0, 1).reshape(-1, k2).contiguous()
    va2 = val.transpose(0, 1).reshape(-1, k2).contiguous()
    dense = scatter_ops.bucket_scatter(li2, va2, b)
    if not torch.equal(dense, scatter_ops.bucket_scatter(li2, va2, b,
                                                         impl="ref")):
        fail(f"fig3 k={k2}: bucket_scatter differs from its plain version")
    del dense
    lr, vr = ar._split_uniform(u_ref, coll)
    shard = ar._reduce_range_dense(lr, vr, b, impl="ref")    # (L, n/p)
    if not torch.equal(ar._reduce_range_dense(lidx, val, b), shard):
        fail(f"fig3 k={k2}: the owner densify (bucket_scatter_sum) differs "
             "from its plain form")
    del lr, vr
    lidx, val = lidx.contiguous(), val.contiguous()
    sx = shard.reshape(-1, bq)
    sr = rand[:, :shard.shape[1]].reshape(-1, bq).contiguous()
    pm, sm = pack_ops.qsgd_pack(sx, sr, bits, "max")
    pmr, smr = pack_ops.qsgd_pack(sx, sr, bits, "max", impl="ref")
    if not (torch.equal(sm, smr)
            and torch.equal(pm.view(torch.int32), pmr.view(torch.int32))):
        fail(f"fig3 k={k2}: qsgd_pack ('max') differs from its plain version")
    packed, sc = pack_ops.qsgd_pack(sx, sr, bits, "l2")
    pr, scr = pack_ops.qsgd_pack(sx, sr, bits, "l2", impl="ref")
    shifts = torch.arange(32 // bits, device=sx.device) * bits
    dc = ((u32_to_i64(packed)[..., None] >> shifts) & (2**bits - 1)) - (
        (u32_to_i64(pr)[..., None] >> shifts) & (2**bits - 1))
    flips = int((dc != 0).sum())
    if int(dc.abs().max()) > 1 or flips > 1e-4 * dc.numel():
        fail(f"fig3 k={k2}: qsgd_pack ('l2') moved {flips} of {dc.numel()} "
             "codes, or one by more than a level")
    pk, sk = packed, sc           # every owner's codes, as gathered
    if not torch.equal(unpack_ops.qsgd_unpack(pk, sk, bits),
                       unpack_ops.qsgd_unpack(pk, sk, bits, impl="ref")):
        fail(f"fig3 k={k2}: qsgd_unpack differs from its plain version")
    what = (f"bucket_topk, bucket_scatter, the owner densify "
            f"(bucket_scatter_sum), qsgd_pack ('max') and qsgd_unpack "
            f"bit-equal to their plain versions; qsgd_pack ('l2') {flips} of "
            f"{dc.numel()} codes one level apart")
    return (li2, va2, lidx, val, sx, sr, pk, sk), what


def phase_fig3(torch, dev, wrappers, kernels, bw, f32_peak, n=1 << 24, p=8,
               ks=(4, 64), timer=None, need_launches=True, profile=None):
    """Phase 7 (see the module docstring). Returns (record, the kernels'
    launches summed over the phase's algorithm runs). ``profile``: a
    directory for the traces of one call of each algorithm (device time,
    kernel count, the costliest kernels), or None."""
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.core import allreduce as ar
    from repro_torch.core.qsgd import QSGDConfig, random_bits
    from repro_torch.core.sparse_stream import delta_threshold
    from repro_torch.core.topk import compress
    from repro_torch.kernels.bucket_scatter import ops as scatter_ops
    from repro_torch.kernels.bucket_topk import ops as topk_ops
    from repro_torch.kernels.qsgd_pack import ops as pack_ops
    from repro_torch.kernels.qsgd_unpack import ops as unpack_ops

    timer = timer or time_ms
    b, bits, bq = 512, 4, 1024
    qsgd = QSGDConfig(bits, bq)
    coll = StackedCollectives(p, dev)
    gen = torch.Generator(device=dev).manual_seed(2024)
    x = torch.randn((p, n), device=dev, generator=gen)
    rand = random_bits(p * n, gen, dev).reshape(p, n)
    algos = [("ssar_recursive_double", None), ("ssar_split_allgather", None),
             ("dsar_split_allgather", None), ("dsar_split_allgather", qsgd),
             ("ssar_balanced_split", None), ("ssar_rearranged_rs", None),
             ("dense", None)]
    clamped = {"ssar_balanced_split": ar.ssar_balanced_split_inside,
               "ssar_rearranged_rs": ar.ssar_rearranged_rs_inside}
    total = {name: 0 for name in wrappers}
    rec = {"n": n, "p": p, "runs": [], "kernel_checks": {}}
    for k in ks:
        # the exact sum comes from the plain versions alone, so that it
        # does not share a kernel with what it checks
        u, res = compress(x, k, b)
        u_ref, res_ref = compress(x, k, b, impl="ref")
        if not (torch.equal(u.val, u_ref.val) and torch.equal(u.lidx, u_ref.lidx)
                and torch.equal(res, res_ref)):
            fail(f"fig3 k={k}: bucket_topk differs from its plain version")
        del res, res_ref
        exact32 = u_ref.densify(impl="ref")
        if not torch.equal(u.densify(), exact32):
            fail(f"fig3 k={k}: bucket_scatter (densify) differs from its "
                 "plain version")
        exact = exact32.double().sum(0)
        del exact32
        scale = float(exact.abs().max())
        inputs, checked = fig3_kernel_checks(torch, ar, coll, u, u_ref, rand,
                                             b, bits, bq)
        rec["kernel_checks"][k] = checked
        log(f"[7] k={k}: {checked}")
        del u_ref
        # recursive doubling's capacity schedule and its switch to dense
        delta = delta_threshold(n, 4)
        cap, switch = u.nnz, None
        for t in range(int(math.log2(p))):
            if 2 * cap > delta:
                switch = t
                break
            cap = min(2 * cap, n, delta)
        rd = ar.ssar_recursive_double_inside(u.to_stream(), coll=coll, n=n)
        fired = rd.dense is not None
        if fired != (switch is not None):
            fail(f"fig3 k={k}: recursive doubling switched={fired}, the "
                 f"capacity schedule says round {switch}")
        log(f"[7] k={k} of {b} (d={k / b:.3%}): recursive doubling "
            + (f"switches to dense in round {switch} of {int(math.log2(p))} "
               f"(2 x {cap} > delta {delta}): the switch fired"
               if fired else f"stays sparse (final capacity {cap} <= delta "
               f"{delta})"))
        del rd
        for algo, q in algos:
            label = algo + ("+qsgd4" if q else "")
            f = ar.make_sparse_allreduce(coll, n, k, b, algorithm=algo,
                                         qsgd=q)
            r_in = rand if q else None
            for w in wrappers.values():
                w.launches = 0
            out = f(x, r_in)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches = {nm: w.launches for nm, w in wrappers.items()}
            for nm, c in launches.items():
                total[nm] += c
            got = out[0].double()
            if not all(torch.equal(out[r], out[0]) for r in range(1, p)):
                fail(f"fig3 {label} k={k}: the ranks' sums differ")
            if q is not None:
                # stochastic rounding moves an entry less than one level,
                # sigma/s (sigma its QSGD bucket's L2 norm, s = 7 at 4
                # bits); at the reference test's density (k = 4) also its
                # mean relative error bound, 0.5
                mask = exact != 0
                err = float((got - exact)[mask].abs().mean()
                            / exact[mask].abs().mean())
                level = (exact.reshape(-1, bq).norm(dim=1, keepdim=True)
                         / (2 ** (bits - 1) - 1)).expand(-1, bq).reshape(-1)
                over = float(((got - exact).abs() - level * (1 + 1e-5)
                              ).max()) / scale
                # the same pipeline through the plain versions with the same
                # rounding bits: the same codes, except where the L2 scale's
                # sum order moves one a level, in at most 1e-4 of them
                want = ar.make_sparse_allreduce(
                    coll, n, k, b, algorithm=algo, qsgd=q, impl="ref")(
                        x, r_in)[0].double()
                diff = (got - want).abs()
                moved = diff > 1e-5 * want.abs()
                flips = int(moved.sum())
                beyond = float((diff - level * (1 + 1e-5))[moved].max()) \
                    / scale if flips else -1.0
                ok = (over <= 1e-6 and (k != 4 or err < 0.5)
                      and beyond <= 1e-6 and flips <= 1e-4 * n)
                what = (f"mean rel err {err:.3e} (limit 0.5 at k=4), "
                        f"max (|err| - level) / max|sum| {over:.3e} "
                        f"(limit 1e-6); against the plain pipeline with the "
                        f"same bits {flips} of {n} entries a level apart "
                        f"(limit 1e-4 n), max (|diff| - level) / max|sum| "
                        f"{beyond:.3e} (limit 1e-6)")
                del want, diff, moved, level
            else:
                if algo in clamped:
                    dense, fold = clamped[algo](u, coll=coll)
                    if not torch.equal(dense, out):
                        fail(f"fig3 {label} k={k}: make_sparse_allreduce "
                             "differs from its *_inside function")
                    got = got + fold.double().sum(0)
                    del dense, fold
                err = float(((got - exact).abs()
                             - 1e-5 * exact.abs()).max()) / scale
                ok, what = err <= 1e-6, (
                    f"max (|err| - 1e-5 |sum|) / max|sum| {err:.3e} "
                    "(limit 1e-6)")
            again = torch.equal(f(x, r_in), out)
            del got, out
            ms = timer(torch, lambda: f(x, r_in))
            row = {"algorithm": label, "k": k, "ms": ms, "check": what,
                   "bit_equal_rerun": again, "launches": launches}
            if dev.type == "cuda":
                row["device_ms"] = graph_ms(torch, lambda: f(x, r_in),
                                           replays=5)
            if profile:
                row["kernels"] = kernel_breakdown(torch, lambda: f(x, r_in),
                                                  profile, launches)
            rec["runs"].append(row)
            log(f"[7] fig3 N=2^{int(math.log2(n))} P={p} k={k} {label}: "
                f"{ms:.3f} ms (device alone, CUDA graph: "
                f"{row.get('device_ms')}); {what}; rerun bit-equal {again}; "
                f"launches { {nm: c for nm, c in launches.items() if c} }")
            if profile:
                log(f"[7]   where the time goes: {row['kernels']}")
            if not ok:
                fail(f"fig3 {label} k={k}: {what}")
            if not again:
                fail(f"fig3 {label} k={k}: a second call gave other bits")
        del u, exact
        gc.collect()
    if need_launches:
        for nm in ("bucket_topk", "bucket_scatter", "bucket_scatter_sum",
                   "qsgd_pack", "qsgd_unpack"):
            if not total[nm]:
                fail(f"fig3: {nm} was never launched")
    # -- the four kernels alone at these shapes (k = the last density), on
    #    the inputs its checks above held against the plain versions
    k = ks[-1]
    bounds = fig3_bounds(n, p, b, k, bits, bq, bw, f32_peak)
    xb = x.reshape(-1, b)
    li2, va2, lis, vas, sx, sr, pk, sk = inputs
    timed = {
        "bucket_topk": lambda: topk_ops.bucket_topk(xb, k),
        "bucket_scatter": lambda: scatter_ops.bucket_scatter(li2, va2, b),
        "bucket_scatter_sum": lambda: scatter_ops.bucket_scatter_sum(
            lis, vas, b),
        "qsgd_pack": lambda: pack_ops.qsgd_pack(sx, sr, bits, "l2"),
        "qsgd_unpack": lambda: unpack_ops.qsgd_unpack(pk, sk, bits)}
    li64 = li2.to(torch.int64)
    lib_out = torch.empty((li2.shape[0], b), device=dev)
    # the p sources' indices side by side: (L, rows, p*k) into (L, rows, B)
    lead, _, rows_o, k_o = lis.shape
    side64 = lis.permute(0, 2, 1, 3).reshape(lead, rows_o, -1).to(torch.int64)
    side_v = vas.permute(0, 2, 1, 3).reshape(lead, rows_o, -1)
    lib_sum = torch.empty((lead, rows_o, b), device=dev)
    library = {                  # one PyTorch call for the same function
        "bucket_topk": lambda: torch.topk(xb.abs(), k, dim=1),
        "bucket_scatter": lambda: lib_out.zero_().scatter_add_(1, li64, va2),
        "bucket_scatter_sum": lambda: lib_sum.zero_().scatter_add_(
            2, side64, side_v)}
    rec["kernels"] = {}
    for row in kernels:
        nm = row["name"]
        t = {"ms": timer(torch, timed[nm]), **bounds[nm],
             "library_ms": (timer(torch, library[nm]) if nm in library
                            else None), "check": checked}
        rec["kernels"][nm] = t
        row["fig3"] = t
        log(f"[7] {nm} at the Fig. 3 shape {t['shape']}: {t['ms']:.3f} ms, "
            f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}), library "
            f"{t['library_ms']} ms")
    return rec, total


def phase_manual(torch, dev, wrappers, spmd_main):
    """Phase 8 (see the module docstring). Returns (record, launches, the
    trainer, which phase 10 continues)."""
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.comm.executor import reduce_buckets, reduce_buckets_spmd
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.train import run_lm
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer

    cfg, data = run_lm.lm_config(fast=False)
    trainer = Trainer(build_model(cfg), run_lm.train_config(STEPS), data,
                      dp_total=run_lm.DP, device=dev, lowering="manual")
    trainer.init()
    n_sparse = trainer.plan.num_sparse_buckets
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    tlog = trainer.run(STEPS)
    launches = {nm: w.launches for nm, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(tlog.step_times[1:]) * 1e3
    ref = spmd_main["losses"]
    rel = max(abs(a - c) / abs(c) for a, c in zip(tlog.losses, ref))
    same = tlog.losses == ref
    log(f"[8] {cfg.name} lowering=manual (per-rank DSAR + QSGD4 over "
        f"{run_lm.DP} stacked ranks): losses "
        f"{[round(v, 5) for v in tlog.losses]}")
    log(f"[8] step times ms {[round(t * 1e3, 1) for t in tlog.step_times]}; "
        f"median of steps 2-{STEPS}: {step_ms:.1f} ms (stacked, phase 3: "
        f"{spmd_main['median_step_ms']:.1f} ms); peak memory {peak_gb:.2f} "
        f"GB; launches {launches}")
    log(f"[8] manual vs stacked lowering, same seed and QSGD bits: max rel "
        f"loss diff {rel:.2e}; bit-equal {same} (required)")
    # the two executors' reduce halves alone on one step's grads (CUDA
    # events, in turns stacked / per rank / per rank / stacked): where the
    # steps' gap lies
    st = trainer.state
    _, leaves = ts.rank_grads(trainer.model, st.params, ts.batch_to_device(
        synthetic_batch(data, 0), dev), run_lm.DP, trainer.tcfg.microbatches)
    rand0 = ts.StepBits(trainer.tcfg.seed, 0, dev, run_lm.DP)
    coll = StackedCollectives(run_lm.DP, dev)
    halves = {
        "stacked": lambda: reduce_buckets_spmd(
            trainer.plan, leaves, st.residuals, p_data=run_lm.DP,
            rand_fn=rand0, telemetry=False),
        "per_rank": lambda: reduce_buckets(
            trainer.plan, leaves, st.residuals, coll=coll, rand_fn=rand0,
            telemetry=False)}
    alone = [(nm, time_ms(torch, halves[nm], reps=3)) for nm in (
        "stacked", "per_rank", "per_rank", "stacked")]
    host = {nm: host_ms(torch, fn, reps=3) for nm, fn in halves.items()}
    log(f"[8] reduce half alone, CUDA events (stacked / per rank / per rank "
        f"/ stacked): {[round(a, 2) for _, a in alone]} ms; host enqueue "
        f"{ {nm: round(h, 2) for nm, h in host.items()} } ms")
    # one call's launches: the stacked half groups the fused densify + sum
    # and the pack, the per-rank half makes one of each a bucket
    one_call = {half: {nm: 0 for nm in wrappers} for half in halves}
    for half, grouped in (("stacked", 1), ("per_rank", n_sparse)):
        one_call[half].update(bucket_topk=n_sparse,
                              bucket_scatter_sum=grouped, qsgd_pack=grouped,
                              qsgd_unpack_grouped=1)
    breakdown = {nm: kernel_breakdown(torch, fn, ROOT / "chiprun_out",
                                      one_call[nm], top=8)
                 for nm, fn in halves.items()}
    for nm, bd in breakdown.items():
        log(f"[8]   {nm} reduce half, where the device time goes: {bd}")
    unpack_check = check_row_major_unpack(torch, halves["per_rank"],
                                          trainer.plan.cfg.qsgd_bits)
    del leaves, st
    turns = steps_in_turns(torch, trainer, dev, data)
    expect = {"bucket_topk": n_sparse * STEPS, "bucket_scatter": 0,
              "bucket_scatter_sum": n_sparse * STEPS,
              "qsgd_pack": n_sparse * STEPS, "qsgd_unpack": 0,
              "qsgd_unpack_grouped": STEPS}
    for nm, c in launches.items():
        if c != expect[nm]:
            fail(f"manual lowering: {nm} launched {c} times in {STEPS} "
                 f"steps, expected {expect[nm]}")
    # both executors sum over ranks in rank order: the same bits
    if not all(math.isfinite(v) for v in tlog.losses) or not same:
        fail("manual lowering: losses differ from the stacked lowering's")
    return ({"losses": list(tlog.losses), "step_times_s": list(tlog.step_times),
             "median_step_ms": step_ms, "peak_memory_gb": peak_gb,
             "launches": launches, "max_rel_vs_spmd": rel,
             "bit_equal_vs_spmd": same,
             "reduce_alone_ms": alone, "reduce_host_ms": host,
             "reduce_breakdown": breakdown, "row_major_unpack": unpack_check,
             "steps_in_turns": turns}, launches, trainer)


def check_row_major_unpack(torch, reduce_half, bits):
    """Phase 8: one call of the per-rank reduce half at lm-100m, with the
    segments it hands its grouped qsgd_unpack captured (the received,
    row-major layout: p_pod 1, p_data = the ranks, mean 1); the CUDA
    launch on those segments held bit for bit against
    qsgd_unpack_grouped_ref on the same ones."""
    from repro_torch.comm import executor
    from repro_torch.kernels.qsgd_unpack import ops as unpack_ops

    captured = []
    grouped = executor.qsgd_unpack_grouped

    def capture(segments, *args, **kw):
        captured.append(list(segments))
        return grouped(segments, *args, **kw)

    executor.qsgd_unpack_grouped = capture
    try:
        reduce_half()
        torch.cuda.synchronize()
    finally:
        executor.qsgd_unpack_grouped = grouped
    if len(captured) != 1:
        fail(f"per-rank reduce half made {len(captured)} grouped unpack "
             "calls, expected 1")
    segs = captured[0]
    if not segs or not all(sg.row_major and sg.p_pod == 1 and sg.mean == 1.0
                           for sg in segs):
        fail("per-rank reduce half: the grouped unpack's segments are not "
             "the received row-major layout")
    got = unpack_ops.qsgd_unpack_grouped(segs, bits, impl="cuda")
    want = unpack_ops.qsgd_unpack_grouped(segs, bits, impl="ref")
    n_diff = sum(int((g_ != w_).sum()) for g_, w_ in zip(got, want))
    geometry = sorted({(sg.p_data, sg.rows, sg.shard, sg.bq) for sg in segs})
    entries = sum(g_.numel() for g_ in got)
    log(f"[8] row-major grouped qsgd_unpack on the per-rank half's "
        f"{len(segs)} segments ({entries} entries; (p_data, rows, shard, "
        f"bq) {geometry}): {n_diff} entries differ from "
        "qsgd_unpack_grouped_ref")
    if n_diff:
        fail("row-major grouped qsgd_unpack differs from its plain version")
    return {"segments": len(segs), "entries": entries,
            "geometry": [list(g) for g in geometry], "entries_differ": n_diff}


def steps_in_turns(torch, trainer, dev, data, rounds: int = 3):
    """Phase 8: the stacked and the per-rank synchronous lm-100m steps
    timed in turns (stacked, per rank, per rank, stacked, ``rounds``
    times) from the same state, each after one warm-up call; step time as
    Trainer.run takes it (wall clock to the loss on the host and a device
    synchronisation). The state is not advanced."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train import run_lm
    from repro_torch.train import train_step as ts

    stacked, _ = ts.build_train_step(trainer.model, trainer.tcfg, run_lm.DP,
                                     device=dev, lowering="spmd")
    fns = {"stacked": stacked, "per_rank": trainer.step_fn}
    st = trainer.state
    batch = synthetic_batch(data, st.step)

    def one(nm):
        t0 = time.perf_counter()
        _, metrics = fns[nm](st, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for nm in fns:
        one(nm)
    times = {nm: [] for nm in fns}
    for _ in range(rounds):
        for nm in ("stacked", "per_rank", "per_rank", "stacked"):
            times[nm].append(one(nm))
    med = {nm: statistics.median(t) for nm, t in times.items()}
    gap = med["per_rank"] / med["stacked"] - 1
    log(f"[8] synchronous steps in turns from one state (ms): stacked "
        f"{[round(t, 1) for t in times['stacked']]}, per rank "
        f"{[round(t, 1) for t in times['per_rank']]}; medians "
        f"{med['stacked']:.1f} / {med['per_rank']:.1f} ({gap:+.2%})")
    return {"ms": times, "median_ms": med, "per_rank_over_stacked": gap}


def phase_manual_pipelined(torch, dev, wrappers, trainer, spmd_pipe,
                           sync_ms):
    """Phase 10 (see the module docstring): ``trainer`` is phase 8's,
    after its 6 steps. Returns (record, launches)."""
    trainer.run(STEPS + 3)              # phase 3's 3 profiled steps
    n_sync = len(trainer.log.step_times)
    n_sparse = trainer.plan.num_sparse_buckets
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    trainer.run_pipelined(trainer.state.step + PIPE_STEPS, staleness=1,
                          superstep=K_UNIT, depth=2)
    launches = {nm: w.launches for nm, w in wrappers.items()}
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = trainer.log.losses[n_sync:]
    pipe_ms, units_ms = steady_ms(trainer.log.step_times[n_sync:])
    ref = spmd_pipe["losses"]
    rel = max(abs(a - c) / abs(c) for a, c in zip(losses, ref))
    same = losses == ref
    log(f"[10] pipelined lowering=manual (staleness 1, superstep {K_UNIT}, "
        f"depth 2): losses {[round(v, 5) for v in losses]}")
    log(f"[10] unit retire intervals ms {[round(u, 1) for u in units_ms]}; "
        f"ms a step {pipe_ms:.1f} (stacked, phase 3: "
        f"{spmd_pipe['ms_a_step']:.1f}); peak memory {peak_gb:.2f} GB "
        f"(stacked: {spmd_pipe['peak_memory_gb']:.2f}); launches {launches}")
    log(f"[10] overlap win: sync {sync_ms:.1f} ms/step (phase 8) -> "
        f"pipelined {pipe_ms:.1f} ms/step ({sync_ms / pipe_ms:.2f}x); vs the "
        f"stacked pipelined run: max rel loss diff {rel:.2e} (limit 2e-4), "
        f"bit-equal {same}")
    expect = {"bucket_topk": n_sparse * PIPE_STEPS, "bucket_scatter": 0,
              "bucket_scatter_sum": n_sparse * PIPE_STEPS,
              "qsgd_pack": n_sparse * PIPE_STEPS, "qsgd_unpack": 0,
              "qsgd_unpack_grouped": PIPE_STEPS}
    for nm, c in launches.items():
        if c != expect[nm]:
            fail(f"pipelined manual lowering: {nm} launched {c} times in "
                 f"{PIPE_STEPS} steps, expected {expect[nm]}")
    if (len(losses) != PIPE_STEPS or not all(math.isfinite(v) for v in losses)
            or not rel <= 2e-4):
        fail(f"pipelined manual lowering: losses {losses} disagree with the "
             "stacked pipelined run")
    return ({"losses": losses, "unit_retire_ms": units_ms,
             "ms_a_step": pipe_ms, "sync_ms_a_step": sync_ms,
             "overlap_win": sync_ms / pipe_ms, "peak_memory_gb": peak_gb,
             "launches": launches, "max_rel_vs_spmd": rel,
             "bit_equal_vs_spmd": same,
             "spmd_ms_a_step": spmd_pipe["ms_a_step"]}, launches)


def phase_telemetry(torch, dev, wrappers, tiny, tiny_data, params0, bits_for):
    """Phase 11 (see the module docstring). Returns (record, launches of
    the lm-100m runs with telemetry on)."""
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.comm.executor import reduce_buckets, reduce_buckets_spmd
    from repro_torch.core.compressor import SyncConfig
    from repro_torch.core.cost_model import bucket_wire_bytes
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.runtime.driver import DriverConfig, run_pipelined
    from repro_torch.runtime.pipeline import attach_inflight, build_superstep
    from repro_torch.train import run_lm
    from repro_torch.train import train_step as ts
    from repro_torch.train.train_step import init_state

    log(f"[11] device memory in use at the start: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    cfg, data = run_lm.lm_config(fast=False)
    tcfg = run_lm.train_config(PIPE_STEPS)
    model = build_model(cfg)
    sups = {tel: build_superstep(model, tcfg, run_lm.DP, dev, steps=K_UNIT,
                                 guard=True, telemetry=tel)
            for tel in (False, True)}
    plan = sups[True][1]
    batch = lambda step: synthetic_batch(data, step)
    fresh = lambda: attach_inflight(init_state(model, tcfg, plan, dev), plan)
    runs, total = [], {nm: 0 for nm in wrappers}
    steps = 5 * K_UNIT                  # 5 units: 3 between fill and drain
    # a warm-up run first, so that no timed run grows the allocator's pool
    for tel in (None, False, True, True, False):
        state = fresh()
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        state, dlog = run_pipelined(sups[bool(tel)][0], state, start_step=0,
                                    num_steps=steps, batch_fn=batch,
                                    cfg=DriverConfig(depth=2,
                                                     steps_per_unit=K_UNIT))
        torch.cuda.synchronize()
        if tel:
            for nm, w in wrappers.items():
                total[nm] += w.launches
        ms, units = steady_ms(dlog.step_times)
        if tel is not None:
            runs.append({"telemetry": tel, "ms_a_step": ms,
                         "unit_retire_ms": units,
                         "losses": list(dlog.losses)})
        del state
    for nm in ("bucket_topk", "bucket_scatter_sum", "qsgd_pack",
               "qsgd_unpack_grouped"):
        if not total[nm]:
            fail(f"telemetry phase: {nm} was never launched")
    same = all(r["losses"] == runs[0]["losses"] for r in runs)
    on = statistics.mean(r["ms_a_step"] for r in runs if r["telemetry"])
    off = statistics.mean(r["ms_a_step"] for r in runs if not r["telemetry"])
    log(f"[11] stacked pipelined lm-100m, telemetry off/on/on/off: ms a step "
        f"{[round(r['ms_a_step'], 2) for r in runs]} (on {on:.2f}, off "
        f"{off:.2f}: {on / off - 1:+.2%}); losses bit-equal {same}")
    if not same:
        fail("telemetry changed the pipelined run's losses")
    # the reduce half alone (CUDA events), off/on/on/off
    st = fresh()
    _, leaves = ts.rank_grads(model, st.params, ts.batch_to_device(
        batch(0), dev), run_lm.DP, tcfg.microbatches)
    rand0 = ts.StepBits(tcfg.seed, 0, dev, run_lm.DP)
    alone = [time_ms(torch, lambda tel=tel: reduce_buckets_spmd(
        plan, leaves, st.residuals, p_data=run_lm.DP, rand_fn=rand0,
        telemetry=tel), reps=3) for tel in (False, True, True, False)]
    reduce_off = (alone[0] + alone[3]) / 2
    reduce_on = (alone[1] + alone[2]) / 2
    log(f"[11] the stacked reduce half alone, telemetry off/on/on/off: "
        f"{[round(a, 3) for a in alone]} ms (+{reduce_on - reduce_off:.3f} "
        f"ms with telemetry)")
    del st, leaves

    # one step's rows
    step = sups[True][0].step
    state, m = step(fresh(), batch(0))
    step.drain()            # the rows come from the side stream's reduce
    rows = {nm: r.cpu() for nm, r in m["telemetry"].items()}
    del state, m
    sparse = {b.name: (g, b) for g in plan.groups for b in g.buckets
              if b.sparse}
    bad = [nm for nm, r in rows.items() if not (
        bool(torch.isfinite(r).all()) and 0 <= float(r[0]) <= sparse[nm][1].n
        and 0 < float(r[2]) <= 1)]
    vb = tcfg.sync.qsgd_bits
    dsar = [nm for nm, (g, b) in sparse.items()
            if b.algorithm == "dsar_split_allgather"]
    want_wire = plan.wire_bytes() - sum(
        bucket_wire_bytes(b.algorithm, plan.dp_total, plan.bucket_k(g, b), b.n,
                          value_bits=vb)
        for g in plan.groups for b in g.buckets
        if b.algorithm != "dsar_split_allgather")
    got_wire = sum(float(rows[nm][1]) for nm in dsar)
    wire_rel = abs(got_wire - want_wire) / want_wire
    log(f"[11] one step's rows: {len(rows)} (expected {len(sparse)}); invalid "
        f"{bad}; DSAR wire bytes {got_wire:.0f} vs the plan's {want_wire:.0f} "
        f"(rel {wire_rel:.1e}, limit 1e-6); coverage "
        f"{min(float(r[2]) for r in rows.values()):.4f}-"
        f"{max(float(r[2]) for r in rows.values()):.4f}")
    if set(rows) != set(sparse) or bad or not wire_rel <= 1e-6:
        fail("telemetry rows of the lm-100m step are not valid")
    del sups, step
    gc.collect()
    torch.cuda.empty_cache()

    # the small model: both executors on the card and on the CPU, on the
    # same gradients with the same bits
    small = {}
    for qsgd_bits in (None, 4):
        sync = SyncConfig(mode="sparcml", k_per_bucket=8, bucket_size=512,
                          algorithm="dsar_split_allgather",
                          qsgd_bits=qsgd_bits, min_sparse_size=65536)
        tmodel = build_model(tiny)
        tplan = ts.build_plan(tmodel, dataclasses.replace(tcfg, sync=sync),
                              run_lm.DP)
        bt = ts.batch_to_device(synthetic_batch(tiny_data, 0),
                                torch.device("cpu"))
        _, leaves = ts.rank_grads(tmodel, params0, bt, run_lm.DP, 2)
        res = {nm: torch.randn(r.shape, generator=torch.Generator()
                               .manual_seed(5)) * 1e-3
               for nm, r in tplan.init_residuals().items()}
        out = {}
        for key, where in (("cpu", torch.device("cpu")), ("card", dev)):
            lv = [l.to(where) for l in leaves]
            rs = {nm: r.to(where) for nm, r in res.items()}
            _, _, t_spmd = reduce_buckets_spmd(
                tplan, lv, rs, p_data=run_lm.DP, rand_fn=bits_for(0, where))
            _, _, t_rank = reduce_buckets(
                tplan, lv, rs, coll=StackedCollectives(run_lm.DP, where),
                rand_fn=bits_for(0, where))
            out[key] = {"spmd": {nm: r.cpu() for nm, r in
                                        t_spmd.items()},
                               "manual": {nm: r[0].cpu() for nm, r in
                                          t_rank.items()}}
        worst = {}
        for form in ("spmd", "manual"):
            a, c = out["card"][form], out["cpu"][form]
            diff = torch.stack([(a[nm].double() - c[nm].double()).abs()
                                / c[nm].double().abs().clamp_min(1e-30)
                                for nm in c])
            worst[form] = [float(v) for v in diff.max(dim=0).values]
        small[str(qsgd_bits)] = worst
        log(f"[11] small model, qsgd_bits={qsgd_bits}: the card's rows vs the "
            f"CPU path's, max rel diff [nnz, wire, coverage, EF norm] "
            f"{worst}")
        for form, w in worst.items():
            exact = qsgd_bits is None
            if (exact and (w[0] or w[1])) or max(w[:2]) > 1e-3 or \
                    max(w[2:]) > 1e-5:
                fail(f"small-model telemetry ({form}, bits {qsgd_bits}): "
                     "the card's rows disagree with the CPU path's")
    return ({"runs": runs, "losses_bit_equal": same, "ms_on": on,
             "ms_off": off, "reduce_alone_ms_off_on_on_off": alone,
             "rows_step0": {nm: r.tolist()
                                           for nm, r in rows.items()},
             "dsar_wire_rel": wire_rel, "small_model_max_rel": small}, total)


def phase_obs_adapt(torch, dev, wrappers, out_dir: Path):
    """Phase 13 (see the module docstring). Returns (record, launches of
    its lm-100m runs)."""
    from repro_torch import obs as obs_mod
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.core.cost_model import plan_bucket_times
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.runtime import adapt as rt_adapt
    from repro_torch.runtime import driver as rt_driver
    from repro_torch.runtime.pipeline import attach_inflight, build_superstep
    from repro_torch.train import run_lm
    from repro_torch.train.train_step import build_plan, init_state
    from repro_torch.train.trainer import Trainer

    rec: dict = {}
    total = {nm: 0 for nm in wrappers}

    def count_launches():
        for nm, w in wrappers.items():
            total[nm] += w.launches
            w.launches = 0

    cfg, data = run_lm.lm_config(fast=False)
    tcfg = run_lm.train_config(SWAP_STEPS)
    model = build_model(cfg)

    def trainer(ob=None):
        t = Trainer(model, tcfg, data, dp_total=run_lm.DP, device=dev,
                    obs=ob)
        t.init()
        return t

    def gauge(tr, steps, **kw):
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        tr.run_pipelined(steps, superstep=K_UNIT, depth=2, **kw)
        torch.cuda.synchronize()
        count_launches()
        ms, units = steady_ms(tr.log.step_times)
        return list(tr.log.losses), ms, units

    # -- observability off, then on (trace, metrics, audit, health), from
    #    one state; the calibration first, on the on-trainer's ranks
    off = trainer()
    losses_off, _, _ = gauge(off, OBS_STEPS)
    off.state = None
    ob = obs_mod.configure(trace=True, metrics=True, audit=True,
                           set_as_default=False)
    on = trainer(ob)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = on._calibrated_net()
    cal_s = time.perf_counter() - t0
    ladder = [(s["n"], s["measured_s"], s["predicted_s"])
              for s in ob.audit.samples if s["algorithm"] == "dense_ladder"]
    log(f"[13] calibration on the {run_lm.DP} stacked ranks (the device's sum "
        f"over the rank axis; no wire): alpha {net.alpha:.4e} s, "
        f"{net.link_bytes_per_s / 1e9:.2f} GB/s, in {cal_s:.3f} s; ladder "
        "(elements, measured ms, fitted ms, measured/fitted) " + str([
            (n, round(m * 1e3, 4), round(p * 1e3, 4), round(m / p, 3))
            for n, m, p in ladder]))
    rec["calibration"] = {"alpha_s": net.alpha,
                          "link_bytes_per_s": net.link_bytes_per_s,
                          "seconds": cal_s, "ladder": ladder}
    waits = {"n": 0}
    real_wait = rt_driver._wait

    def counting(done):
        if done is not None:
            waits["n"] += 1
        return real_wait(done)

    # the driver's own wait (an event's) is not what the sync debug mode
    # is there to find: every other synchronising call is
    first = real_wait.__code__.co_firstlineno
    wait_lines = range(first, first + 8)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    rt_driver._wait = counting
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                on.run_pipelined(OBS_STEPS, superstep=K_UNIT, depth=2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        rt_driver._wait = real_wait
    torch.cuda.synchronize()
    count_launches()
    losses_on = list(on.log.losses)
    syncs = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
             if "called a synchronizing" in str(w.message)
             and not (w.filename == rt_driver.__file__
                      and w.lineno in wait_lines)]
    units = OBS_STEPS // K_UNIT
    same = losses_on == losses_off
    log(f"[13] pipelined lm-100m, {OBS_STEPS} steps, observability off vs "
        f"on: losses bit-equal {same}; host waits {waits['n']} for {units} "
        f"units; synchronising calls flagged {len(syncs)}")
    if not same:
        fail(f"observability changed the losses: {losses_on} vs {losses_off}")
    if waits["n"] != units or syncs:
        fail(f"observability added host waits: {waits['n']} waits for "
             f"{units} units, flagged {syncs[:3]}")
    paths = ob.export(trace_path=str(out_dir / "phase13_trace.json"),
                      metrics_path=str(out_dir / "phase13_metrics.jsonl"))
    events = json.load(open(paths["trace"]))["traceEvents"]
    bad = obs_mod.validate_span_tree(events)
    names = {e["name"] for e in events if e["ph"] == "X"}
    derived = {e["name"] for e in events if e.get("tid") == "device-phases"}
    ef = [b.name for b in on.plan.buckets if b.has_residual]
    short = [f"bucket/{n}/{c}" for n in ef
             for c in ("nnz", "wire_bytes", "mass_coverage", "ef_norm")
             if len(getattr(ob.metrics.metrics.get(f"bucket/{n}/{c}"),
                            "values", [])) != OBS_STEPS]
    log(f"[13] trace {len(events)} events, span tree violations {len(bad)}, "
        f"host spans {sorted(n for n in names if n.startswith('driver/'))}, "
        f"derived phases {len(derived)} names; {len(ef)} EF buckets x 4 "
        f"histograms, {len(short)} without {OBS_STEPS} samples")
    if bad or not {"driver/dispatch", "driver/retire"} <= names \
            or not derived or len(ef) != 26 or short:
        fail(f"observability outputs: violations {bad[:2]}, spans {names}, "
             f"derived {sorted(derived)}, histograms short {short[:4]}")
    log("[13] health: " + on.last_health.summary().strip())
    rec["obs"] = {"losses": losses_on, "bit_equal": same,
                  "host_waits": waits["n"], "units": units,
                  "trace_events": len(events), "derived_names": len(derived),
                  "health": [dataclasses.asdict(e)
                             for e in on.last_health.history],
                  "paths": paths}
    on.state = None
    del on, off
    gc.collect()
    torch.cuda.empty_cache()

    # -- a forced swap at a known barrier: every EF bucket demoted to dense
    #    after the unit ending at step SWAP_AT, installed at the next drain;
    #    against both plans' steps built by hand and switched there
    sob = obs_mod.configure(trace=True, metrics=True, set_as_default=False)
    fresh = lambda p: attach_inflight(init_state(model, tcfg, p, dev), p)
    batch = lambda step: synthetic_batch(data, step)
    dcfg = rt_driver.DriverConfig(depth=2, steps_per_unit=K_UNIT)
    plan = build_plan(model, tcfg, run_lm.DP)
    rt = rt_adapt.AdaptiveRuntime(
        model, tcfg, run_lm.DP, dev, plan=plan, net=net,
        cfg=rt_adapt.AdaptConfig(window=10 ** 6), superstep=K_UNIT,
        guard=True, obs=sob)
    rt.demote_after(SWAP_AT, ef)
    demoted = plan.replan(algorithms={b: "dense" for b in ef})
    phase_attr = lambda dt: obs_mod.attribute_step_phases(  # noqa: E731
        dt / K_UNIT, plan_bucket_times(rt.current_plan, None, net),
        names=[b.name for b in rt.current_plan.buckets])
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    _, slog = rt_driver.run_pipelined(
        rt.current_fn(), fresh(plan), start_step=0, num_steps=SWAP_STEPS,
        batch_fn=batch, cfg=dcfg, obs=sob, phase_attr=phase_attr,
        adapt=rt)
    torch.cuda.synchronize()
    count_launches()
    swaps = list(slog.plan_swaps)
    swap_step = SWAP_AT + K_UNIT
    sev = json.load(open(sob.tracer.export(
        str(out_dir / "phase13_swap_trace.json"))))["traceEvents"]
    snames = {e["name"] for e in sev if e["ph"] == "X"}
    by_hand, parts = [], []
    t_build = None
    s = fresh(plan)
    for p, lo, hi in ((plan, 0, swap_step), (demoted, swap_step, SWAP_STEPS)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn, _ = build_superstep(model, tcfg, run_lm.DP, dev, steps=K_UNIT,
                                guard=True, plan=p)
        t_build = time.perf_counter() - t0 if p is demoted else t_build
        for w in wrappers.values():
            w.launches = 0
        s, hlog = rt_driver.run_pipelined(fn, s, start_step=lo, num_steps=hi,
                                          batch_fn=batch, cfg=dcfg)
        torch.cuda.synchronize()
        launches = {nm: w.launches for nm, w in wrappers.items()}
        count_launches()
        ms, units = steady_ms(hlog.step_times)
        parts.append({"steps": [lo, hi], "ms_a_step": ms,
                      "unit_retire_ms": units, "launches": launches})
        by_hand += list(hlog.losses)
    del s
    same = by_hand == list(slog.losses)
    swap_ms = [steady_ms(slog.step_times[:swap_step])[0],
               steady_ms(slog.step_times[swap_step:])[0]]
    log(f"[13] forced swap (all {len(ef)} EF buckets demoted to dense after "
        f"step {SWAP_AT}): swaps at {[st for st, _ in swaps]}; losses "
        f"bit-equal to both plans' steps switched by hand at step "
        f"{swap_step}: {same}; drain spans {'driver/drain' in snames}")
    log(f"[13] launches by hand, before / after the swap "
        f"({swap_step} / {SWAP_STEPS - swap_step} steps): "
        f"{parts[0]['launches']} / {parts[1]['launches']}")
    swap_units = [round(u, 1) for u in steady_ms(slog.step_times)[1]]
    log(f"[13] ms a step before / after the swap: by hand "
        f"{parts[0]['ms_a_step']:.1f} / {parts[1]['ms_a_step']:.1f}, in the "
        f"swapped run {swap_ms[0]:.1f} / {swap_ms[1]:.1f}; unit retire ms of "
        f"the swapped run {swap_units}; building the new step "
        f"{t_build * 1e3:.1f} ms")
    after = parts[1]["launches"]
    n_after = SWAP_STEPS - swap_step
    if not same or [st for st, _ in swaps] != [swap_step] \
            or swaps[0][1] != demoted.signature():
        fail(f"forced swap: swaps {swaps}, losses bit-equal {same}")
    if "driver/drain" not in snames:
        fail("forced swap: no drain span in the trace")
    if (after["qsgd_pack"] or after["qsgd_unpack_grouped"]
            or after["bucket_scatter_sum"] != n_after
            or after["bucket_topk"] != len(ef) * n_after
            or parts[0]["launches"]["qsgd_pack"] != swap_step):
        fail(f"forced swap launches: {parts}")
    rec["forced_swap"] = {"swaps": swaps, "bit_equal": same, "parts": parts,
                          "swapped_run_ms_a_step": swap_ms,
                          "losses": list(slog.losses),
                          "build_new_step_ms": t_build * 1e3}
    del rt, slog
    gc.collect()
    torch.cuda.empty_cache()

    # -- the natural loop: the default AdaptConfig on the calibrated net
    nob = obs_mod.configure(metrics=True, audit=True, set_as_default=False)
    nat = Trainer(model, tcfg, data, dp_total=run_lm.DP, device=dev, obs=nob)
    nat._net_cal = net              # the one calibration of this phase
    nat.init()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    nlog = nat.run_pipelined(NATURAL_STEPS, superstep=K_UNIT, depth=2,
                             adapt=True)
    torch.cuda.synchronize()
    count_launches()
    adapt_events = [{k: v for k, v in e.items()
                     if k not in ("t", "densities")}
                    for e in nob.metrics.events
                    if e["event"].startswith("adapt/")]
    log(f"[13] natural loop, {NATURAL_STEPS} steps, default AdaptConfig: "
        f"swaps {[(st, sig[:60]) for st, sig in nlog.plan_swaps]}; adapt "
        f"events {[e['event'] for e in adapt_events]}")
    for e in adapt_events[:8]:
        log(f"[13]   {json.dumps(e)[:300]}")
    if not all(math.isfinite(v) for v in nlog.losses):
        fail(f"natural loop: losses {nlog.losses}")
    final = nat.last_plan
    nat.state = None
    del nat
    gc.collect()
    torch.cuda.empty_cache()

    # -- the drift audit of the plan the loop ended on
    aud = obs_mod.DriftAuditor()
    t0 = time.perf_counter()
    obs_mod.audit_sync_plan(final, StackedCollectives(run_lm.DP, dev),
                            net=net, auditor=aud, registry=nob.metrics,
                            max_n=1 << 28)
    audit_s = time.perf_counter() - t0
    log(f"[13] drift audit of the final plan ({len(aud)} probes, "
        f"{audit_s:.2f} s):")
    for line in aud.summary().splitlines():
        log(f"[13]   {line}")
    rec["natural"] = {"losses": list(nlog.losses),
                      "swaps": list(nlog.plan_swaps),
                      "adapt_events": adapt_events,
                      "final_signature": final.signature(),
                      "audit": aud.report()}

    # -- the cost of observability: on / off in turns, 3 rounds each
    turns = []
    for rnd in range(COST_ROUNDS):
        for obs_on in (True, False):
            o = (obs_mod.configure(trace=True, metrics=True, audit=True,
                                   set_as_default=False) if obs_on else None)
            t = trainer(o)
            t._net_cal = net
            _, ms, units = gauge(t, COST_STEPS)
            turns.append({"obs": obs_on, "ms_a_step": ms,
                          "unit_retire_ms": units})
            t.state = None
            del t
    on_ms = statistics.median(r["ms_a_step"] for r in turns if r["obs"])
    off_ms = statistics.median(r["ms_a_step"] for r in turns if not r["obs"])
    log(f"[13] pipelined step, observability on / off in turns (telemetry "
        f"rows included in on): "
        f"{[(r['obs'], round(r['ms_a_step'], 2)) for r in turns]}; medians "
        f"{on_ms:.2f} / {off_ms:.2f} ms ({on_ms / off_ms - 1:+.2%})")
    rec["obs_cost"] = {"turns": turns, "on_ms": on_ms, "off_ms": off_ms}
    gc.collect()
    torch.cuda.empty_cache()
    return rec, total


def phase_nccl(torch, dev, wrappers, tiny, tiny_data, params0, bits_for):
    """Phase 12 (see the module docstring). Returns (record, launches of
    the NCCL runs)."""
    import torch.distributed as dist

    from repro_torch.comm.collectives import (ProcessGroupCollectives,
                                              StackedCollectives)
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.runtime.pipeline import attach_inflight, build_superstep
    from repro_torch.train import run_lm
    from repro_torch.train import train_step as ts
    from repro_torch.utils.tree import tree_leaves

    model = build_model(tiny)
    tcfg = run_lm.train_config(STEPS)

    def run(coll):
        step, plan = ts.build_train_step(model, tcfg, 1, dev,
                                         lowering="manual", coll=coll)
        state = ts.init_state(model, tcfg, plan, dev,
                              params=_to(params0, dev), coll=coll)
        losses = []
        for i in range(2):
            state, m = step(state, synthetic_batch(tiny_data, i),
                            bits_for(i, dev))
            losses.append(float(m["loss"]))
        sup, _ = build_superstep(model, tcfg, 1, dev, steps=2, guard=True,
                                 lowering="manual", coll=coll)
        pstate = attach_inflight(state, plan)
        pstate, pm = sup(pstate, {k: torch.stack([
            torch.as_tensor(synthetic_batch(tiny_data, 2 + i)[k])
            for i in range(2)]) for k in synthetic_batch(tiny_data, 0)},
            [bits_for(2 + i, dev) for i in range(2)])
        sup.drain()
        torch.cuda.synchronize()
        losses += [float(v) for v in pm["loss"]]
        return losses, [t.cpu() for f in ("params", "opt", "residuals",
                                          "inflight")
                        for t in tree_leaves(getattr(pstate, f))] + [
            r.cpu() for nm in sorted(pm["telemetry"])
            for r in pm["telemetry"][nm]]

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/rendezvous",
                                world_size=1, rank=0)
        try:
            for w in wrappers.values():
                w.launches = 0
            got = run(ProcessGroupCollectives(device=dev))
            launches = {nm: w.launches for nm, w in wrappers.items()}
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    want = run(StackedCollectives(1, dev))
    same = got[0] == want[0] and len(got[1]) == len(want[1]) and all(
        torch.equal(a, b) for a, b in zip(got[1], want[1]))
    log(f"[12] {backend} world of 1: 2 synchronous + 2 pipelined per-rank "
        f"steps of the small model, losses {got[0]}; bit-equal to "
        f"StackedCollectives(1) {same}; launches {launches}")
    if not same:
        fail("the NCCL per-rank step differs from the stacked one")
    for nm in ("bucket_topk", "bucket_scatter_sum", "qsgd_pack",
               "qsgd_unpack_grouped"):
        if not launches[nm]:
            fail(f"NCCL phase: {nm} was never launched")
    return {"backend": backend, "losses": got[0], "bit_equal": same,
            "launches": launches}, launches


def phase_classify(torch, dev, wrappers, rc, need_launches=True):
    """Phase 9 (see the module docstring). Returns (record, launches)."""
    data = rc.load(dev)
    total = {nm: 0 for nm in wrappers}
    rec = {}
    for algo in rc.ALGORITHMS:
        for w in wrappers.values():
            w.launches = 0
        w_, dt = rc.train(algo, data, rc.N_FEATURES, dev)
        launches = {nm: w.launches for nm, w in wrappers.items()}
        for nm, c in launches.items():
            total[nm] += c
        acc = rc.accuracy(w_, data)
        rec[algo] = {"seconds": dt, "accuracy": acc, "launches": launches}
        log(f"[9] run_classify {algo:22s}: {rc.STEPS} steps in {dt:.3f} s, "
            f"train accuracy {acc:.4f}; launches "
            f"{ {nm: c for nm, c in launches.items() if c} }")
        if need_launches and launches["bucket_topk"] != rc.STEPS:
            fail(f"run_classify {algo}: bucket_topk launched "
                 f"{launches['bucket_topk']} times in {rc.STEPS} steps")
    gap = abs(rec["ssar_split_allgather"]["accuracy"]
              - rec["dense"]["accuracy"])
    if not gap <= 0.01:
        fail(f"run_classify: accuracies differ by {gap}")
    cpu = torch.device("cpu")
    data_cpu = rc.load(cpu)
    for algo in rc.ALGORITHMS:
        w_card, _ = rc.train(algo, data, rc.N_FEATURES, dev, steps=2)
        w_cpu, _ = rc.train(algo, data_cpu, rc.N_FEATURES, cpu, steps=2)
        w_card = w_card.cpu()
        atol = 1e-6 * float(w_cpu.abs().max())
        err = float(((w_card - w_cpu).abs() - 1e-5 * w_cpu.abs()).max())
        rec[algo]["two_steps_card_vs_cpu"] = err
        log(f"[9] {algo}: weights after 2 steps, card vs CPU plain path: "
            f"max (|diff| - 1e-5 |w|) {err:.3e} (limit 1e-6 max|w| = "
            f"{atol:.3e})")
        if not err <= atol:
            fail(f"run_classify {algo}: card and CPU weights disagree")
    return rec, total


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(merged, lo, hi):
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def _intersection(x, y):
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append([a, b])
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def stream_shares(torch, fn, scratch: Path):
    """Run fn() under torch.profiler and read the card's kernels from the
    trace, over the second half of the window from the first kernel's
    start to the last one's end (the first half holds the warm-up): the
    share of the window in which no kernel ran (the device's idle share),
    the shares in which the busiest stream ("main") and the others
    ("side") ran a kernel, and the share of the side streams' kernel time
    that ran beside a main-stream kernel. None when the trace holds no
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    by_stream: dict = {}
    runtime = []
    n_kernels = 0
    for e in events:
        if "dur" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_stream.setdefault(e.get("args", {}).get("stream"),
                                 []).append(span)
            n_kernels += e.get("cat") == "kernel"
        elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
            runtime.append((e.get("name"), span))
    if not by_stream:
        return None
    lo = min(a for iv in by_stream.values() for a, _ in iv)
    hi = max(b for iv in by_stream.values() for _, b in iv)
    lo = (lo + hi) / 2
    calls: dict = {}
    for name, (a, b) in runtime:
        if a >= lo and b <= hi:
            c = calls.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += (b - a) / 1e3
    top_calls = dict(sorted(calls.items(), key=lambda kv: -kv[1][1])[:8])
    main = max(by_stream, key=lambda k: _length(_union(by_stream[k]), lo, hi))
    main_u = _union(by_stream[main])
    side_u = _union([iv for k, ivs in by_stream.items() if k != main
                     for iv in ivs])
    window = hi - lo
    side = _length(side_u, lo, hi)
    return {"window_ms": window / 1e3,
            "idle_share": 1 - _length(_union(main_u + side_u), lo, hi) / window,
            "main_busy_share": _length(main_u, lo, hi) / window,
            "side_busy_share": side / window,
            "side_beside_main_share": (
                _length(_intersection(main_u, side_u), lo, hi) / side
                if side else None),
            "streams": len(by_stream), "kernels_whole_window": n_kernels,
            "runtime_calls_ms": top_calls}


# ---------------------------------------------------------------- 14, 15

def _clone_state(state):
    """A device copy of a state's params, moments and residuals (the
    tensors a bit-equality check compares)."""
    from repro_torch.utils.tree import tree_leaves

    return [t.clone() for f in ("params", "opt", "residuals")
            for t in tree_leaves(getattr(state, f))]


def _same(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _max_rel(a: list, b: list) -> float:
    """Largest |a - b| / max |b| over the tensors (0 when bit-equal)."""
    worst = 0.0
    for x, y in zip(a, b):
        if x.dtype.is_floating_point:
            scale = float(y.abs().max()) or 1.0
            worst = max(worst, float((x - y).abs().max()) / scale)
    return worst


def _params_close(a, b, rtol, atol) -> bool:
    """torch.allclose over two states' params."""
    import torch

    from repro_torch.utils.tree import tree_leaves

    return all(torch.allclose(x, y, rtol=rtol, atol=atol) for x, y in
               zip(tree_leaves(a.params), tree_leaves(b.params)))


def check_chunk_unpack(torch, reduce_half, bits, bw):
    """Phase 14: one call of the stacked scattered reduce half at lm-100m
    with the segments it hands its grouped qsgd_unpack captured (the
    chunk layout: p_pod = p_data = 1, the ranks' rows stacked); the CUDA
    launch held bit for bit against qsgd_unpack_grouped_ref on them and
    timed beside it and its bound (codes and scales read once, the f32
    chunks written once)."""
    from repro_torch.comm import executor
    from repro_torch.kernels.qsgd_unpack import ops as unpack_ops

    captured = []
    grouped = executor.qsgd_unpack_grouped

    def capture(segments, *args, **kw):
        captured.append(list(segments))
        return grouped(segments, *args, **kw)

    executor.qsgd_unpack_grouped = capture
    try:
        reduce_half()
        torch.cuda.synchronize()
    finally:
        executor.qsgd_unpack_grouped = grouped
    if len(captured) != 1:
        fail(f"scattered reduce half made {len(captured)} grouped unpack "
             "calls, expected 1")
    segs = captured[0]
    if not segs or not all(sg.p_pod == 1 and sg.p_data == 1
                           and not sg.row_major for sg in segs):
        fail("scattered reduce half: the grouped unpack's segments are not "
             "the chunk layout")
    got = unpack_ops.qsgd_unpack_grouped(segs, bits, impl="cuda")
    want = unpack_ops.qsgd_unpack_grouped(segs, bits, impl="ref")
    n_diff = sum(int((g_ != w_).sum()) for g_, w_ in zip(got, want))
    entries = sum(g_.numel() for g_ in got)
    nq = sum(sg.scale.numel() for sg in segs)
    bound = (entries * bits / 8 + 4 * nq + 4 * entries) / bw * 1e3
    run = lambda impl: unpack_ops.qsgd_unpack_grouped(segs, bits, impl=impl)
    ms = time_ms(torch, lambda: run("cuda"))
    plain = time_ms(torch, lambda: run("ref"), reps=3)
    dev_ms = graph_ms(torch, lambda: run("cuda"))
    log(f"[14] chunk-layout grouped qsgd_unpack on the scattered half's "
        f"{len(segs)} segments ({entries} entries): {n_diff} entries differ "
        f"from qsgd_unpack_grouped_ref; {ms:.3f} ms (device {dev_ms:.3f}), "
        f"plain {plain:.2f} ms, bound {bound:.3f} ms")
    if n_diff:
        fail("chunk-layout grouped qsgd_unpack differs from its plain version")
    return {"segments": len(segs), "entries": entries, "entries_differ": 0,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
            "bound_ms": bound}


CKPT_LAYERS = 2     # phases 14, 15: checkpointed runs at 2 of 12 layers


def phase_zero(torch, dev, wrappers, out_dir: Path, bw):
    """Phase 14 (see the module docstring). Returns (record, launches of
    the scattered runs)."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import run_lm
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer

    cfg, data = run_lm.lm_config(fast=False)
    model = build_model(cfg)
    tcfgs = {"full": dataclasses.replace(run_lm.train_config(STEPS),
                                         zero1=False),
             "zero1": run_lm.train_config(STEPS),
             "scattered": run_lm.train_config(STEPS, zero=True)}
    rec, at4, peaks = {}, {}, {}

    def trainer(kind, **kw):
        t = Trainer(model, tcfgs[kind], data, dp_total=run_lm.DP, device=dev,
                    **kw)
        t.init()
        return t

    def in_turns(a, b, names, rounds=3):
        """Two trainers' synchronous steps in turns (a, b, b, a), from
        their states (not advanced), each after one warm-up call."""
        batch = synthetic_batch(data, STEPS)

        def one(t):
            t0 = time.perf_counter()
            _, m = t.step_fn(t.state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        one(a), one(b)
        times = {n: [] for n in names}
        for _ in range(rounds):
            for n, t in ((names[0], a), (names[1], b), (names[1], b),
                         (names[0], a)):
                times[n].append(one(t))
        return {n: {"ms": v, "median_ms": statistics.median(v)}
                for n, v in times.items()}

    counts = {}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp = Path(tmp)
        for kind in ("zero1", "full", "scattered"):
            t = trainer(kind)
            for w in wrappers.values():
                w.launches = 0
            t.run(4)
            # the run's own peak, whatever else is live: its state's
            # bytes plus what its last steps allocate above the memory in
            # use when they start
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            t.run(STEPS)
            torch.cuda.synchronize()
            state_gb = sum(x.numel() * x.element_size()
                           for x in _leaves(t.state, ("params", "opt",
                                                      "residuals"))) / 1e9
            peaks[kind] = state_gb + (torch.cuda.max_memory_allocated()
                                      - live) / 1e9
            counts[kind] = {nm: w.launches for nm, w in wrappers.items()}
            rec[kind] = {"losses": list(t.log.losses),
                         "median_step_ms": statistics.median(
                             t.log.step_times[1:]) * 1e3,
                         "state_gb": state_gb, "peak_memory_gb": peaks[kind],
                         "launches": counts[kind]}
            log(f"[14] {kind}: losses {[round(v, 5) for v in t.log.losses]}; "
                f"median step {rec[kind]['median_step_ms']:.1f} ms; state "
                f"{state_gb:.2f} GB, peak {peaks[kind]:.2f} GB (the state and "
                f"steps 5-6's transient); launches {counts[kind]}")
            if kind == "zero1":
                z = t
            elif kind == "full":
                same_l = z.log.losses == t.log.losses
                same_s = _same(_leaves(z.state, ("params", "residuals")),
                               _leaves(t.state, ("params", "residuals")))
                rec["zero1_vs_full"] = {"losses_equal": same_l,
                                        "params_residuals_equal": same_s}
                rec["zero1_vs_full_turns"] = in_turns(z, t, ("zero1", "full"))
                log(f"[14] zero1 vs full, {STEPS} steps: losses bit-equal "
                    f"{same_l}, params and residuals bit-equal {same_s}; in "
                    f"turns (ms) {rec['zero1_vs_full_turns']}")
                if not (same_l and same_s):
                    fail("ZeRO-1 differs from the full update at lm-100m")
                del t
            else:
                s_ = t
        # scattered against replicated (zero1), synchronous
        same_s = (s_.log.losses == z.log.losses and
                  _same(_leaves(s_.state, ("params", "residuals")),
                        _leaves(z.state, ("params", "residuals"))))
        rel = max(abs(a - c) / abs(c) for a, c in zip(s_.log.losses,
                                                      z.log.losses))
        close = rel <= 1e-5 and _params_close(s_.state, z.state, 1e-3, 1e-4)
        rec["scattered_vs_replicated_sync"] = {
            "max_rel_loss": rel, "within_tolerance": close,
            "bit_equal": same_s,
            "max_param_diff_over_magnitude": _max_rel(
                _leaves(s_.state, ("params",)), _leaves(z.state, ("params",)))}
        rec["scattered_vs_zero1_turns"] = in_turns(z, s_, ("zero1",
                                                           "scattered"))
        log(f"[14] scattered vs replicated (ZeRO-1), {STEPS} synchronous "
            f"steps: max rel loss diff {rel:.2e} (rtol 1e-5), params within "
            f"rtol 1e-3 atol 1e-4 {close}, bit-equal {same_s}; in turns (ms) "
            f"{rec['scattered_vs_zero1_turns']}")
        if not close:
            fail("scattered differs from replicated beyond the reference's "
                 "tolerances")
        want = {"bucket_topk": s_.plan.num_sparse_buckets * STEPS,
                "bucket_scatter": 0,
                "bucket_scatter_sum": STEPS, "qsgd_pack": STEPS,
                "qsgd_unpack": 0, "qsgd_unpack_grouped": STEPS}
        if counts["scattered"] != want:
            fail(f"scattered launches {counts['scattered']}, expected {want}")
        # the chunk-layout unpack on the path's segments
        st = s_.state
        _, leaves = ts.rank_grads(model, st.params, ts.batch_to_device(
            synthetic_batch(data, 0), dev), run_lm.DP, s_.tcfg.microbatches)
        from repro_torch.comm.executor import reduce_buckets_spmd

        rand0 = ts.StepBits(s_.tcfg.seed, 0, dev, run_lm.DP)
        rec["chunk_unpack"] = check_chunk_unpack(
            torch, lambda: reduce_buckets_spmd(
                s_.plan, leaves, st.residuals, p_data=run_lm.DP,
                rand_fn=rand0, telemetry=False),
            s_.plan.cfg.qsgd_bits, bw)
        del leaves, st
        # a checkpoint of one layout at step 2 resumed under the other, at
        # lm-100m's widths and CKPT_LAYERS of its 12 layers (the saves and
        # restores at full depth were most of the phase's time), against
        # each layout's uninterrupted run to step 4
        shallow = build_model(dataclasses.replace(cfg,
                                                  num_layers=CKPT_LAYERS))
        for kind in ("zero1", "scattered"):
            t = Trainer(shallow, tcfgs[kind], data, dp_total=run_lm.DP,
                        device=dev)
            t.init()
            t.run(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(str(tmp / kind), t.state, dp_total=run_lm.DP,
                      opt_layout=ckpt.opt_layout_of(t.tcfg))
            save_s = time.perf_counter() - t0
            size = sum(f.stat().st_size for f in (tmp / kind).rglob("*")
                       if f.is_file())
            rec[f"{kind}_checkpoint"] = {"gb": size / 1e9, "save_s": save_s,
                                         "layers": CKPT_LAYERS}
            log(f"[14] {kind} checkpoint at step 2 ({CKPT_LAYERS} layers): "
                f"{size / 1e9:.2f} GB, saved in {save_s:.2f} s")
            t.run(4)
            at4[kind] = _clone_state(t.state)
            del t
        for src, dst in (("zero1", "scattered"), ("scattered", "zero1")):
            t0 = time.perf_counter()
            r = Trainer(shallow, tcfgs[dst], data, dp_total=run_lm.DP,
                        device=dev, ckpt_dir=str(tmp / src))
            start = r.init_or_resume()
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            r.run(4)
            same = start == 2 and _same(_clone_state(r.state), at4[dst])
            rec[f"{src}_ckpt_under_{dst}"] = {"resume_s": resume_s,
                                              "bit_equal": same}
            log(f"[14] the {src} checkpoint resumed under {dst} (converted, "
                f"{resume_s:.2f} s with the CRC check) and 2 more steps: "
                f"bit-equal to the uninterrupted {dst} run {same}")
            if not same:
                fail(f"a {src} checkpoint resumed under {dst} does not continue "
                     "bit-equal")
            del r
            gc.collect()
    at4.clear()
    gc.collect()
    # pipelined (K = 4, depth 2), from the synchronous runs' step 6, one
    # run alone on the card at a time: the ZeRO-1 run's end state waits on
    # the host while the scattered run goes; each starts from an emptied
    # allocator cache, its peak is its state plus its transient, and its
    # allocator retries (a cudaMalloc that had to free the cache first)
    # are counted
    retries, pipe_peaks, ends = {}, {}, {}
    for name, t in (("zero1", z), ("scattered", s_)):
        gc.collect()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        for w in wrappers.values():
            w.launches = 0
        t.run_pipelined(STEPS + PIPE_STEPS, staleness=1, superstep=K_UNIT,
                        depth=2)
        torch.cuda.synchronize()
        retries[name] = torch.cuda.memory_stats().get(
            "num_alloc_retries", 0) - r0
        pipe_peaks[name] = (sum(x.numel() * x.element_size() for x in _leaves(
            t.state, ("params", "opt", "residuals", "inflight")))
            + torch.cuda.max_memory_allocated() - live) / 1e9
        ends[name] = [x.cpu() for x in _leaves(t.state, ("params",
                                                         "residuals"))]
        t.state = None
    pipe_launches = {nm: w.launches for nm, w in wrappers.items()}
    zl, sl = z.log.losses[STEPS:], s_.log.losses[STEPS:]
    rel = max(abs(a - c) / abs(c) for a, c in zip(sl, zl))
    n_params = len(_leaves_of_params(model))
    close = rel <= 1e-5 and all(
        torch.allclose(x, y, rtol=1e-3, atol=1e-4) for x, y in
        zip(ends["scattered"][:n_params], ends["zero1"][:n_params]))
    same_p = sl == zl and _same(ends["scattered"], ends["zero1"])
    s_ms, s_units = steady_ms(s_.log.step_times[STEPS:])
    z_ms, z_units = steady_ms(z.log.step_times[STEPS:])
    rec["pipelined"] = {"zero1_losses": zl, "scattered_losses": sl,
                        "max_rel_loss": rel, "within_tolerance": close,
                        "bit_equal": same_p, "zero1_ms_a_step": z_ms,
                        "scattered_ms_a_step": s_ms,
                        "zero1_unit_retire_ms": z_units,
                        "scattered_unit_retire_ms": s_units,
                        "peak_memory_gb": pipe_peaks,
                        "alloc_retries": retries,
                        "scattered_launches": pipe_launches}
    log(f"[14] pipelined (K = {K_UNIT}, depth 2), {PIPE_STEPS} steps: "
        f"scattered vs replicated max rel loss diff {rel:.2e}, params within "
        f"tolerance {close}, bit-equal {same_p}; ms a step {s_ms:.1f} / "
        f"{z_ms:.1f} (unit retire ms {[round(u, 1) for u in s_units]} / "
        f"{[round(u, 1) for u in z_units]}); peak "
        f"{ {n: round(v, 2) for n, v in pipe_peaks.items()} } GB; allocator "
        f"retries {retries}; scattered launches {pipe_launches}")
    if not close:
        fail("pipelined scattered differs from replicated beyond the "
             "reference's tolerances")
    want = {nm: c // STEPS * PIPE_STEPS for nm, c in want.items()}
    if pipe_launches != want:
        fail(f"pipelined scattered launches {pipe_launches}, expected {want}")
    launches = {nm: counts["scattered"][nm] + pipe_launches[nm]
                for nm in wrappers}
    return rec, launches


def _leaves(state, fields):
    from repro_torch.utils.tree import tree_leaves

    return [t for f in fields for t in tree_leaves(getattr(state, f))
            if t is not None]


def _leaves_of_params(model):
    from repro_torch.models.model import init_params
    from repro_torch.utils.tree import tree_leaves

    return tree_leaves(init_params(model.cfg, device="meta"))


SIGTERM_SCRIPT = """
import dataclasses
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch import obs as obs_mod
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models.model import build_model
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.runtime.driver import DriverConfig, run_pipelined
from repro_torch.runtime.faults import FaultInjector, FaultPlan
from repro_torch.runtime.pipeline import build_pipelined_step
from repro_torch.train import run_lm
from repro_torch.train import train_step as ts
from repro_torch.utils.tree import tree_leaves

cfg, data = run_lm.lm_config(fast=False)
model = build_model(dataclasses.replace(cfg, num_layers=int(sys.argv[3])))
tcfg = run_lm.train_config(8)
step, plan = build_pipelined_step(model, tcfg, run_lm.DP, "cuda",
                                  staleness=0, guard=True, inject=True,
                                  telemetry=False)
state = ts.init_state(model, tcfg, plan, "cuda")
obs = obs_mod.configure(metrics=True, set_as_default=False)
obs.recorder = FlightRecorder(sys.argv[2], obs=obs)
obs.recorder.install_signal_handlers(("SIGTERM",))
inj = FaultInjector(FaultPlan.single("sigterm", 2)).bind(
    n_leaves=len(tree_leaves(state.params)))
run_pipelined(step, state, start_step=0, num_steps=4,
              batch_fn=lambda s: synthetic_batch(data, s),
              cfg=DriverConfig(depth=1, prefetch=1), obs=obs, injector=inj)
print("the run outlived its SIGTERM")
"""




def phase_faults(torch, dev, wrappers, out_dir: Path):
    """Phase 15 (see the module docstring). Returns (record, launches of
    the injected runs)."""
    import numpy as np

    from repro_torch import obs as obs_mod
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.runtime.driver import DriverConfig, run_pipelined
    from repro_torch.runtime.faults import (FAULT_KEY, FaultInjector,
                                            FaultPlan, FaultSpec,
                                            RecoveryConfig)
    from repro_torch.runtime.pipeline import (attach_inflight,
                                              build_pipelined_step)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import run_lm
    from repro_torch.train import train_step as ts
    from repro_torch.utils.tree import tree_leaves

    cfg, data = run_lm.lm_config(fast=False)
    model = build_model(cfg)
    tcfg = run_lm.train_config(100)
    rec: dict = {}
    total = {nm: 0 for nm in wrappers}

    def count():
        for nm, w in wrappers.items():
            total[nm] += w.launches
            w.launches = 0

    def batch(i, flag=None, n=None):
        b = synthetic_batch(data, i)
        if flag is not None:
            b[FAULT_KEY] = np.full(n, flag, np.float32)
        return b

    # -- a single trip through the kernels on both lowerings
    for lowering in ("spmd", "manual"):
        step, plan = build_pipelined_step(model, tcfg, run_lm.DP, dev,
                                          guard=True, inject=True,
                                          lowering=lowering)
        state = attach_inflight(ts.init_state(model, tcfg, plan, dev), plan)
        n = len(tree_leaves(state.params))
        for i in range(2):
            state, _ = step(state, batch(i, 0.0, n))
        step.drain()
        before = _clone_state(state) + [t.clone() for t in
                                        tree_leaves(state.inflight)]
        count()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                after, m = step(state, batch(2, 1.0, n))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]
        step.drain()
        torch.cuda.synchronize()
        trip = {nm: w.launches for nm, w in wrappers.items()}
        same = (float(m["nonfinite"]) == 1.0 and after.step == state.step + 1
                and _same(_clone_state(after) + list(tree_leaves(
                    after.inflight)), before))
        rec[f"trip_{lowering}"] = {"bit_equal": same, "launches": trip,
                                   "syncs_in_step": syncs[:10]}
        log(f"[15] one NaN step ({lowering}): params, moments, residuals and "
            f"in-flight buffers bit-equal to before {same}; its launches "
            f"{trip}; host syncs inside the step {len(syncs)}")
        if not same or not trip["bucket_topk"] or not trip["qsgd_pack"]:
            fail(f"the guard trip ({lowering}) moved the state or ran no "
                 "kernels")
        if syncs:
            fail(f"the injected step synchronised the host: {syncs[:3]}")
        count()
        del step, state, after, before
        gc.collect()
    torch.cuda.empty_cache()

    # -- the driver's recovery matrix (staleness 0: a rewind loses nothing)
    #    at lm-100m's widths and CKPT_LAYERS of its 12 layers: its
    #    checkpoint saves and restores are most of the phase's time
    n_steps = 6
    shallow = build_model(dataclasses.replace(cfg, num_layers=CKPT_LAYERS))
    step, plan = build_pipelined_step(shallow, tcfg, run_lm.DP, dev,
                                      staleness=0, guard=True, inject=True,
                                      telemetry=False)
    n_leaves = len(tree_leaves(ts.init_state(shallow, tcfg, plan,
                                             dev).params))

    def drive(specs, ckpt_dir=None, recovery=None, every=None):
        obs = obs_mod.configure(metrics=True, set_as_default=False)
        inj = FaultInjector(FaultPlan(specs=tuple(specs))).bind(
            n_leaves=n_leaves)
        ckpt_fn = restore_fn = None
        io = {"save_s": [], "restore_s": [], "restored_steps": []}
        if ckpt_dir is not None:
            def ckpt_fn(s):
                t0 = time.perf_counter()
                ckpt.save(ckpt_dir, s, dp_total=run_lm.DP,
                          opt_layout=ckpt.opt_layout_of(tcfg))
                io["save_s"].append(time.perf_counter() - t0)
                inj.corrupt_checkpoint(ckpt_dir, int(s.step))

            def restore_fn():
                # the newest checkpoint whose CRCs verify, checked as it
                # is read (one read), as Trainer restores
                t0 = time.perf_counter()
                like = ts.init_state(shallow, tcfg, plan, dev)
                at, out = ckpt.restore_newest_valid(
                    ckpt_dir, lambda step: ckpt.restore(
                        ckpt_dir, like, dp_total=run_lm.DP, step=step,
                        verify=True))
                torch.cuda.synchronize()
                io["restore_s"].append(time.perf_counter() - t0)
                io["restored_steps"].append(at)
                return out

        t0 = time.perf_counter()
        state, dlog = run_pipelined(
            step, ts.init_state(shallow, tcfg, plan, dev), start_step=0,
            num_steps=n_steps, batch_fn=lambda s: synthetic_batch(data, s),
            cfg=DriverConfig(depth=1, prefetch=1), ckpt_every=every,
            ckpt_fn=ckpt_fn, restore_fn=restore_fn, obs=obs,
            recovery=recovery, injector=inj)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        count()
        reg = obs.metrics
        events = {
            "injected": [[e["fault"], e["step"]]
                         for e in reg.events_named("faults/injected")],
            "restarts": [e["error"] for e in reg.events_named(
                "driver/restart")],
            "retries": [e["cls"] for e in reg.events_named("recovery/retry")],
            "restored_from": io["restored_steps"]}
        return state, dlog, events, wall, io

    clean, clean_log, _, clean_wall, _ = drive([])
    clean_state = _clone_state(clean)
    del clean
    fast = RecoveryConfig(max_consecutive_nonfinite=2, backoff_base_s=0.01,
                          backoff_max_s=0.1)
    # each case's faults, its checkpoint interval (one save before the
    # fault, two where a corrupted save needs an older one to fall back
    # to) and what the run's events must name: the injections, the
    # restarts' exceptions, the supervisor's classes and the checkpoint
    # each restore read
    cases = {
        "nonfinite_escalation": (
            [FaultSpec(kind="nonfinite", step=3,
                       repeat=fast.max_consecutive_nonfinite)], 3,
            {"injected": [["nonfinite", 3], ["nonfinite", 4]],
             "restarts": ["NonFiniteEscalation"], "retries": ["nonfinite"],
             "restored_from": [3]}),
        "collective": (
            [FaultSpec(kind="collective", step=4)], 3,
            {"injected": [["collective", 4]],
             "restarts": ["FaultInjectionError"], "retries": ["collective"],
             "restored_from": [3]}),
        "ckpt_corrupt_then_collective": (
            [FaultSpec(kind="ckpt_corrupt", step=4),
             FaultSpec(kind="collective", step=5)], 2,
            {"injected": [["ckpt_corrupt", 4], ["collective", 5]],
             "restarts": ["FaultInjectionError"], "retries": ["collective"],
             "restored_from": [2]}),
        "straggler_and_stall": (
            [FaultSpec(kind="straggler", step=2, duration_s=0.5),
             FaultSpec(kind="stall", step=3, duration_s=0.5)], None,
            {"injected": [["straggler", 2], ["stall", 3]],
             "restarts": [], "retries": [], "restored_from": []}),
    }
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        for name, (specs, every, want) in cases.items():
            d = None if every is None else str(Path(tmp) / name)
            state, dlog, events, wall, io = drive(specs, d, fast, every)
            same = (state.step == n_steps and
                    _same(_clone_state(state), clean_state))
            # the steps replayed from the last restore (all of them when
            # none ran) retire the clean run's losses
            r = io["restored_steps"][-1] if io["restored_steps"] else 0
            tail = dlog.losses[-(n_steps - r):] == clean_log.losses[r:]
            # the stall fires on the prefetch thread, ahead of the retires
            named = ({**events, "injected": sorted(events["injected"])}
                     == {**want, "injected": sorted(want["injected"])})
            rec[name] = {"bit_equal": same, "tail_losses_equal": tail,
                         "events": events, "events_as_planned": named,
                         "restarts": dlog.restarts, "wall_s": wall,
                         "step_times_s": list(dlog.step_times), **io}
            log(f"[15] {name}: {dlog.restarts} restart(s), final state "
                f"bit-equal to the clean run {same}, replayed losses equal "
                f"{tail}; events {events} (as planned {named}); {wall:.1f} s "
                f"(clean {clean_wall:.1f} s); saves "
                f"{[round(v, 2) for v in io['save_s']]} s, restores "
                f"{[round(v, 2) for v in io['restore_s']]} s (one verified "
                f"read each)")
            if not (same and tail and named):
                fail(f"fault case {name} did not recover as planned")
            del state
            gc.collect()
    # -- an idle injector against none: the pipelined step in turns
    steps = {}
    for inject in (False, True):
        steps[inject], plan = build_pipelined_step(
            model, tcfg, run_lm.DP, dev, guard=True, inject=inject)
    st = attach_inflight(ts.init_state(model, tcfg, plan, dev), plan)
    n = len(tree_leaves(st.params))

    def one(inject):
        b = batch(0, 0.0, n) if inject else batch(0)
        t0 = time.perf_counter()
        out, m = steps[inject](st, b)
        steps[inject].drain()
        float(m["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    one(False), one(True)
    turns = {"none": [], "idle": []}
    for _ in range(3):
        for inject in (False, True, True, False):
            turns["idle" if inject else "none"].append(one(inject))
    med = {k: statistics.median(v) for k, v in turns.items()}
    rec["idle_injector_turns"] = {"ms": turns, "median_ms": med}
    log(f"[15] the pipelined step with an idle injector against none, in "
        f"turns (ms): {turns}; medians {med['idle']:.1f} / {med['none']:.1f} "
        f"({med['idle'] / med['none'] - 1:+.2%})")
    count()
    del st, steps
    gc.collect()
    torch.cuda.empty_cache()
    # -- SIGTERM in a child process: its blackbox is written, it dies
    bb = out_dir / "sigterm_blackbox.json"
    bb.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SIGTERM_SCRIPT, str(SRC),
                           str(bb), str(CKPT_LAYERS)], capture_output=True,
                          text=True, timeout=300)
    reason = json.loads(bb.read_text())["reason"] if bb.exists() else None
    rec["sigterm"] = {"returncode": proc.returncode, "blackbox_reason": reason,
                      "seconds": time.perf_counter() - t0}
    log(f"[15] SIGTERM at step 2 of a child run at lm-100m's widths and "
        f"{CKPT_LAYERS} layers: exit code "
        f"{proc.returncode}, blackbox reason {reason!r}, "
        f"{rec['sigterm']['seconds']:.1f} s")
    if proc.returncode != -15 or reason != "signal:SIGTERM":
        fail(f"the SIGTERM child: exit {proc.returncode}, blackbox {reason!r}"
             f"; stderr {proc.stderr[-2000:]}")
    bb.unlink(missing_ok=True)
    return rec, total


# ---------------------------------------------------------------- 16

SERVE_SLOTS = 8        # phase 16: decode slots (static batch and continuous)
SERVE_CACHE = 1024     # cache length
SERVE_REQUESTS = 32    # the continuous trace's requests
MARGIN = 1e-4          # a greedy token may differ only below this top-2 gap


def _serve_trace(vocab: int, n: int = SERVE_REQUESTS):
    """Phase 16's requests (phase 17 takes the first ``n``): Poisson
    arrivals at 0.5 a decode step (seed 0), prompts of 16-512 tokens and
    32-128 new tokens, drawn by numpy.random.default_rng(0)."""
    import numpy as np

    from repro_torch.serve import Request, poisson_trace

    rng = np.random.default_rng(0)
    arrivals = poisson_trace(SERVE_REQUESTS, rate=0.5, seed=0)
    lens = rng.integers(16, 513, SERVE_REQUESTS)
    news = rng.integers(32, 129, SERVE_REQUESTS)
    reqs = [Request(rid=i, prompt=rng.integers(0, vocab, int(lens[i])),
                    max_new_tokens=int(news[i]), arrival=float(arrivals[i]))
            for i in range(SERVE_REQUESTS)]
    return reqs[:n]


def _greedy_margins(torch, engine, prompts, n: int):
    """ServeEngine.generate's loop, keeping each step's top-2 logit gap:
    (tokens (B, n), margins (B, n)) of a reference run."""
    import numpy as np

    from repro_torch.serve.engine import greedy

    toks = torch.from_numpy(np.asarray(prompts, np.int32)).to(engine.device)
    logits, state = engine.prefill_fn(engine.params, {"tokens": toks})
    out, margins = [], []
    for i in range(n):
        top = torch.topk(logits, 2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
        cur = greedy(logits)[:, None]
        out.append(cur)
        if i + 1 < n:
            logits, state = engine.decode_fn(engine.params, state, cur)
    return (torch.cat(out, 1).cpu().numpy(),
            torch.stack(margins, 1).cpu().numpy())


def _first_mismatch(got, want, margins) -> dict | None:
    """Where two greedy runs part (None if they do not): the index, both
    tokens, and the reference run's top-2 gap there. Tokens after it
    continue another context and are not compared."""
    import numpy as np

    diff = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    if not diff.size:
        return None
    i = int(diff[0])
    return {"index": i, "got": int(got[i]), "want": int(want[i]),
            "margin": float(margins[i])}


def _margin_rule(where: str, mismatches: list) -> None:
    for m in mismatches:
        log(f"[16] {where}: token {m['index']} of {m.get('rid', '-')} "
            f"differs ({m['got']} vs {m['want']}) at a reference top-2 gap "
            f"of {m['margin']:.3e}")
    wide = [m for m in mismatches if not m["margin"] < MARGIN]
    if wide:
        fail(f"{where}: {len(wide)} greedy token(s) differ at a clear "
             f"margin (>= {MARGIN}): {wide[:3]}")


def _spans(obs, name: str) -> list:
    return [e for e in obs.tracer.events if e.get("name") == name]


def phase_serve(torch, dev, wrappers, out_dir: Path):
    """Phase 16 (see the module docstring). Returns (record, launches of
    the serving runs)."""
    import numpy as np

    from repro_torch import obs as obs_mod
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.comm.executor import (exchange_activation,
                                           exchange_activation_spmd)
    from repro_torch.comm.plan import build_serve_plan
    from repro_torch.core import sparse_stream as ss
    from repro_torch.models.model import build_model
    from repro_torch.runtime.faults import FaultInjector, FaultPlan
    from repro_torch.serve import (ContinuousServeEngine, ServeConfig,
                                   ServeEngine, run_serve, sparse_decode)
    from repro_torch.serve.engine import greedy
    from repro_torch.train import run_lm
    from repro_torch.utils.calibrate import calibrate

    rec: dict = {}
    for w in wrappers.values():
        w.launches = 0
    base_gb = torch.cuda.memory_allocated() / 1e9   # what earlier phases hold
    cfg, _ = run_lm.lm_config(fast=False)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    vocab = cfg.vocab_size

    # -- static: ServeEngine.generate, 8 prompts of 128, 64 new tokens
    eng = ServeEngine(model, params, cache_len=SERVE_CACHE, device=dev)
    prompts = np.random.default_rng(0).integers(
        0, vocab, (SERVE_SLOTS, 128)).astype(np.int32)
    walls, outs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(eng.generate(prompts, max_new_tokens=64))
        walls.append(time.perf_counter() - t0)
    toks = torch.from_numpy(prompts).to(dev)
    prefill_ms = time_ms(torch, lambda: eng.prefill_fn(params,
                                                       {"tokens": toks}))
    logits, st = eng.prefill_fn(params, {"tokens": toks})
    cur = greedy(logits)[:, None]
    step_ms = []
    for _ in range(63):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, st = eng.decode_fn(params, st, cur)
        cur = greedy(logits)[:, None]
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
    del st, logits

    # -- a step's read-back either way: the B greedy tokens taken on the
    #    device (the engines') or the (B, V) logits copied to the host and
    #    np.argmax there (the reference's), 20 steps in turns, and each
    #    way's idle share over the last 20 of 40 profiled steps
    def steps_with(way: str, n: int) -> float:
        logits, st = eng.prefill_fn(params, {"tokens": toks})
        cur = greedy(logits)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            logits, st = eng.decode_fn(params, st, cur)
            if way == "device":
                cur = greedy(logits)
                cur.cpu()
                cur = cur[:, None]
            else:
                host = np.argmax(logits.cpu().numpy(), axis=-1)
                cur = torch.from_numpy(host.astype(np.int32)[:, None]).to(dev)
        return (time.perf_counter() - t0) / n * 1e3

    logits, st = eng.prefill_fn(params, {"tokens": toks})
    cur = greedy(logits)[:, None]

    def ten_steps():
        nonlocal st, cur
        for _ in range(10):
            logits, st = eng.decode_fn(params, st, cur)
            cur = greedy(logits)[:, None]

    ten = stream_shares(torch, ten_steps, out_dir)
    kernels_a_step = ten["kernels_whole_window"] / 10 if ten else None
    del st, logits
    ways = {"device": [], "host": []}
    for _ in range(2):
        for way in ("device", "host", "host", "device"):
            ways[way].append(steps_with(way, 20))
    readback = {w: {"step_ms": v, "median_ms": statistics.median(v),
                    "profile": stream_shares(torch, lambda w=w:
                                             steps_with(w, 40), out_dir)}
                for w, v in ways.items()}
    log("[16] a decode step with its read-back, in turns (host clock, ms): "
        + "; ".join(f"{w}: median {r['median_ms']:.3f} {r['step_ms']}, idle "
                    f"share {r['profile'] and r['profile']['idle_share']}"
                    for w, r in readback.items()))
    log(f"[16] kernels a decode step (10 profiled steps of 8 slots): "
        f"{kernels_a_step}")
    static = {"bit_equal_rerun": bool(np.array_equal(*outs)),
              "kernels_a_decode_step": kernels_a_step,
              "readback_ways": readback,
              "wall_s": walls, "prefill_ms": prefill_ms,
              "decode_step_ms_median": statistics.median(step_ms),
              "decode_step_ms": step_ms,
              "tok_per_s": outs[1].size / walls[1],
              "tok_per_s_first_call": outs[0].size / walls[0]}
    rec["static"] = static
    log(f"[16] static lm-100m, {SERVE_SLOTS} x 128-token prompts, 64 new "
        f"tokens, cache {SERVE_CACHE}: {walls[0]:.3f} s first call, "
        f"{walls[1]:.3f} s rerun ({static['tok_per_s']:.0f} tok/s), rerun "
        f"bit-equal {static['bit_equal_rerun']}; prefill {prefill_ms:.3f} "
        f"ms; decode step median {static['decode_step_ms_median']:.3f} ms "
        f"(CUDA events, 63 steps)")
    if not static["bit_equal_rerun"]:
        fail("the static engine's rerun differs")

    # -- continuous: 32 requests over 8 slots; first calls, then the
    #    steady state, whose host waits are counted: CUDA sync debug mode
    #    flags each, and the engine's read-backs are counted beside
    reqs = _serve_trace(vocab)
    runs, obss = [], []
    ceng = ContinuousServeEngine(model, params, cache_len=SERVE_CACHE,
                                 batch_size=SERVE_SLOTS, device=dev)
    ceng.obs = obs_mod.configure(trace=True, metrics=True,
                                 set_as_default=False)
    runs.append(ceng.run(reqs))
    obss.append(ceng.obs)
    ceng.obs = obs_mod.configure(trace=True, metrics=True,
                                 set_as_default=False)
    counted = []
    real_readback = sparse_decode._readback
    sparse_decode._readback = lambda t: (counted.append(t.shape[0])
                                         or real_readback(t))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                runs.append(ceng.run(reqs))
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        sparse_decode._readback = real_readback
    obss.append(ceng.obs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = runs[1]
    outputs = res.outputs
    steps = [e["dur"] / 1e3 for e in _spans(obss[1], "serve/decode_step")]
    admit = {}
    for i, o in enumerate(obss):
        for e in _spans(o, "serve/admit"):
            admit.setdefault(e["args"]["prompt_len"], [None, None])[i] = \
                e["dur"] / 1e3
    per_step_ms = res.wall_s / res.decode_steps * 1e3
    lat = {k: {q: v[q] for q in ("p50", "p99")}
           for k, v in res.latency.items()}
    lat_ms = {k: {q: v * per_step_ms for q, v in d.items()}
              for k, d in lat.items()}
    admit_rows = sorted((n, f, s) for n, (f, s) in admit.items())
    cont = {"requests": SERVE_REQUESTS, "decode_steps": res.decode_steps,
            "tokens": res.tokens, "wall_s": [r.wall_s for r in runs],
            "tok_per_s": res.tok_per_s,
            "tok_per_s_first_run": runs[0].tok_per_s,
            "decode_step_ms_median": statistics.median(steps),
            "decode_step_ms_p90": float(np.percentile(steps, 90)),
            "wall_ms_per_decode_step": per_step_ms,
            "latency_steps": lat, "latency_ms": lat_ms,
            "admit_ms_by_prompt_len": admit_rows,
            "admit_ms_first_median": statistics.median(
                f for _, f, _ in admit_rows),
            "admit_ms_steady_median": statistics.median(
                s for _, _, s in admit_rows),
            "peak_memory_gb": peak_gb,
            "peak_memory_serving_gb": peak_gb - base_gb,
            "rerun_equal": all(np.array_equal(outputs[r], runs[0].outputs[r])
                               for r in outputs),
            "occupancy_mean": float(np.mean([r["active"]
                                             for r in res.step_log]))}
    rec["continuous"] = cont
    log(f"[16] continuous lm-100m, {SERVE_REQUESTS} requests (Poisson 0.5 a "
        f"step, prompts 16-512, 32-128 new), {SERVE_SLOTS} slots, cache "
        f"{SERVE_CACHE}: {res.tokens} tokens in {res.decode_steps} decode "
        f"steps, {res.wall_s:.3f} s ({res.tok_per_s:.0f} tok/s; first run "
        f"{runs[0].wall_s:.3f} s); decode step median "
        f"{cont['decode_step_ms_median']:.3f} ms (p90 "
        f"{cont['decode_step_ms_p90']:.3f}); mean occupancy "
        f"{cont['occupancy_mean']:.2f}; peak memory {peak_gb:.2f} GB, of "
        f"which serving's own (above the {base_gb:.2f} GB the earlier phases "
        f"hold) {peak_gb - base_gb:.2f} GB")
    log(f"[16] latency p50/p99 in decode steps {lat}; in ms (x "
        f"{per_step_ms:.3f} ms a step) {lat_ms}")
    log(f"[16] admission ms (prefill B = 1 + splice + first token), first "
        f"call / steady, median {cont['admit_ms_first_median']:.3f} / "
        f"{cont['admit_ms_steady_median']:.3f}; by prompt length "
        f"{[(n, round(f, 3), round(s, 3)) for n, f, s in admit_rows]}")
    if not cont["rerun_equal"] or set(outputs) != set(range(SERVE_REQUESTS)):
        fail("the continuous engine's rerun differs or lost requests")

    # -- one host wait a decode step (and one an admission)
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    per_step = (syncs - SERVE_REQUESTS) / res.decode_steps
    cont["host_syncs"] = {"flagged": syncs, "readbacks": len(counted),
                          "decode_steps": res.decode_steps,
                          "admissions": SERVE_REQUESTS,
                          "per_decode_step": per_step}
    log(f"[16] host synchronisations flagged (CUDA sync debug mode): {syncs} "
        f"over {res.decode_steps} decode steps and {SERVE_REQUESTS} "
        f"admissions: {per_step:.3f} a decode step; engine read-backs "
        f"{len(counted)}")
    if syncs != len(counted) or per_step != 1.0:
        fail(f"host syncs: {syncs} flagged, {len(counted)} read-backs, "
             f"{per_step} a decode step (expected exactly 1)")

    # -- each request against its own B = 1 generate (the margin rule)
    one = ServeEngine(model, params, cache_len=SERVE_CACHE, device=dev)
    t0 = time.perf_counter()
    bad = []
    for r in reqs:
        want = one.generate(r.prompt[None], r.max_new_tokens)[0]
        if len(outputs[r.rid]) != len(want):
            fail(f"request {r.rid}: {len(outputs[r.rid])} tokens, its "
                 f"generate {len(want)}")
        if np.array_equal(outputs[r.rid], want):
            continue
        _, margins = _greedy_margins(torch, one, r.prompt[None],
                                     r.max_new_tokens)
        m = _first_mismatch(outputs[r.rid], want, margins[0])
        bad.append({"rid": r.rid, **m})
    cont["per_request"] = {"mismatches": bad,
                           "seconds": time.perf_counter() - t0}
    log(f"[16] continuous vs each request's B = 1 generate: "
        f"{SERVE_REQUESTS - len(bad)} of {SERVE_REQUESTS} equal token for "
        f"token ({cont['per_request']['seconds']:.1f} s)")
    _margin_rule("continuous vs B = 1 generate", bad)
    del one

    # -- the card's idle share over the last 20 of 40 decode steps
    from repro_torch.serve import Request

    rng = np.random.default_rng(1)
    full = [Request(rid=i, prompt=rng.integers(0, vocab, 128),
                    max_new_tokens=41) for i in range(SERVE_SLOTS)]
    ceng.obs = obs_mod.OFF
    shares = stream_shares(torch, lambda: ceng.run(full), out_dir)
    if shares is None:
        fail("the profiled decode steps ran no kernel on the card")
    cont["profile"] = shares
    log(f"[16] profiler, {SERVE_SLOTS} requests of 41 tokens admitted at "
        f"once, second half of the window (the last 20 decode steps): idle "
        f"share {shares['idle_share']:.3f}; {shares}")

    # -- faults: collective raises before decode ticks, retried
    plan = FaultPlan.chaos(0, res.decode_steps,
                           classes=("collective",) * 3)
    inj = FaultInjector(plan)
    fobs = obs_mod.configure(metrics=True, set_as_default=False)
    feng = ContinuousServeEngine(model, params, cache_len=SERVE_CACHE,
                                 batch_size=SERVE_SLOTS, device=dev,
                                 obs=fobs, injector=inj)
    fres = feng.run(reqs)
    retries = fobs.metrics.events_named("recovery/serve_retry")
    chaos_same = set(fres.outputs) == set(outputs) and all(
        np.array_equal(fres.outputs[r], outputs[r]) for r in outputs)
    rec["chaos"] = {"plan": [(s.kind, s.step) for s in plan.specs],
                    "fired": inj.fired_total, "retry_events": len(retries),
                    "outputs_equal": chaos_same, "wall_s": fres.wall_s}
    log(f"[16] chaos plan {rec['chaos']['plan']}: fired {inj.fired_total}, "
        f"recovery/serve_retry events {len(retries)}, outputs equal to the "
        f"unfaulted run {chaos_same} ({fres.wall_s:.3f} s)")
    if not chaos_same or inj.fired_total != 3 or len(retries) != 3:
        fail("the chaos run's outputs or its retry events are not the plan's")
    del feng

    # -- shedding: a bounded queue accounts for every request exactly once
    seng = ContinuousServeEngine(model, params, cache_len=SERVE_CACHE,
                                 batch_size=SERVE_SLOTS, device=dev,
                                 serve_cfg=ServeConfig(queue_limit=2))
    sres = seng.run(reqs)
    once = (set(sres.outputs) | set(sres.shed) == set(range(SERVE_REQUESTS))
            and not set(sres.outputs) & set(sres.shed))
    served_same = all(np.array_equal(sres.outputs[r], outputs[r])
                      for r in sres.outputs)
    rec["shed"] = {"shed": len(sres.shed), "served": len(sres.outputs),
                   "exactly_once": once, "served_equal": served_same,
                   "health": [e.rule for e in sres.health]}
    log(f"[16] queue_limit 2: {len(sres.outputs)} served, {len(sres.shed)} "
        f"shed ({sorted(set(sres.shed.values()))}), each exactly once "
        f"{once}; served outputs equal to the unloaded run's {served_same}")
    if not once or not sres.shed or not served_same:
        fail("the shedding run lost, doubled or changed a request")
    del seng, ceng

    # -- card against CPU: lm-100m at 2 layers, the same params
    small, cpu_params = run_serve.build(True, device="cpu")
    card_params = _to(cpu_params, dev)
    toks = np.random.default_rng(2).integers(0, vocab, (2, 80)).astype(
        np.int32)
    sides = {"cpu": (torch.device("cpu"), cpu_params),
             "card": (dev, card_params)}
    logits = {}
    for where, (d, p) in sides.items():
        t = torch.from_numpy(toks).to(d)
        lg, st = small.prefill(p, {"tokens": t[:, :64]}, 128)
        seq = [lg.cpu()]
        for i in range(64, 80):
            lg, st = small.decode_step(p, st, t[:, i:i + 1])
            seq.append(lg.cpu())
        logits[where] = torch.stack(seq).numpy()
    want = logits["cpu"]
    err = float(np.abs(logits["card"] - want).max())
    close = bool(np.allclose(logits["card"], want, rtol=1e-5,
                             atol=1e-5 * float(np.abs(want).max())))
    greedy_runs = {}
    for where, (d, p) in sides.items():
        e = ServeEngine(small, p, cache_len=128, device=d)
        greedy_runs[where] = _greedy_margins(torch, e, toks[:, :64], 32)
    (card_toks, _), (cpu_toks, cpu_margins) = (greedy_runs["card"],
                                               greedy_runs["cpu"])
    bad = [{"rid": b, **m} for b in range(2)
           if (m := _first_mismatch(card_toks[b], cpu_toks[b],
                                    cpu_margins[b])) is not None]
    rec["card_vs_cpu"] = {"max_abs_err": err, "allclose": close,
                          "greedy_mismatches": bad}
    log(f"[16] lm-100m at 2 layers, card vs CPU: teacher-forced logits "
        f"(prefill 64, 16 decode steps) max abs err {err:.3e}, allclose "
        f"(rtol 1e-5, floor 1e-5 of the largest) {close}; greedy 32 tokens "
        f"x 2: {2 - len(bad)} of 2 equal")
    if not close:
        fail("card and CPU decode logits disagree")
    _margin_rule("card vs CPU greedy", bad)
    del card_params, small, sides

    # -- the activation exchange and its row streams
    ex = {}
    for p in (2, 4):
        rng = np.random.default_rng(p)
        parts = np.zeros((p, 8, 768), np.float32)
        for s_ in range(p):
            for r in rng.choice(8, 3, replace=False):
                parts[s_, r] = rng.standard_normal(768)
        x = torch.from_numpy(parts).to(dev)
        dense = exchange_activation_spmd(x, "dense")
        sparse = exchange_activation_spmd(x, "stream_gather@4")
        coll = StackedCollectives(p, device=dev)
        per_rank = exchange_activation(x, "stream_gather@4", coll=coll)
        st = ss.from_row_mask(x[0], (x[0] != 0).any(-1), 4)
        over = ss.from_row_mask(x[0] + 1.0, torch.ones(
            8, dtype=torch.bool, device=dev), 4)
        back = ss.densify_rows(over, 8)
        net = calibrate(coll)
        aud = obs_mod.audit_serve_plan(
            build_serve_plan(p, 8, 768).replan(algorithms={
                "act0": "stream_gather@4"}), net=net, device=dev)
        ex[p] = {"sparse_equals_dense": torch.equal(dense, sparse),
                 "per_rank_equals": all(torch.equal(per_rank[r], dense)
                                        for r in range(p)),
                 "roundtrip": torch.equal(ss.densify_rows(st, 8), x[0]),
                 "clamp": (int(over.nnz) == 4 and torch.equal(
                     back[:4], x[0, :4] + 1.0) and not back[4:].any()),
                 "audit": aud.samples}
        log(f"[16] exchange p = {p}, T = 8, d = 768, 3 rows a shard under "
            f"capacity 4: " + ", ".join(f"{k} {v}" for k, v in ex[p].items()
                                        if k != "audit")
            + f"; audit (measured / predicted s) "
            f"{[(a['measured_s'], a['predicted_s']) for a in aud.samples]}")
        if not all(v for k, v in ex[p].items() if k != "audit"):
            fail(f"the activation exchange at p = {p}: {ex[p]}")
    rec["exchange"] = {str(k): {kk: vv for kk, vv in v.items()}
                       for k, v in ex.items()}
    launches = {nm: w.launches for nm, w in wrappers.items()}
    log(f"[16] kernel launches while serving: {launches} (no TPU kernel "
        f"lies on the serving path)")
    del params, model
    return rec, launches


# ---------------------------------------------------------------- 17

MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_TRAIN_LAYERS = 1       # 17a: 48 -> 1 layers, every width as published
MOE_TRAIN_STEPS = 4
MOE_TRAIN_R = 2            # replicas (R = 4 does not fit the card: PERF.md)
MOE_SEQ = 512              # one 512-token row a rank a microbatch
MOE_SERVE_LAYERS = 4       # 17b: 48 -> 4 layers, f32
MOE_SERVE_REQUESTS = 16
MOE_P_MODEL = 2            # expert shards of the serve combine
MOE_TOPK_SAMPLE = 64       # 17a: every 64th bucket_topk input is checked
MOE_SMALL_STEPS = 3        # 17c: the first (lr 0) and two that update


def _moe_serve_cfg(torch, layers: int):
    from repro_torch import configs

    return configs.get_config(MOE_ARCH, num_layers=layers,
                              dtype=torch.float32, param_dtype=torch.float32)


def check_step_kernels(torch, reduce_half, bits: int, mode: str,
                       sample: int = MOE_TOPK_SAMPLE, tag: str = "17a"
                       ) -> dict:
    """17a (18a, 18c, 18e: ``tag``): one call of the stacked reduce half with the tensors it hands
    each kernel captured (every ``sample``-th bucket_topk input and the
    largest one; every segment of the three grouped launches), and each
    CUDA kernel held against its plain version on them: bucket_topk,
    bucket_scatter_sum and qsgd_unpack bit for bit, qsgd_pack bit for bit
    in 'max' mode and in the path's mode at most one level on at most
    1e-4 of the codes (phase 2's rules)."""
    from repro_torch.comm import executor
    from repro_torch.core import topk as topk_mod
    from repro_torch.kernels.bucket_scatter import ops as scatter_ops
    from repro_torch.kernels.bucket_topk import ops as topk_ops
    from repro_torch.kernels.qsgd_pack import ops as pack_ops
    from repro_torch.kernels.qsgd_pack.ref import u32_to_i64
    from repro_torch.kernels.qsgd_unpack import ops as unpack_ops

    seen, tops, largest, grouped = [0], [], [None], {}
    real = {"topk": topk_mod.bucket_topk,
            "scatter": executor.bucket_scatter_sum_grouped,
            "pack": executor.qsgd_pack_grouped,
            "unpack": executor.qsgd_unpack_grouped}

    def topk(x, k, impl="auto"):
        if seen[0] % sample == 0:
            tops.append((x, k))
        elif largest[0] is None or x.numel() > largest[0][0].numel():
            largest[0] = (x, k)
        seen[0] += 1
        return real["topk"](x, k, impl=impl)

    def capture(name):
        def fn(segments, *args, **kw):
            grouped[name] = (list(segments), args)
            return real[name](segments, *args, **kw)
        return fn

    topk_mod.bucket_topk = topk
    executor.bucket_scatter_sum_grouped = capture("scatter")
    executor.qsgd_pack_grouped = capture("pack")
    executor.qsgd_unpack_grouped = capture("unpack")
    try:
        out = reduce_half()
        torch.cuda.synchronize()
    finally:
        topk_mod.bucket_topk = real["topk"]
        executor.bucket_scatter_sum_grouped = real["scatter"]
        executor.qsgd_pack_grouped = real["pack"]
        executor.qsgd_unpack_grouped = real["unpack"]
    del out
    if set(grouped) != {"scatter", "pack", "unpack"}:
        fail(f"{tag}: the reduce half made grouped calls {sorted(grouped)}")
    if largest[0] is not None and largest[0][0].numel() > max(
            x.numel() for x, _ in tops):
        tops.append(largest[0])
    largest[0] = None
    res = {"bucket_topk_calls": seen[0], "bucket_topk_checked": len(tops),
           "bucket_topk_entries_checked": sum(x.numel() for x, _ in tops)}
    for x, k in tops:
        got = topk_ops.bucket_topk(x, k, impl="cuda")
        want = topk_ops.bucket_topk(x, k, impl="ref")
        if not all(torch.equal(g_, w_) for g_, w_ in zip(got, want)):
            fail(f"{tag}: bucket_topk differs from its plain version on a "
                 f"{tuple(x.shape)} input of the path")
        del got, want
    del tops
    segs = grouped["scatter"][0]
    got = scatter_ops.bucket_scatter_sum_grouped(segs, impl="cuda")
    want = scatter_ops.bucket_scatter_sum_grouped(segs, impl="ref")
    if not all(torch.equal(g_, w_) for g_, w_ in zip(got, want)):
        fail(f"{tag}: bucket_scatter_sum (grouped) differs from its plain "
             "version")
    res["bucket_scatter_sum_segments"] = len(segs)
    res["bucket_scatter_sum_entries"] = sum(g_.numel() for g_ in got)
    del got, want, segs, grouped["scatter"]
    psegs, pargs = grouped["pack"]
    got = pack_ops.qsgd_pack_grouped(psegs, bits, "max", impl="cuda")
    want = pack_ops.qsgd_pack_grouped(psegs, bits, "max", impl="ref")
    for (p, sc), (pr, scr) in zip(got, want):
        if not (torch.equal(sc, scr)
                and torch.equal(p.view(torch.int32), pr.view(torch.int32))):
            fail(f"{tag}: qsgd_pack ('max') differs from its plain version")
    del got, want
    shifts = torch.arange(32 // bits, device=psegs[0].rand.device) * bits
    flips, n_codes = 0, 0
    for (p, _), (pr, _) in zip(
            pack_ops.qsgd_pack_grouped(psegs, bits, mode, impl="cuda"),
            pack_ops.qsgd_pack_grouped(psegs, bits, mode, impl="ref")):
        dc = ((u32_to_i64(p)[..., None] >> shifts)
              - (u32_to_i64(pr)[..., None] >> shifts)) & (2**bits - 1)
        dc = torch.minimum(dc, 2**bits - dc)
        if int(dc.max()) > 1:
            fail(f"{tag}: qsgd_pack ('{mode}') codes differ by more than one "
                 "level")
        flips += int((dc > 0).sum())
        n_codes += dc.numel()
    if flips > 1e-4 * n_codes:
        fail(f"{tag}: qsgd_pack ('{mode}'): {flips} of {n_codes} codes moved")
    res.update(qsgd_pack_segments=len(psegs), qsgd_pack_codes=n_codes,
               qsgd_pack_codes_one_level_apart=flips)
    del psegs, grouped["pack"]
    usegs = grouped["unpack"][0]
    got = unpack_ops.qsgd_unpack_grouped(usegs, bits, impl="cuda")
    want = unpack_ops.qsgd_unpack_grouped(usegs, bits, impl="ref")
    if not all(torch.equal(g_, w_) for g_, w_ in zip(got, want)):
        fail(f"{tag}: qsgd_unpack (grouped) differs from its plain version")
    res["qsgd_unpack_segments"] = len(usegs)
    del got, want, usegs, grouped
    gc.collect()
    torch.cuda.empty_cache()
    return res


def moe_train(torch, dev, wrappers, cfg=None, replicas=MOE_TRAIN_R,
              seq=MOE_SEQ, steps=MOE_TRAIN_STEPS):
    """17a (see the module docstring): (record, launches of the run)."""
    from repro_torch import configs
    from repro_torch.comm.executor import reduce_buckets_spmd
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import capacity
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_leaves

    cfg = cfg or configs.get_config(MOE_ARCH, num_layers=MOE_TRAIN_LAYERS)
    tcfg = configs.get_train_config(MOE_ARCH)
    model = build_model(cfg)
    n_params = sum(t.numel() for t in
                   tree_leaves(model.init(device="meta")))
    r = replicas
    rec = {"config": cfg.name, "layers": cfg.num_layers,
           "dtype": str(cfg.dtype), "params": n_params,
           "microbatches": tcfg.microbatches}
    data = DataConfig(global_batch=r * tcfg.microbatches, seq_len=seq,
                      vocab_size=cfg.vocab_size)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    trainer = Trainer(model, tcfg, data, dp_total=r, device=dev)
    trainer.init()
    tlog = trainer.run(steps)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    # the headroom: what the card holds against the pool the run reserved
    total_gb = torch.cuda.mem_get_info()[1] / 1e9
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    rec["memory"] = {"card_gb": total_gb, "peak_allocated_gb": peak_gb,
                     "peak_reserved_gb": reserved_gb,
                     "headroom_gb": total_gb - reserved_gb,
                     "state_gb": _tensor_gb(trainer.state)}
    plan = trainer.plan
    nsp = plan.num_sparse_buckets
    nq = sum(bk.sparse and bk.algorithm == "dsar_split_allgather"
             for bk in plan.buckets) if tcfg.sync.qsgd_bits else 0
    # a grouped call launches one kernel for every kMaxSegs segments (64
    # in csrc/bucket_scatter.cu, 48 in qsgd_pack.cu and qsgd_unpack.cu)
    expect = {"bucket_topk": nsp * steps, "bucket_scatter": 0,
              "bucket_scatter_sum": -(-nsp // 64) * steps,
              "qsgd_pack": -(-nq // 48) * steps, "qsgd_unpack": 0,
              "qsgd_unpack_grouped": -(-nq // 48) * steps}
    losses = list(tlog.losses)
    host_ms = [t * 1e3 for t in tlog.step_times]
    log(f"[17a] {cfg.name} at {cfg.num_layers} layer(s), {n_params} "
        f"parameters, {cfg.dtype}, SparCML (DSAR + QSGD-{tcfg.sync.qsgd_bits},"
        f" k = {tcfg.sync.k_per_bucket} of {tcfg.sync.bucket_size}, ZeRO-1, "
        f"{tcfg.microbatches} microbatches), R = {r} stacked, global batch "
        f"{data.global_batch} x {seq}, capacity C = "
        f"{capacity(cfg, seq)}: losses {losses}; step times ms (host) "
        f"{[round(t, 1) for t in host_ms]}; peak memory {peak_gb:.2f} GB "
        f"allocated, {reserved_gb:.2f} reserved, of the card's "
        f"{total_gb:.2f}; "
        f"plan {plan.num_buckets} buckets ({nsp} sparse); launches "
        f"{launches}")
    if not all(math.isfinite(v) for v in losses) or len(losses) != steps:
        fail(f"17a: losses {losses}")
    for n, c in launches.items():
        if c != expect[n]:
            fail(f"17a: {n} launched {c} times in {steps} steps, expected "
                 f"{expect[n]}")
    a_step = {n: c / steps for n, c in launches.items()}
    log(f"[17a] launches a step: {a_step} (bucket_topk: the plan's {nsp} "
        f"sparse EF buckets; a grouped call launches a kernel for every 64 "
        f"/ 48 / 48 of its {nsp} / {nq} / {nq} segments)")

    # -- two more steps, each timed with CUDA events around the step, and
    #    the allocator's counters over them
    ev_ms = []
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_stats()
    for _ in range(2):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        trainer.run(trainer.state.step + 1)
        b.record()
        b.synchronize()
        ev_ms.append(a.elapsed_time(b))
    alloc1 = torch.cuda.memory_stats()
    allocator = {k: alloc1.get(k, 0) - alloc0.get(k, 0) for k in (
        "num_alloc_retries", "num_device_alloc", "num_device_free")}
    rec["memory"]["timed_steps_peak_allocated_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    # -- the step's halves alone: rank grads, the reduce half, each with
    #    the peak it reaches over the state (the first call's)
    st = trainer.state
    batch = ts.batch_to_device(synthetic_batch(data, st.step), dev)
    grads = lambda: ts.rank_grads(trainer.model, st.params, batch, r,
                                  tcfg.microbatches)
    grads_ms = time_ms(torch, grads, reps=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, leaves_r = grads()
    torch.cuda.synchronize()
    rec["memory"]["rank_grads_peak_allocated_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    rand0 = ts.StepBits(tcfg.seed, st.step, dev, r)
    reduce = lambda: reduce_buckets_spmd(plan, leaves_r, st.residuals,
                                         p_data=r, rand_fn=rand0,
                                         telemetry=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reduce()
    torch.cuda.synchronize()
    rec["memory"]["reduce_half_peak_allocated_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    reduce_ms = time_ms(torch, reduce, reps=2)
    log(f"[17a] step ms (CUDA events, 2 steps) {[round(t, 1) for t in ev_ms]}"
        f" (allocator over them: {allocator}); alone: rank grads (vmap over "
        f"{r} ranks, {tcfg.microbatches} microbatches) {grads_ms:.1f} ms, "
        f"reduce half {reduce_ms:.1f} ms; memory GB {rec['memory']}")
    checks = check_step_kernels(torch, reduce, tcfg.sync.qsgd_bits,
                                tcfg.sync.qsgd_scale, tag="17a")
    log(f"[17a] kernels against their plain versions on one step's "
        f"tensors: {checks}")
    rec.update(replicas=r, global_batch=data.global_batch, seq=seq,
               capacity=capacity(cfg, seq), losses=losses,
               step_ms_host=host_ms, step_ms_events=ev_ms,
               allocator=allocator,
               rank_grads_ms=grads_ms, reduce_half_ms=reduce_ms,
               peak_memory_gb=peak_gb, buckets=plan.num_buckets,
               sparse_buckets=nsp, launches=launches,
               launches_a_step=a_step, kernel_checks=checks)
    del leaves_r, st, batch, trainer, grads, reduce
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def needed_decode_bound(torch, eng, params, toks, n_steps: int,
                        bound: dict, cache: int, bw, f32_peak) -> dict:
    """17b: the static decode steps' bound from what their data needs,
    beside ``bound`` (every expert at C = B, the whole cache). The timed
    steps are replayed from the same prefill with the router's top-k ids
    recorded (outside any timed window); a step must read the weights of
    the distinct experts its tokens picked in each layer, every other
    weight, and the filled cache positions, and do the GEMMs of its B x k
    expert rows; the bound is averaged over the steps."""
    from repro_torch.models import moe
    from repro_torch.serve.engine import greedy

    cfg = eng.model.cfg
    L, d, e, ff = (cfg.num_layers, cfg.d_model, cfg.num_experts,
                   cfg.moe_d_ff)
    b, k = toks.shape[0], cfg.experts_per_token
    esize = torch.finfo(cfg.dtype).bits // 8
    expert_bytes = 3 * d * ff * esize
    seen, real = [], moe._route

    def route(p, x, k_):
        w, eidx = real(p, x, k_)
        seen.append(eidx)
        return w, eidx

    moe._route = route
    try:
        logits, st = eng.prefill_fn(params, {"tokens": toks})
        cur = greedy(logits)[:, None]
        del seen[:]
        for _ in range(n_steps):
            logits, st = eng.decode_fn(params, st, cur)
            cur = greedy(logits)[:, None]
    finally:
        moe._route = real
    if len(seen) != n_steps * L:
        fail(f"17b: the replay routed {len(seen)} times, expected "
             f"{n_steps * L}")
    distinct = [int(torch.unique(x).numel()) for x in seen]
    kv_full = (2 * L * b * cache * cfg.num_kv_heads * cfg.head_dim * esize)
    rest_bytes = bound["bytes"] - L * e * expert_bytes - kv_full
    prompt = toks.shape[1]
    ms, bytes_ms, flops_ms = [], [], []
    for i in range(n_steps):
        n_e = sum(distinct[i * L:(i + 1) * L])
        filled = min(prompt + i + 1, cache)
        kv = 2 * L * b * filled * cfg.num_kv_heads * cfg.head_dim * esize
        by = rest_bytes + n_e * expert_bytes + kv
        fl = 2 * L * (b * k * 3 * d * ff + b * 3 * d * cfg.moe_shared_ff
                      + b * 4 * d * cfg.num_heads * cfg.head_dim
                      + 2 * b * filled * cfg.num_heads * cfg.head_dim) \
            + 2 * b * d * cfg.vocab_size
        bytes_ms.append(by / bw * 1e3)
        flops_ms.append(fl / f32_peak * 1e3)
        ms.append(max(bytes_ms[-1], flops_ms[-1]))
    return {"ms": sum(ms) / n_steps, "ms_min": min(ms), "ms_max": max(ms),
            "bytes_ms": sum(bytes_ms) / n_steps,
            "flops_ms": sum(flops_ms) / n_steps,
            "bound_by": ("bytes" if all(x >= y for x, y in
                                        zip(bytes_ms, flops_ms))
                         else "operations"),
            "experts_a_layer": sum(distinct) / len(distinct),
            "experts_a_layer_max": max(distinct), "steps": n_steps}


def _tensor_gb(tree) -> float:
    """GB of the tensors in a (nested) NamedTuple / dict / list tree."""
    import torch

    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size() / 1e9
    if isinstance(tree, dict):
        return sum(_tensor_gb(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_gb(v) for v in tree)
    return 0.0


def _first_layer(tree) -> dict:
    """Layer 0 of a stacked (L, ...) params subtree."""
    return {k: (_first_layer(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


def moe_serve(torch, dev, wrappers, out_dir: Path, bw, f32_peak, cfg=None,
              n_requests=MOE_SERVE_REQUESTS, cache=SERVE_CACHE,
              new_static=32, prompt_static=128):
    """17b (see the module docstring): (record, launches of the serving
    runs)."""
    import numpy as np

    from repro_torch import obs as obs_mod
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.comm.plan import SERVE_STREAM
    from repro_torch.models.model import build_model
    from repro_torch.serve import (ContinuousServeEngine, ServeEngine,
                                   sparse_decode)
    from repro_torch.serve.engine import greedy
    from repro_torch.utils.calibrate import calibrate
    from repro_torch.utils.tree import tree_leaves

    for w in wrappers.values():
        w.launches = 0
    base_gb = torch.cuda.memory_allocated() / 1e9
    cfg = cfg or _moe_serve_cfg(torch, MOE_SERVE_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    weights_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    vocab, b = cfg.vocab_size, SERVE_SLOTS
    rec = {"config": cfg.name, "layers": cfg.num_layers,
           "dtype": str(cfg.dtype), "weights_gb": weights_gb,
           "p_model": MOE_P_MODEL, "init_s": init_s}

    # -- the decode step's bound: every weight but the embedding table (B
    #    rows of it) read once, the whole cache read once; its operations:
    #    the E x C = E x B expert slots of every layer and the dense GEMMs
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    emb = params["embed"]
    w_bytes = (sum(t.numel() * t.element_size() for t in leaves)
               - emb.numel() * emb.element_size()
               + b * d * emb.element_size())
    kv_bytes = (2 * cfg.num_layers * b * cache * cfg.num_kv_heads
                * cfg.head_dim * torch.finfo(cfg.dtype).bits // 8)
    flops = 2 * cfg.num_layers * (e * b * 3 * d * ff
                                  + b * 3 * d * cfg.moe_shared_ff
                                  + b * 4 * d * cfg.num_heads * cfg.head_dim
                                  + 2 * b * cache * cfg.num_heads
                                  * cfg.head_dim) + 2 * b * d * vocab
    bound = {"bytes": w_bytes + kv_bytes, "flops": flops,
             "bytes_ms": (w_bytes + kv_bytes) / bw * 1e3,
             "flops_ms": flops / f32_peak * 1e3}
    bound["ms"] = max(bound["bytes_ms"], bound["flops_ms"])
    rec["decode_step_bound"] = bound
    log(f"[17b] {cfg.name} at {cfg.num_layers} layers, f32: "
        f"{weights_gb:.2f} GB of weights (init {init_s:.1f} s); a decode "
        f"step of {b} slots reads {(w_bytes + kv_bytes) / 1e9:.2f} GB "
        f"(every expert: C = {b}) and does {flops / 1e9:.1f} GFLOP: bound "
        f"{bound['ms']:.3f} ms")

    # -- static: ServeEngine.generate, 8 prompts, twice
    eng = ServeEngine(model, params, cache_len=cache, device=dev)
    prompts = np.random.default_rng(0).integers(
        0, vocab, (b, prompt_static)).astype(np.int32)
    walls, outs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(eng.generate(prompts, max_new_tokens=new_static))
        walls.append(time.perf_counter() - t0)
    toks = torch.from_numpy(prompts).to(dev)
    prefill_ms = time_ms(torch, lambda: eng.prefill_fn(params,
                                                       {"tokens": toks}),
                         reps=3)
    logits, st = eng.prefill_fn(params, {"tokens": toks})
    cur = greedy(logits)[:, None]
    step_ms = []
    for _ in range(new_static - 1):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, st = eng.decode_fn(params, st, cur)
        cur = greedy(logits)[:, None]
        z.record()
        z.synchronize()
        step_ms.append(a.elapsed_time(z))

    def ten_steps():
        nonlocal st, cur, logits
        for _ in range(10):
            logits, st = eng.decode_fn(params, st, cur)
            cur = greedy(logits)[:, None]

    ten = stream_shares(torch, ten_steps, out_dir)
    del st, logits
    need = needed_decode_bound(torch, eng, params, toks, new_static - 1,
                               bound, cache, bw, f32_peak)
    rec["decode_step_bound_needed"] = need
    static = {"bit_equal_rerun": bool(np.array_equal(*outs)),
              "wall_s": walls, "prefill_ms": prefill_ms,
              "decode_step_ms": step_ms,
              "decode_step_ms_median": statistics.median(step_ms),
              "tok_per_s": outs[1].size / walls[1],
              "kernels_a_decode_step": (ten["kernels_whole_window"] / 10
                                        if ten else None),
              "profile_10_steps": ten}
    rec["static"] = static
    log(f"[17b] static, {b} x {prompt_static}-token prompts, {new_static} new "
        f"tokens, cache {cache}: {walls[0]:.3f} s first call, {walls[1]:.3f} "
        f"s rerun ({static['tok_per_s']:.0f} tok/s), rerun bit-equal "
        f"{static['bit_equal_rerun']}; prefill {prefill_ms:.2f} ms; decode "
        f"step median {static['decode_step_ms_median']:.3f} ms (CUDA events, "
        f"bound {bound['ms']:.3f} with every expert, {need['ms']:.3f} with "
        f"the experts the steps' router picked: {need['experts_a_layer']:.1f}"
        f" a layer on average); kernels a decode step "
        f"{static['kernels_a_decode_step']}; idle share of 10 steps "
        f"{ten and ten['idle_share']}")
    if not static["bit_equal_rerun"]:
        fail("17b: the static engine's rerun differs")

    # -- continuous: dense (first calls, then the steady rerun, traced),
    #    then adaptive on a network calibrated on the stacked shards, under
    #    CUDA sync debug mode with the engine's read-backs counted
    reqs = _serve_trace(vocab, n_requests)
    t0 = time.perf_counter()
    net = calibrate(StackedCollectives(MOE_P_MODEL, device=dev))
    cal_s = time.perf_counter() - t0
    dense = ContinuousServeEngine(model, params, cache_len=cache,
                                  batch_size=b, dispatch="dense",
                                  p_model=MOE_P_MODEL, device=dev)
    runs, obss = [], []
    for _ in range(2):
        dense.obs = obs_mod.configure(trace=True, metrics=True,
                                      set_as_default=False)
        runs.append(dense.run(reqs))
        obss.append(dense.obs)
    adaptive = ContinuousServeEngine(model, params, cache_len=cache,
                                     batch_size=b, dispatch="adaptive",
                                     net=net, p_model=MOE_P_MODEL,
                                     device=dev)
    counted = []
    real_readback = sparse_decode._readback
    sparse_decode._readback = lambda t: (counted.append(t.shape[0])
                                         or real_readback(t))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ares = adaptive.run(reqs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        sparse_decode._readback = real_readback
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = runs[1]
    outputs = res.outputs
    steps = [e["dur"] / 1e3 for e in _spans(obss[1], "serve/decode_step")]
    admit = {}
    for i, o in enumerate(obss):
        for e in _spans(o, "serve/admit"):
            admit.setdefault(e["args"]["prompt_len"], [None, None])[i] = \
                e["dur"] / 1e3
    admit_rows = sorted((n, f, s_) for n, (f, s_) in admit.items())
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    per_step = (syncs - len(reqs)) / ares.decode_steps
    cont = {"requests": len(reqs), "decode_steps": res.decode_steps,
            "tokens": res.tokens, "wall_s": [x.wall_s for x in runs],
            "tok_per_s": res.tok_per_s, "adaptive_tok_per_s": ares.tok_per_s,
            "adaptive_wall_s": ares.wall_s,
            "decode_step_ms_median": statistics.median(steps),
            "decode_step_ms_p90": float(np.percentile(steps, 90)),
            "admit_ms_by_prompt_len": admit_rows,
            "admit_ms_first_median": statistics.median(
                f for _, f, _ in admit_rows),
            "admit_ms_steady_median": statistics.median(
                s_ for _, _, s_ in admit_rows),
            "latency_steps": {k: {q: v[q] for q in ("p50", "p99")}
                              for k, v in res.latency.items()},
            "wire_bytes_dense": res.wire_bytes,
            "wire_bytes_adaptive": ares.wire_bytes,
            "swap_log": ares.swap_log,
            "network": {"alpha": net.alpha,
                        "link_bytes_per_s": net.link_bytes_per_s,
                        "calibration_s": cal_s},
            "peak_memory_gb": peak_gb,
            "peak_memory_serving_gb": peak_gb - base_gb,
            "rerun_equal": all(np.array_equal(outputs[q], runs[0].outputs[q])
                               for q in outputs),
            "adaptive_equals_dense": (set(ares.outputs) == set(outputs) and all(
                np.array_equal(ares.outputs[q], outputs[q]) for q in outputs)),
            "host_syncs": {"flagged": syncs, "readbacks": len(counted),
                           "decode_steps": ares.decode_steps,
                           "admissions": len(reqs),
                           "per_decode_step": per_step},
            "occupancy_mean": float(np.mean([x["active"]
                                             for x in res.step_log]))}
    rec["continuous"] = cont
    log(f"[17b] continuous, {len(reqs)} requests (phase 16's trace), {b} "
        f"slots, cache {cache}: {res.tokens} tokens in {res.decode_steps} "
        f"decode steps; dense {res.wall_s:.3f} s ({res.tok_per_s:.0f} tok/s;"
        f" first run {runs[0].wall_s:.3f} s), adaptive {ares.wall_s:.3f} s "
        f"({ares.tok_per_s:.0f} tok/s, under sync debug mode); decode step "
        f"median {cont['decode_step_ms_median']:.3f} ms (p90 "
        f"{cont['decode_step_ms_p90']:.3f}, bound {bound['ms']:.3f}); "
        f"admission median first / steady {cont['admit_ms_first_median']:.3f}"
        f" / {cont['admit_ms_steady_median']:.3f} ms; mean occupancy "
        f"{cont['occupancy_mean']:.2f}; peak memory {peak_gb:.2f} GB "
        f"(serving's own {peak_gb - base_gb:.2f})")
    log(f"[17b] wire bytes (modeled, per rank): dense "
        f"{res.wire_bytes:.0f}, adaptive {ares.wire_bytes:.0f}; network "
        f"calibrated on {MOE_P_MODEL} stacked shards in {cal_s:.1f} s "
        f"(alpha {net.alpha:.3e} s, {net.link_bytes_per_s:.3e} B/s); swaps "
        f"{[(x['step'], x['reason'], x['signature']) for x in ares.swap_log]}")
    log(f"[17b] host synchronisations flagged: {syncs} over "
        f"{ares.decode_steps} decode steps and {len(reqs)} admissions: "
        f"{per_step:.3f} a decode step; engine read-backs {len(counted)}; "
        f"rerun bit-equal {cont['rerun_equal']}; adaptive == dense "
        f"{cont['adaptive_equals_dense']}")
    if not cont["rerun_equal"] or set(outputs) != set(range(len(reqs))):
        fail("17b: the continuous engine's rerun differs or lost requests")
    if not cont["adaptive_equals_dense"]:
        fail("17b: the adaptive engine's tokens differ from the dense one's")
    if syncs != len(counted) or per_step != 1.0:
        fail(f"17b: host syncs: {syncs} flagged, {len(counted)} read-backs, "
             f"{per_step} a decode step (expected exactly 1)")
    stream_steps = sum(SERVE_STREAM in x["signature"]
                       for x in ares.step_log)
    cont["adaptive_stream_steps"] = stream_steps
    if not stream_steps:
        fail(f"17b: the adaptive engine never ran the row-stream wire "
             f"(swaps {ares.swap_log})")

    # -- the row-stream combine pinned: the first requests of the trace,
    #    no more than the stream's capacity at once, so that the guard
    #    never demotes it; every step on the stream, tokens equal dense's
    cap = dense._plan.min_cap
    few = reqs[:cap]
    pinned = ContinuousServeEngine(model, params, cache_len=cache,
                                   batch_size=b, dispatch="dense",
                                   p_model=MOE_P_MODEL, device=dev)
    stream = pinned._plan.replan(algorithms={
        pinned._plan.buckets[0].name: f"{SERVE_STREAM}@{cap}"})
    pinned._install(pinned._build(stream), stream, 0.0, "pinned")
    dense.obs = obs_mod.OFF
    sres, dres = pinned.run(few), dense.run(few)
    on_stream = sum(x["signature"] == stream.signature()
                    for x in sres.step_log)
    pin = {"requests": len(few), "capacity": cap,
           "decode_steps": sres.decode_steps, "stream_steps": on_stream,
           "wire_bytes_stream": sres.wire_bytes,
           "wire_bytes_dense": dres.wire_bytes,
           "equals_dense": (set(sres.outputs) == set(dres.outputs) and all(
               np.array_equal(sres.outputs[q], dres.outputs[q])
               for q in dres.outputs))}
    cont["pinned_stream"] = pin
    log(f"[17b] pinned to {stream.signature()}: {len(few)} requests, "
        f"{on_stream} of {sres.decode_steps} decode steps on the stream, "
        f"wire bytes {sres.wire_bytes:.0f} (dense {dres.wire_bytes:.0f}), "
        f"tokens equal dense's {pin['equals_dense']}")
    if on_stream != sres.decode_steps or not pin["equals_dense"]:
        fail(f"17b: the pinned row-stream run: {pin}")

    # -- each request against its own B = 1 generate (the margin rule)
    one = ServeEngine(model, params, cache_len=cache, device=dev)
    t0 = time.perf_counter()
    bad = []
    for q in reqs:
        want = one.generate(q.prompt[None], q.max_new_tokens)[0]
        if len(outputs[q.rid]) != len(want):
            fail(f"17b: request {q.rid}: {len(outputs[q.rid])} tokens, its "
                 f"generate {len(want)}")
        if np.array_equal(outputs[q.rid], want):
            continue
        _, margins = _greedy_margins(torch, one, q.prompt[None],
                                     q.max_new_tokens)
        bad.append({"rid": q.rid, **_first_mismatch(outputs[q.rid], want,
                                                    margins[0])})
    cont["per_request"] = {"mismatches": bad,
                           "seconds": time.perf_counter() - t0}
    log(f"[17b] continuous vs each request's B = 1 generate: "
        f"{len(reqs) - len(bad)} of {len(reqs)} equal token for token "
        f"({cont['per_request']['seconds']:.1f} s)")
    _margin_rule("17b continuous vs B = 1 generate", bad)
    del one

    # -- the card's idle share over the last 20 of 40 decode steps
    from repro_torch.serve import Request

    rng = np.random.default_rng(1)
    full = [Request(rid=i, prompt=rng.integers(0, vocab, 128),
                    max_new_tokens=41) for i in range(b)]
    dense.obs = obs_mod.OFF
    shares = stream_shares(torch, lambda: dense.run(full), out_dir)
    if shares is None:
        fail("17b: the profiled decode steps ran no kernel on the card")
    cont["profile"] = shares
    log(f"[17b] profiler, {b} requests of 41 tokens admitted at once, the "
        f"last 20 decode steps: idle share {shares['idle_share']:.3f}; "
        f"{shares}")

    # -- moe_apply at full width twice on the card: the combine's order
    from repro_torch.models import moe

    lp = _first_layer(params["blocks"]["moe"])
    x = torch.randn((MOE_SEQ, d), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    same = torch.equal(moe.moe_apply(lp, cfg, x), moe.moe_apply(lp, cfg, x))
    rec["moe_apply_full_width_rerun_equal"] = same
    log(f"[17b] moe_apply at full width ({MOE_SEQ} tokens, C = "
        f"{moe.capacity(cfg, MOE_SEQ)}) twice on the card: bit-equal {same}")
    if not same:
        fail("17b: moe_apply reruns differ on the card")
    launches = {nm: w.launches for nm, w in wrappers.items()}
    log(f"[17b] kernel launches while serving: {launches} (no TPU kernel "
        f"lies on the serving path)")
    del params, model, dense, adaptive, pinned, eng, lp, x
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def moe_small(torch, dev) -> dict:
    """17c (see the module docstring): moonshot's smoke config on the card
    against the CPU."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.qsgd import random_bits
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = configs.smoke_config(MOE_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(7), device="cpu")
    sides = {"cpu": (torch.device("cpu"), params),
             "card": (dev, _to(params, dev))}
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (2, 24)).astype(np.int32)
    out = {}
    for where, (dv, p) in sides.items():
        t = torch.from_numpy(toks).to(dv)
        lg = [model.forward(p, {"tokens": t}).detach().cpu()]
        plg, st = model.prefill(p, {"tokens": t[:, :16]}, 32)
        seq = [plg.cpu()]
        for i in range(16, 24):
            plg, st = model.decode_step(p, st, t[:, i:i + 1])
            seq.append(plg.cpu())
        out[where] = (lg[0].numpy(), torch.stack(seq).numpy())
    errs = {}
    for i, name in enumerate(("forward", "prefill_decode")):
        want, got = out["cpu"][i], out["card"][i]
        errs[name] = float(np.abs(got - want).max())
        if not np.allclose(got, want, rtol=1e-5,
                           atol=1e-5 * float(np.abs(want).max())):
            fail(f"17c: {name} logits, card against CPU: max abs err "
                 f"{errs[name]:.3e}")

    def bits_for(step, device):
        def rand_fn(bucket_idx, n):
            g = torch.Generator().manual_seed(step * 1000 + bucket_idx)
            return random_bits(n, g, "cpu").to(device)
        return rand_fn

    # three steps: the schedule's lr is 0 at step 0, so steps 1 and 2
    # update the params; the final state is held card against CPU
    losses, states = {}, {}
    for where, (dv, p) in sides.items():
        tr = Trainer(model, configs.get_train_config(MOE_ARCH),
                     DataConfig(16, 16, cfg.vocab_size), dp_total=4,
                     device=dv)
        if not tr.plan.num_sparse_buckets:
            fail("17c: the smoke plan has no sparse bucket")
        tr.init(params=tree_map(torch.clone, p))   # the steps update it
        losses[where] = tr.run(MOE_SMALL_STEPS, rand_fn_for_step=lambda s,
                               w=dv: bits_for(s, w)).losses
        st = tr.state
        states[where] = (tree_leaves(st.params)
                         + [m for k in ("mu", "nu")
                            for m in tree_leaves(st.opt[k])]
                         + [st.residuals[n] for n in sorted(st.residuals)])
        del tr
    rel = max(abs(a - c) / abs(c) for a, c in zip(losses["card"],
                                                  losses["cpu"]))
    # the state: rtol 2e-4 with a floor of 2e-4 of each leaf's largest
    # magnitude (a QSGD level moved by an L2 scale summed in another order
    # reaches it through the update), as the CPU tests hold the reference
    state_err = 0.0
    for a, c in zip(states["card"], states["cpu"]):
        a, c = a.detach().cpu().float(), c.detach().float()
        floor = 2e-4 * float(c.abs().max())
        err = (float(((a - c).abs() / (2e-4 * c.abs() + floor)).max())
               if floor else (0.0 if torch.equal(a, c) else math.inf))
        state_err = max(state_err, err)
    if not rel <= 2e-4 or not state_err <= 1.0:
        fail(f"17c: SparCML steps, card {losses['card']} against CPU "
             f"{losses['cpu']}; the final state at {state_err:.3g} of its "
             f"tolerance")
    lp = _first_layer(sides["card"][1]["blocks"]["moe"])
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (64, cfg.d_model)).astype(np.float32)).to(dev)
    same = torch.equal(moe.moe_apply(lp, cfg, x), moe.moe_apply(lp, cfg, x))
    rec = {"max_abs_err": errs, "losses": losses, "losses_max_rel": rel,
           "state_err_of_tolerance": state_err, "state_tensors":
           len(states["cpu"]), "moe_apply_rerun_equal": same}
    log(f"[17c] moonshot smoke config, card against CPU: logits max abs err "
        f"{errs} (rtol 1e-5, floor 1e-5 of the largest); {MOE_SMALL_STEPS} "
        f"SparCML steps {losses['card']} vs {losses['cpu']} (max rel "
        f"{rel:.2e}, limit 2e-4); final params, moments and residuals "
        f"({len(states['cpu'])} tensors) at {state_err:.3g} of their "
        f"tolerance (rtol 2e-4, floor 2e-4 of the largest); moe_apply twice on the card bit-equal {same}")
    if not same:
        fail("17c: moe_apply reruns differ on the card")
    return rec


def phase_moe(torch, dev, wrappers, out_dir: Path, bw, f32_peak):
    """Phase 17 (see the module docstring). Returns (record, {path:
    launches}) for the MoE training and serving runs."""
    rec, paths = {}, {}
    # full-width runs near the card's capacity: expandable allocator
    # segments, so freed blocks of many sizes do not fragment the pool
    rec["expandable_segments"] = _expandable_segments(torch, True)
    try:
        t0 = time.perf_counter()
        rec["train"], paths["moe_train"] = moe_train(torch, dev, wrappers)
        rec["train"]["seconds"] = time.perf_counter() - t0
        log(f"[17a] took {rec['train']['seconds']:.1f} s")
        t0 = time.perf_counter()
        rec["serve"], paths["moe_serve"] = moe_serve(torch, dev, wrappers,
                                                     out_dir, bw, f32_peak)
        rec["serve"]["seconds"] = time.perf_counter() - t0
        log(f"[17b] took {rec['serve']['seconds']:.1f} s")
        t0 = time.perf_counter()
        rec["small"] = moe_small(torch, dev)
        rec["small"]["seconds"] = time.perf_counter() - t0
        log(f"[17c] took {rec['small']['seconds']:.1f} s")
    finally:
        if rec["expandable_segments"]:
            _expandable_segments(torch, False)
    return rec, paths


# ---------------------------------------------------------------- 18

SSM_ARCH = "mamba2-370m"
HYBRID_ARCH = "zamba2-2.7b"
VLM_ARCH = "llama-3.2-vision-11b"
ENC_ARCH = "hubert-xlarge"
FAM_R = 4                  # 18a, 18c, 18e: replicas stacked on the card
FAM_SEQ = 512              # one 512-token (frame) row a rank a microbatch
SSM_TRAIN_STEPS = 3        # 18a: full width and depth
HYBRID_LAYERS = 6          # 18c: 54 -> 6 layers, 1 superblock
HYBRID_TRAIN_STEPS = 3
HYBRID_PEAK_GB = 70.0      # 18c: above this peak, R = 2 (as 17a)
VLM_LAYERS = 5             # 18d: 40 -> 5 layers, 1 superblock
ENC_LAYERS = 12            # 18e: 48 -> 12 layers
ENC_TRAIN_STEPS = 3
FAM_REQUESTS = 16          # 18b, 18c: the continuous trace
FAM_PROMPTS = (256, 512)   # multiples of ssm_chunk, as the prefill needs
VLM_PROMPT = 128           # 18d: 8 prompts of this many tokens
FAM_SMALL_STEPS = 3        # 18f
FLIP_SHARE = 1e-3          # 18f: a tensor's entries a TopK flip may move
FAM_SMOKE = {"ssm": SSM_ARCH, "hybrid": HYBRID_ARCH, "vlm": VLM_ARCH,
             "encoder": ENC_ARCH}


def data_config_for(cfg, global_batch: int, seq_len: int, seed: int = 1234):
    """The DataConfig that feeds ``cfg``'s family its inputs: tokens, and
    the stub frontends' frames (encoder) or image embeddings (vlm)."""
    from repro_torch.data.pipeline import DataConfig

    kind = {"encoder": "audio", "vlm": "vlm"}.get(cfg.family, "lm")
    return DataConfig(global_batch, seq_len, cfg.vocab_size, seed, kind,
                      cfg.frontend_dim, cfg.num_image_tokens, cfg.vision_dim)


def _f32(cfg):
    """``cfg`` in f32 (params and compute)."""
    import torch

    return dataclasses.replace(cfg, dtype=torch.float32,
                               param_dtype=torch.float32)


def _open_gates(params) -> None:
    """Non-zero vlm gates (tanh(0.5) on the cross-attention, tanh(-0.7)
    on its MLP): at their init of 0 the image would count for nothing."""
    params["blocks"]["cross"]["xattn"]["gate"].fill_(0.5)
    params["blocks"]["cross"]["mlp_gate"].fill_(-0.7)


def family_train(torch, dev, wrappers, tag: str, arch: str, cfg, steps: int,
                 replicas: int = FAM_R, seq: int | None = None):
    """18a, 18c, 18e, 19b: Trainer.run of ``cfg`` under ``arch``'s SparCML
    train_config, ``replicas`` stacked, one ``seq`` row a rank a
    microbatch; launches a step, step times, peak memory beside the
    state's size (its tensors, and the bytes ``init_or_resume``
    allocated); the last step's rank grads (CUDA events) and the reduce
    half alone on its output; each kernel against its plain version on
    those tensors. Returns (record, launches of the run)."""
    from repro_torch import configs
    from repro_torch.comm.executor import reduce_buckets_spmd
    from repro_torch.models.model import build_model
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_leaves

    tcfg = configs.get_train_config(arch)
    model = build_model(cfg)
    n_params = sum(t.numel() for t in tree_leaves(model.init(device="meta")))
    r, seq = replicas, seq or FAM_SEQ
    data = data_config_for(cfg, r * tcfg.microbatches, seq)
    rec = {"config": cfg.name, "layers": cfg.num_layers,
           "dtype": str(cfg.dtype), "params": n_params, "replicas": r,
           "microbatches": tcfg.microbatches, "remat": cfg.remat,
           "global_batch": data.global_batch, "seq": seq}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    before = torch.cuda.memory_allocated()
    trainer = Trainer(model, tcfg, data, dp_total=r, device=dev)
    trainer.init_or_resume()
    torch.cuda.synchronize()
    state_gb = _tensor_gb(trainer.state)
    state_allocated = torch.cuda.memory_allocated() - before
    trainer.run(steps - 1)
    # the last step's rank grads are kept (the reduce half's input, for
    # the kernel checks) and timed with CUDA events around the call
    real, kept = ts.rank_grads, {}

    def keep(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(*args, **kw)
        b.record()
        kept.update(leaves=out[1], events=(a, b))
        return out

    ts.rank_grads = keep
    try:
        tlog = trainer.run(steps)
    finally:
        ts.rank_grads = real
    torch.cuda.synchronize()
    grads_ms = kept["events"][0].elapsed_time(kept["events"][1])
    launches = {n: w.launches for n, w in wrappers.items()}
    total_gb = torch.cuda.mem_get_info()[1] / 1e9
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec["memory"] = {"card_gb": total_gb, "peak_allocated_gb": peak_gb,
                     "peak_reserved_gb":
                     torch.cuda.max_memory_reserved() / 1e9,
                     "state_gb": state_gb,
                     "state_allocated_bytes": state_allocated,
                     "state_bytes_a_param": state_gb * 1e9 / n_params}
    plan = trainer.plan
    nsp = plan.num_sparse_buckets
    nq = sum(bk.sparse and bk.algorithm == "dsar_split_allgather"
             for bk in plan.buckets) if tcfg.sync.qsgd_bits else 0
    expect = {"bucket_topk": nsp * steps, "bucket_scatter": 0,
              "bucket_scatter_sum": -(-nsp // 64) * steps,
              "qsgd_pack": -(-nq // 48) * steps, "qsgd_unpack": 0,
              "qsgd_unpack_grouped": -(-nq // 48) * steps}
    losses = list(tlog.losses)
    host_ms = [t * 1e3 for t in tlog.step_times]
    log(f"[{tag}] {cfg.name} at {cfg.num_layers} layers, {n_params} "
        f"parameters, {cfg.dtype}, remat {cfg.remat}, SparCML (DSAR + "
        f"QSGD-{tcfg.sync.qsgd_bits}, k = {tcfg.sync.k_per_bucket} of "
        f"{tcfg.sync.bucket_size}, ZeRO-1, {tcfg.microbatches} "
        f"microbatches), R = {r} stacked, global batch "
        f"{data.global_batch} x {seq}: losses {losses}; step times ms "
        f"{[round(t, 1) for t in host_ms]}; peak memory {peak_gb:.2f} GB "
        f"allocated of the card's {total_gb:.2f} (state {state_gb:.2f} GB,"
        f" {rec['memory']['state_bytes_a_param']:.1f} B a parameter); plan "
        f"{plan.num_buckets} buckets ({nsp} sparse); launches {launches}")
    if not all(math.isfinite(v) for v in losses) or len(losses) != steps:
        fail(f"{tag}: losses {losses}")
    for n, c in launches.items():
        if c != expect[n]:
            fail(f"{tag}: {n} launched {c} times in {steps} steps, expected "
                 f"{expect[n]}")
    for n in ("bucket_topk", "bucket_scatter_sum", "qsgd_pack",
              "qsgd_unpack_grouped"):
        if not launches[n]:
            fail(f"{tag}: {n} was not launched on the training path")
    # -- the reduce half alone on the last step's grads and the residuals
    #    it left (the params and moments freed first)
    leaves_r, residuals = kept.pop("leaves"), trainer.state.residuals
    rand0 = ts.StepBits(tcfg.seed, steps - 1, dev, replicas)
    trainer.state = None
    gc.collect()
    torch.cuda.empty_cache()
    reduce = lambda: reduce_buckets_spmd(plan, leaves_r, residuals,
                                         p_data=r, rand_fn=rand0,
                                         telemetry=False)
    reduce_ms = time_ms(torch, reduce, reps=2)
    checks = check_step_kernels(torch, reduce, tcfg.sync.qsgd_bits,
                                tcfg.sync.qsgd_scale, tag=tag)
    a_step = {n: c / steps for n, c in launches.items()}
    log(f"[{tag}] launches a step {a_step}; steady step "
        f"{statistics.median(host_ms[1:]):.1f} ms (host, synchronised); "
        f"the last step's rank grads {grads_ms:.1f} ms (CUDA events); the "
        f"reduce half alone {reduce_ms:.1f} ms; kernels against their plain "
        f"versions on "
        f"one step's tensors: {checks}")
    rec.update(losses=losses, step_ms_host=host_ms,
               step_ms_median=statistics.median(host_ms[1:]),
               rank_grads_ms=grads_ms, reduce_half_ms=reduce_ms,
               buckets=plan.num_buckets, sparse_buckets=nsp,
               launches=launches, launches_a_step=a_step,
               kernel_checks=checks)
    del leaves_r, residuals, trainer, reduce
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def _family_trace(vocab: int, n: int = FAM_REQUESTS):
    """18b and 18c's requests: Poisson arrivals at 0.5 a decode step (seed
    0), prompts of 256 or 512 tokens (whole SSD chunks) and 32-128 new
    tokens, drawn by numpy.random.default_rng(0)."""
    import numpy as np

    from repro_torch.serve import Request, poisson_trace

    rng = np.random.default_rng(0)
    arrivals = poisson_trace(n, rate=0.5, seed=0)
    lens = rng.choice(FAM_PROMPTS, n)
    news = rng.integers(32, 129, n)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(lens[i])),
                    max_new_tokens=int(news[i]), arrival=float(arrivals[i]))
            for i in range(n)]


def family_continuous(torch, dev, tag: str, model, params, cache: int,
                      reqs) -> dict:
    """18b, 18c: ContinuousServeEngine over 8 slots, traced, under CUDA
    sync debug mode with the engine's read-backs counted (exactly one host
    synchronisation a decode step, one an admission); each request
    against its own B = 1 generate (phase 16's margin rule)."""
    import numpy as np

    from repro_torch import obs as obs_mod
    from repro_torch.serve import ContinuousServeEngine, ServeEngine
    from repro_torch.serve import sparse_decode

    eng = ContinuousServeEngine(model, params, cache_len=cache,
                                batch_size=SERVE_SLOTS, device=dev)
    eng.obs = obs = obs_mod.configure(trace=True, metrics=True,
                                      set_as_default=False)
    counted = []
    real_readback = sparse_decode._readback
    sparse_decode._readback = lambda t: (counted.append(t.shape[0])
                                         or real_readback(t))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = eng.run(reqs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        sparse_decode._readback = real_readback
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    per_step = (syncs - len(reqs)) / res.decode_steps
    steps = [e["dur"] / 1e3 for e in _spans(obs, "serve/decode_step")]
    admit = [e["dur"] / 1e3 for e in _spans(obs, "serve/admit")]
    one = ServeEngine(model, params, cache_len=cache, device=dev)
    t0 = time.perf_counter()
    bad = []
    for q in reqs:
        want = one.generate(q.prompt[None], q.max_new_tokens)[0]
        got = res.outputs[q.rid]
        if len(got) != len(want):
            fail(f"{tag}: request {q.rid}: {len(got)} tokens, its generate "
                 f"{len(want)}")
        if np.array_equal(got, want):
            continue
        _, margins = _greedy_margins(torch, one, q.prompt[None],
                                     q.max_new_tokens)
        bad.append({"rid": q.rid, **_first_mismatch(got, want, margins[0])})
    cont = {"requests": len(reqs), "dtype": str(model.cfg.dtype),
            "decode_steps": res.decode_steps, "tokens": res.tokens,
            "wall_s": res.wall_s, "tok_per_s": res.tok_per_s,
            "decode_step_ms_median": statistics.median(steps),
            "decode_step_ms_p90": float(np.percentile(steps, 90)),
            "admit_ms_median": statistics.median(admit),
            "latency_steps": {k: {q: v[q] for q in ("p50", "p99")}
                              for k, v in res.latency.items()},
            "host_syncs": {"flagged": syncs, "readbacks": len(counted),
                           "decode_steps": res.decode_steps,
                           "admissions": len(reqs),
                           "per_decode_step": per_step},
            "per_request": {"mismatches": bad,
                            "seconds": time.perf_counter() - t0}}
    log(f"[{tag}] continuous, {model.cfg.dtype}, {len(reqs)} requests, "
        f"{SERVE_SLOTS} slots, cache {cache}: {res.tokens} tokens in "
        f"{res.decode_steps} decode steps, {res.wall_s:.3f} s "
        f"({res.tok_per_s:.0f} tok/s, under sync debug mode); decode step "
        f"median {cont['decode_step_ms_median']:.3f} ms (p90 "
        f"{cont['decode_step_ms_p90']:.3f}); admission median "
        f"{cont['admit_ms_median']:.3f} ms; host syncs {syncs} flagged over "
        f"{res.decode_steps} steps and {len(reqs)} admissions ({per_step:.3f}"
        f" a step), read-backs {len(counted)}; {len(reqs) - len(bad)} of "
        f"{len(reqs)} requests equal their B = 1 generate "
        f"({cont['per_request']['seconds']:.1f} s)")
    if set(res.outputs) != set(range(len(reqs))):
        fail(f"{tag}: the continuous run lost requests")
    if syncs != len(counted) or per_step != 1.0:
        fail(f"{tag}: host syncs: {syncs} flagged, {len(counted)} read-backs,"
             f" {per_step} a decode step (expected exactly 1)")
    _margin_rule(f"{tag} continuous vs B = 1 generate", bad)
    del eng, one
    return cont


def family_serve_static(torch, dev, out_dir: Path, tag: str, model, params,
                        prompts, new: int, cache: int, image=None) -> dict:
    """ServeEngine.generate twice (the rerun bit-equal), the prefill
    (CUDA events) and each decode step timed, the kernels and idle share
    of 10 profiled decode steps."""
    import numpy as np

    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import greedy

    eng = ServeEngine(model, params, cache_len=cache, device=dev)
    walls, outs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(eng.generate(prompts, new, image_embeds=image))
        walls.append(time.perf_counter() - t0)
    batch = {"tokens": torch.from_numpy(prompts).to(dev)}
    if image is not None:
        batch["image_embeds"] = torch.from_numpy(image).to(dev)
    prefill_ms = time_ms(torch, lambda: eng.prefill_fn(params, batch),
                         reps=3)
    logits, st = eng.prefill_fn(params, batch)
    cur = greedy(logits)[:, None]
    step_ms = []
    for _ in range(new - 1):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, st = eng.decode_fn(params, st, cur)
        cur = greedy(logits)[:, None]
        z.record()
        z.synchronize()
        step_ms.append(a.elapsed_time(z))

    def ten_steps():
        nonlocal st, cur, logits
        for _ in range(10):
            logits, st = eng.decode_fn(params, st, cur)
            cur = greedy(logits)[:, None]

    ten = stream_shares(torch, ten_steps, out_dir)
    out = {"bit_equal_rerun": bool(np.array_equal(*outs)),
           "finite_logits": bool(torch.isfinite(logits).all()),
           "wall_s": walls, "prefill_ms": prefill_ms,
           "decode_step_ms": step_ms,
           "decode_step_ms_median": statistics.median(step_ms),
           "tok_per_s": outs[1].size / walls[1],
           "kernels_a_decode_step": (ten["kernels_whole_window"] / 10
                                     if ten else None),
           "idle_share": ten and ten["idle_share"], "profile_10_steps": ten,
           "tokens": outs[1]}
    log(f"[{tag}] static, {prompts.shape[0]} x {prompts.shape[1]}-token "
        f"prompts{'' if image is None else f' with {image.shape[1]} x {image.shape[2]} image embeddings'}"
        f", {new} new tokens, cache {cache}: {walls[0]:.3f} s first call, "
        f"{walls[1]:.3f} s rerun ({out['tok_per_s']:.0f} tok/s), rerun "
        f"bit-equal {out['bit_equal_rerun']}; prefill {prefill_ms:.2f} ms; "
        f"decode step median {out['decode_step_ms_median']:.3f} ms (CUDA "
        f"events); kernels a decode step {out['kernels_a_decode_step']}; "
        f"idle share of 10 steps {out['idle_share']}")
    if not out["bit_equal_rerun"] or not out["finite_logits"]:
        fail(f"{tag}: the static engine's rerun differs or its logits are "
             "not finite")
    del eng, st, logits
    return out


def ssm_serve(torch, dev, wrappers, out_dir: Path, bw, f32_peak):
    """18b: mamba2-370m at full width and depth, bf16, random weights."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import tree_leaves, tree_map

    for w in wrappers.values():
        w.launches = 0
    cfg = configs.get_config(SSM_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    b = SERVE_SLOTS
    # the decode step's bound: every weight read once (the tied embedding
    # is the unembedding: all of it), each slot's f32 SSM state and conv
    # window read and written once
    w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    st_bytes = 2 * b * cfg.num_layers * (
        cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        + (cfg.conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state)
        * torch.finfo(cfg.dtype).bits // 8)
    flops = 2 * b * (sum(t.numel() for t in tree_leaves(params))
                     + cfg.num_layers * 3 * cfg.ssm_heads * cfg.ssm_head_dim
                     * cfg.ssm_state)
    bound = {"bytes": w_bytes + st_bytes, "weights_bytes": w_bytes,
             "state_bytes": st_bytes, "flops": flops,
             "bytes_ms": (w_bytes + st_bytes) / bw * 1e3,
             "flops_ms": flops / f32_peak * 1e3}
    bound["ms"] = max(bound["bytes_ms"], bound["flops_ms"])
    log(f"[18b] {cfg.name}, {cfg.num_layers} layers, {cfg.dtype}: "
        f"{w_bytes / 1e9:.3f} GB of weights; a decode step of {b} slots "
        f"reads them and reads and writes {st_bytes / 1e9:.3f} GB of SSM "
        f"state: bound {bound['ms']:.3f} ms")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, FAM_PROMPTS[0])).astype(np.int32)
    static = family_serve_static(torch, dev, out_dir, "18b", model, params,
                                 prompts, 32, SERVE_CACHE)
    # the continuous run and its B = 1 references in f32, as 17b's: the
    # logits of a bf16 model are bf16 values, so ties are common, and the
    # M = 8 and M = 1 bf16 GEMMs round apart often enough to flip a greedy
    # token at a one-ulp gap
    f32_model = build_model(_f32(cfg))
    del static["tokens"]
    cont = family_continuous(torch, dev, "18b", f32_model,
                             tree_map(lambda t: t.float(), params),
                             SERVE_CACHE, _family_trace(cfg.vocab_size))
    launches = {n: w.launches for n, w in wrappers.items()}
    rec = {"config": cfg.name, "layers": cfg.num_layers,
           "weights_gb": w_bytes / 1e9, "decode_step_bound": bound,
           "static": static, "continuous": cont, "launches": launches}
    log(f"[18b] decode step {static['decode_step_ms_median']:.3f} ms static, "
        f"{cont['decode_step_ms_median']:.3f} continuous, against a "
        f"{bound['ms']:.3f} ms bound; kernel launches while serving "
        f"{launches}")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def hybrid_phase(torch, dev, wrappers):
    """18c: zamba2-2.7b at full width, HYBRID_LAYERS layers: SparCML
    training (R = 4, or R = 2 when R = 4's peak passes HYBRID_PEAK_GB or
    runs out of memory), then 18b's requests served continuously."""
    from repro_torch import configs
    from repro_torch.models.model import build_model

    cfg = configs.get_config(HYBRID_ARCH, num_layers=HYBRID_LAYERS)
    rec, reason = {}, None
    try:
        rec["train"], launches = family_train(
            torch, dev, wrappers, "18c", HYBRID_ARCH, cfg, HYBRID_TRAIN_STEPS)
        peak = rec["train"]["memory"]["peak_allocated_gb"]
        if peak > HYBRID_PEAK_GB:
            reason = f"peak {peak:.2f} GB above {HYBRID_PEAK_GB}"
    except torch.cuda.OutOfMemoryError as exc:
        reason = str(exc)[:300]
    if reason is not None:
        # outside the handler, so the failed run's tensors are freed
        rec["r2_reason"] = f"R = {FAM_R}: {reason}"
        log(f"[18c] R = {FAM_R} does not fit ({reason}); R = 2")
        gc.collect()
        torch.cuda.empty_cache()
        rec["train"], launches = family_train(
            torch, dev, wrappers, "18c", HYBRID_ARCH, cfg, HYBRID_TRAIN_STEPS,
            replicas=2)
    # served in f32, as 18b's continuous run
    model = build_model(_f32(cfg))
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    rec["serve"] = family_continuous(torch, dev, "18c", model, params,
                                     SERVE_CACHE,
                                     _family_trace(cfg.vocab_size))
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def vlm_serve(torch, dev, out_dir: Path):
    """18d: llama-3.2-vision-11b at full width, 1 superblock, bf16:
    static serving with image embeddings (gates opened); other images
    give other tokens."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import tree_leaves

    cfg = configs.get_config(VLM_ARCH, num_layers=VLM_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    _open_gates(params)
    n = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (SERVE_SLOTS, VLM_PROMPT)).astype(np.int32)
    image = rng.standard_normal((SERVE_SLOTS, cfg.num_image_tokens,
                                 cfg.vision_dim)).astype(np.float32)
    log(f"[18d] {cfg.name} at {cfg.num_layers} layers ({n} parameters, "
        f"{cfg.dtype}, gates opened)")
    static = family_serve_static(torch, dev, out_dir, "18d", model, params,
                                 prompts, 32, SERVE_CACHE, image=image)
    from repro_torch.serve import ServeEngine

    other = ServeEngine(model, params, cache_len=SERVE_CACHE,
                        device=dev).generate(prompts, 32,
                                             image_embeds=-image)
    static["other_image_changes_tokens"] = bool(
        not np.array_equal(other, static.pop("tokens")))
    log(f"[18d] another image changes the tokens: "
        f"{static['other_image_changes_tokens']}")
    if not static["other_image_changes_tokens"]:
        fail("18d: the image embeddings do not reach the tokens")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": cfg.name, "layers": cfg.num_layers, "params": n,
            "static": static}


def family_small(torch, dev, fam: str) -> dict:
    """18f: one family's smoke config (f32) on the card against the CPU:
    logits (and a prefill + 8 decode steps), 3 SparCML steps with the same
    QSGD bits (the final params, moments and EF residuals within rtol 2e-4
    and 2e-4 of each tensor's largest magnitude), and remat on against
    off through rank_grads on the card, bit-equal."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.qsgd import random_bits
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_leaves, tree_map

    arch = FAM_SMOKE[fam]
    cfg = configs.smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(7), device="cpu")
    if fam == "vlm":
        _open_gates(params)
    sides = {"cpu": (torch.device("cpu"), params),
             "card": (dev, _to(params, dev))}
    data = synthetic_batch(data_config_for(cfg, 2, 24, seed=4), 0)
    out = {}
    for where, (dv, p) in sides.items():
        b = {k: torch.from_numpy(v).to(dv) for k, v in data.items()}
        seq = [model.forward(p, b).detach().cpu().reshape(-1)]
        if cfg.is_decoder:
            pre = {k: v for k, v in b.items() if k != "labels"}
            pre["tokens"] = b["tokens"][:, :16]
            plg, st = model.prefill(p, pre, 32)
            seq.append(plg.cpu().reshape(-1))
            for i in range(16, 24):
                plg, st = model.decode_step(p, st, b["tokens"][:, i:i + 1])
                seq.append(plg.cpu().reshape(-1))
        out[where] = torch.cat(seq).numpy()
    want, got = out["cpu"], out["card"]
    err = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=1e-5,
                       atol=1e-5 * float(np.abs(want).max())):
        fail(f"18f {arch}: logits, card against CPU: max abs err {err:.3e}")

    def bits_for(step, device):
        def rand_fn(bucket_idx, n):
            g = torch.Generator().manual_seed(step * 1000 + bucket_idx)
            return random_bits(n, g, "cpu").to(device)
        return rand_fn

    tcfg = configs.get_train_config(arch)
    dcfg = data_config_for(cfg, 4 * tcfg.microbatches, 16)
    losses, states = {}, {}
    for where, (dv, p) in sides.items():
        tr = Trainer(model, tcfg, dcfg, dp_total=4, device=dv)
        if not tr.plan.num_sparse_buckets:
            fail(f"18f {arch}: the smoke plan has no sparse bucket")
        tr.init(params=tree_map(torch.clone, p))
        losses[where] = tr.run(FAM_SMALL_STEPS, rand_fn_for_step=lambda s,
                               w=dv: bits_for(s, w)).losses
        st = tr.state
        states[where] = (tree_leaves(st.params)
                         + [m for k in ("mu", "nu")
                            for m in tree_leaves(st.opt[k])]
                         + [st.residuals[n] for n in sorted(st.residuals)])
        del tr
    rel = max(abs(a - c) / abs(c) for a, c in zip(losses["card"],
                                                  losses["cpu"]))
    # the final state: 17c's tolerance (rtol 2e-4, a floor of 2e-4 of the
    # tensor's largest magnitude) on all but FLIP_SHARE of a tensor's
    # entries (at least one): a TopK pick decided by a gap within the two
    # sides' rounding moves whole entries between the residual and the
    # sync. A weight changed by one ulp moves 13 of the 32768 entries of
    # the zamba2 smoke's shared wq moments past the tolerance on the CPU
    # alone.
    state_err, outside, worst = 0.0, 0, None
    for i, (a, c) in enumerate(zip(states["card"], states["cpu"])):
        a, c = a.detach().cpu().float(), c.detach().float()
        floor = 2e-4 * float(c.abs().max())
        r = ((a - c).abs() / (2e-4 * c.abs() + floor) if floor
             else (a != c).float() * math.inf)
        n = int((r > 1).sum())
        outside += n
        if n > max(1, math.ceil(FLIP_SHARE * r.numel())):
            worst = (i, n, r.numel())
        state_err = max(state_err, float(r.max()))
    if not rel <= 2e-4 or worst is not None:
        fail(f"18f {arch}: SparCML steps, card {losses['card']} against CPU "
             f"{losses['cpu']}; the final state's tensor {worst and worst[0]}"
             f" has {worst and worst[1]} of {worst and worst[2]} entries "
             f"outside the tolerance (largest at {state_err:.3g} of it)")
    off = build_model(dataclasses.replace(cfg, remat=False))
    batch = ts.batch_to_device(synthetic_batch(dcfg, 0), dev)
    p = sides["card"][1]
    la, ga = ts.rank_grads(model, p, batch, 4, tcfg.microbatches)
    lb, gb = ts.rank_grads(off, p, batch, 4, tcfg.microbatches)
    remat_equal = bool(torch.equal(la, lb)) and all(
        torch.equal(x, y) for x, y in zip(ga, gb))
    rec = {"logits_max_abs_err": err, "losses": losses, "losses_max_rel": rel,
           "state_err_of_tolerance": state_err,
           "state_entries_outside": outside,
           "state_tensors": len(states["cpu"]),
           "remat_bit_equal": remat_equal}
    log(f"[18f] {arch} smoke config, card against CPU: logits max abs err "
        f"{err:.3e}; {FAM_SMALL_STEPS} SparCML steps {losses['card']} vs "
        f"{losses['cpu']} (max rel {rel:.2e}); final state "
        f"({len(states['cpu'])} tensors): largest at {state_err:.3g} of its "
        f"tolerance, {outside} entries outside it; remat on == off on the "
        f"card: {remat_equal}")
    if not remat_equal:
        fail(f"18f {arch}: remat on and off differ on the card")
    return rec


def phase_families(torch, dev, wrappers, out_dir: Path, bw, f32_peak):
    """Phase 18 (see the module docstring). Returns (record, {path:
    launches})."""
    from repro_torch import configs

    rec, paths = {}, {}
    rec["expandable_segments"] = _expandable_segments(torch, True)
    try:
        t0 = time.perf_counter()
        rec["ssm_train"], paths["ssm_train"] = family_train(
            torch, dev, wrappers, "18a", SSM_ARCH,
            configs.get_config(SSM_ARCH), SSM_TRAIN_STEPS)
        rec["ssm_train"]["seconds"] = time.perf_counter() - t0
        log(f"[18a] took {rec['ssm_train']['seconds']:.1f} s")
        t0 = time.perf_counter()
        rec["ssm_serve"], paths["ssm_serve"] = ssm_serve(
            torch, dev, wrappers, out_dir, bw, f32_peak)
        rec["ssm_serve"]["seconds"] = time.perf_counter() - t0
        log(f"[18b] took {rec['ssm_serve']['seconds']:.1f} s")
        t0 = time.perf_counter()
        rec["hybrid"], paths["hybrid_train"] = hybrid_phase(torch, dev,
                                                            wrappers)
        rec["hybrid"]["seconds"] = time.perf_counter() - t0
        log(f"[18c] took {rec['hybrid']['seconds']:.1f} s")
        t0 = time.perf_counter()
        rec["vlm"] = vlm_serve(torch, dev, out_dir)
        rec["vlm"]["seconds"] = time.perf_counter() - t0
        log(f"[18d] took {rec['vlm']['seconds']:.1f} s")
        t0 = time.perf_counter()
        rec["encoder_train"], paths["encoder_train"] = family_train(
            torch, dev, wrappers, "18e", ENC_ARCH,
            configs.get_config(ENC_ARCH, num_layers=ENC_LAYERS),
            ENC_TRAIN_STEPS)
        rec["encoder_train"]["seconds"] = time.perf_counter() - t0
        log(f"[18e] took {rec['encoder_train']['seconds']:.1f} s")
    finally:
        if rec["expandable_segments"]:
            _expandable_segments(torch, False)
    t0 = time.perf_counter()
    rec["small"] = {fam: family_small(torch, dev, fam) for fam in FAM_SMOKE}
    rec["small"]["seconds"] = time.perf_counter() - t0
    log(f"[18f] took {rec['small']['seconds']:.1f} s")
    return rec, paths


LONG_ARCH = "qwen3-4b"
LONG_LAYERS = 2            # 19b: 36 -> 2 layers, every width as published
LONG_R = 2                 # replicas stacked on the card
LONG_SEQ = 4096            # train_4k's rows: one a rank a microbatch
LONG_STEPS = 3
LONG_STATE_RTOL = 0.05     # 19c: the dry run's state against the card's
# 19a: (label, heads, kv heads, head dim, S, causal, window, dtypes)
LONG_ATTN = (("qwen3-4b causal", 32, 8, 128, 4096, True, 0,
              ("bfloat16", "float32")),
             ("hubert-xlarge non-causal", 16, 16, 80, 2048, False, 0,
              ("float32",)),
             ("qwen3-4b window 1024", 32, 8, 128, 4096, True, 1024,
              ("bfloat16",)))
# the chunked path against the plain one, as a share of the plain path's
# largest magnitude: f32 sums in another order (CPU: below 1e-6); bf16
# rounds each chunk's P·V and the plain path's backward runs in bf16
# (CPU at 4 heads: 3e-3 to 6e-3), and the chunked path's error against
# an f32 computation on the same inputs must stay within 1.5x the plain
# path's (+ 2e-3 of the magnitude)
LONG_ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _attn_run(torch, fn, q0, k0, v0, do0, dtype):
    """fn's output and the gradients of q, k, v for the cotangent do0,
    all on inputs cast to ``dtype``."""
    q, k, v = (t.to(dtype).requires_grad_(True) for t in (q0, k0, v0))
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do0.to(dtype))
    return [out.detach()] + list(grads)


def _peak_over(torch, fn) -> tuple:
    """(fn(), the bytes allocated at its peak above what was live before)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def long_attention(torch, dev, label, nh, nkv, hd, s, causal, window,
                   dtype_name) -> dict:
    """19a, one case: the chunked Function's forward and backward against
    the plain path's autograd on the same q, k, v (the GQA repeat outside
    the Function, as ``attention`` does), each path's time (CUDA events)
    and peak memory above its inputs."""
    from repro_torch.models import layers as L

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(s + nh + window)
    q0 = torch.randn((1, s, nh, hd), generator=gen, device=dev)
    k0, v0 = (torch.randn((1, s, nkv, hd), generator=gen, device=dev)
              for _ in range(2))
    do0 = torch.randn((1, s, nh, hd), generator=gen, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    i, j = pos[:, None], pos[None, :]
    mask = (i >= j) if causal else torch.ones((s, s), dtype=torch.bool,
                                              device=dev)
    if window:
        mask = mask & (i - j < window)
    g = nh // nkv

    def chunked(q, k, v):
        return L.flash_attention(q, torch.repeat_interleave(k, g, 2),
                                 torch.repeat_interleave(v, g, 2), pos,
                                 causal, window, L._KEY_CHUNK)

    def plain(q, k, v):
        return L._sdpa(q, k, v, mask, hd).reshape(1, s, nh, hd)

    got, peak_c = _peak_over(torch, lambda: _attn_run(
        torch, chunked, q0, k0, v0, do0, dtype))
    want, peak_p = _peak_over(torch, lambda: _attn_run(
        torch, plain, q0, k0, v0, do0, dtype))
    tol = LONG_ATTN_TOL[dtype_name]
    names = ("out", "dq", "dk", "dv")
    err = {}
    for n, a, b in zip(names, got, want):
        scale = float(b.float().abs().max())
        err[n] = float((a.float() - b.float()).abs().max()) / scale
        if not err[n] <= tol:
            fail(f"19a {label} {dtype_name}: chunked {n} differs from the "
                 f"plain path's by {err[n]:.3g} of its largest magnitude "
                 f"(tolerance {tol})")
    vs_f32 = {}
    if dtype != torch.float32:
        truth = _attn_run(torch, plain, q0, k0, v0, do0, torch.float32)
        for n, a, b, t in zip(names, got, want, truth):
            scale = float(t.abs().max())
            ec = float((a.float() - t).abs().max()) / scale
            ep = float((b.float() - t).abs().max()) / scale
            vs_f32[n] = {"chunked": ec, "plain": ep}
            if not ec <= 1.5 * ep + 2e-3:
                fail(f"19a {label} {dtype_name}: chunked {n} is {ec:.3g} "
                     f"from an f32 computation, the plain path {ep:.3g}")
        del truth
    del got, want
    ms_c = time_ms(torch, lambda: _attn_run(torch, chunked, q0, k0, v0, do0,
                                            dtype), reps=3)
    ms_p = time_ms(torch, lambda: _attn_run(torch, plain, q0, k0, v0, do0,
                                            dtype), reps=3)
    rec = {"label": label, "dtype": dtype_name, "heads": nh,
           "kv_heads": nkv, "head_dim": hd, "seq": s, "causal": causal,
           "window": window, "max_err_of_max": err, "vs_f32": vs_f32,
           "tolerance": tol, "chunked_ms": ms_c, "plain_ms": ms_p,
           "chunked_peak_gb": peak_c / 1e9, "plain_peak_gb": peak_p / 1e9}
    log(f"[19a] {label}, {dtype_name}, {nh} heads of {hd} (kv {nkv}), S = "
        f"{s}: forward + backward chunked {ms_c:.2f} ms, peak "
        f"{peak_c / 1e9:.2f} GB; plain {ms_p:.2f} ms, peak "
        f"{peak_p / 1e9:.2f} GB; chunked - plain (share of the largest "
        f"magnitude) {err} (tolerance {tol})"
        + (f"; each against f32 {vs_f32}" if vs_f32 else ""))
    return rec


def long_plain_step(torch, dev, cfg, tcfg, data) -> dict:
    """19b's step again with the chunked path forced off (the module's
    threshold raised past any length): two steps from a fresh state, the
    second's time and the peak. Running out of memory is recorded, not a
    failure."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    threshold, L._CHUNKED_MIN = L._CHUNKED_MIN, 1 << 62
    trainer = None
    try:
        trainer = Trainer(build_model(cfg), tcfg, data, dp_total=LONG_R,
                          device=dev)
        trainer.init_or_resume()
        tlog = trainer.run(2)
        rec = {"ran": True, "losses": list(tlog.losses),
               "step_ms": tlog.step_times[-1] * 1e3}
    except torch.cuda.OutOfMemoryError as exc:
        rec = {"ran": False, "out_of_memory": str(exc).splitlines()[0]}
    finally:
        L._CHUNKED_MIN = threshold
        del trainer
    rec.update(peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_long(torch, dev, wrappers):
    """Phase 19 (see the module docstring). Returns (record, {path:
    launches})."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model
    from repro_torch.utils.roofline import H100

    rec = {"attention": []}
    t0 = time.perf_counter()
    for label, nh, nkv, hd, s, causal, window, dtypes in LONG_ATTN:
        for dt in dtypes:
            rec["attention"].append(long_attention(
                torch, dev, label, nh, nkv, hd, s, causal, window, dt))
    log(f"[19a] took {time.perf_counter() - t0:.1f} s")

    # 19c's prediction, made on the meta device before the card trains
    t0 = time.perf_counter()
    cell = dryrun.run_cell(LONG_ARCH, "train_4k", dp_total=LONG_R,
                           layers=LONG_LAYERS)
    if cell["status"] != "ok":
        fail(f"19c: the dry run of {LONG_ARCH} train_4k: {cell}")
    cfg = configs.get_config(LONG_ARCH, num_layers=LONG_LAYERS)
    tcfg = configs.get_train_config(LONG_ARCH)
    ours = dryrun.train_cost(build_model(cfg), tcfg, LONG_R,
                             tcfg.microbatches, LONG_SEQ)
    log(f"[19c] dry run ({time.perf_counter() - t0:.1f} s, meta device): "
        f"{LONG_ARCH} train_4k at {LONG_LAYERS} layers, R = {LONG_R}: "
        f"state {cell['state_memory']}; the cell ({cell['tokens']} tokens "
        f"a step): bound {cell['roofline']['bound_s']:.3f} s "
        f"({cell['roofline']['dominant']}), peak estimate "
        f"{cell['peak_estimate'] / 1e9:.1f} GB, fits {cell['fits']}; this "
        f"phase's step ({ours['tokens']} tokens): counted "
        f"{ours['cost']['flops']:.4g} matmul FLOP, {ours['cost']['bytes']:.4g}"
        f" B, model FLOP {ours['model_flops']:.4g}, bound "
        f"{ours['roofline']['bound_s']:.4f} s ({ours['roofline']['dominant']}"
        f"), peak estimate {ours['peak_estimate'] / 1e9:.1f} GB")

    t0 = time.perf_counter()
    expandable = _expandable_segments(torch, True)
    try:
        rec["train"], launches = family_train(
            torch, dev, wrappers, "19b", LONG_ARCH, cfg, LONG_STEPS,
            replicas=LONG_R, seq=LONG_SEQ)
        rec["plain_step"] = long_plain_step(
            torch, dev, cfg, tcfg, data_config_for(
                cfg, LONG_R * tcfg.microbatches, LONG_SEQ))
    finally:
        if expandable:
            _expandable_segments(torch, False)
    rec["train"]["seconds"] = time.perf_counter() - t0
    mem = rec["train"]["memory"]
    plain = rec["plain_step"]
    log(f"[19b] took {rec['train']['seconds']:.1f} s; peak "
        f"{mem['peak_allocated_gb']:.2f} GB allocated, "
        f"{mem['peak_reserved_gb']:.2f} reserved with the chunked attention;"
        f" forced off: " + (f"step {plain['step_ms']:.1f} ms, " if
                            plain["ran"] else "out of memory, ")
        + f"peak {plain['peak_allocated_gb']:.2f} GB allocated, "
        f"{plain['peak_reserved_gb']:.2f} reserved")

    # 19c: the prediction against the card
    sm = cell["state_memory"]
    predicted = sm["total"] - sm["inflight"]   # Trainer.run holds none
    measured = mem["state_allocated_bytes"]
    step_s = rec["train"]["step_ms_median"] / 1e3
    rec["dryrun"] = {
        "cell": {k: cell[k] for k in ("state_memory", "roofline", "tokens",
                                      "peak_estimate", "fits", "reduced")},
        "step": {k: ours[k] for k in ("cost", "model_flops", "roofline",
                                      "peak_estimate", "remat_dup")},
        "state_predicted_bytes": predicted,
        "state_allocated_bytes": measured,
        "state_rel_err": abs(predicted - measured) / measured,
        # the bound's memory term counts every unfused eager op's operands
        # and results: the bound of this implementation, not of the
        # function; the compute term (matmul FLOPs at the bf16 peak) is
        # the function's
        "step_share_of_eager_bound": ours["roofline"]["bound_s"] / step_s,
        "step_share_of_compute_bound":
            ours["roofline"]["t_compute_s"] / step_s,
        "model_flop_share_of_bf16_peak":
            ours["model_flops"] / (step_s * H100.bf16),
        "counted_flop_share_of_bf16_peak":
            ours["cost"]["flops"] / (step_s * H100.bf16)}
    d = rec["dryrun"]
    log(f"[19c] state predicted {predicted} B (without the {sm['inflight']} "
        f"B of in-flight buffers), allocated by init_or_resume {measured} B:"
        f" {d['state_rel_err']:.2%} apart (limit {LONG_STATE_RTOL:.0%}); "
        f"the step ({step_s * 1e3:.1f} ms) reads "
        f"{d['step_share_of_eager_bound']:.1%} of the unfused eager ops' "
        f"bound ({ours['roofline']['bound_s'] * 1e3:.1f} ms, "
        f"{ours['roofline']['dominant']}) and "
        f"{d['step_share_of_compute_bound']:.1%} of its compute term "
        f"({ours['roofline']['t_compute_s'] * 1e3:.1f} ms); model FLOPs at "
        f"{d['model_flop_share_of_bf16_peak']:.1%} of the bf16 peak, counted"
        f" matmul FLOPs at {d['counted_flop_share_of_bf16_peak']:.1%}; peak "
        f"estimate {ours['peak_estimate'] / 1e9:.1f} GB against "
        f"{mem['peak_allocated_gb']:.2f} GB allocated")
    if not d["state_rel_err"] <= LONG_STATE_RTOL:
        fail(f"19c: the dry run's state {predicted} B is "
             f"{d['state_rel_err']:.2%} from the {measured} B the trainer "
             "allocated")
    return rec, {"long_train": launches}


# ---------------------------------------------------------------- 20
FSDP_ARCH = "dbrx-132b"
FSDP_LAYERS = 1            # 20a: 40 -> 1 layers, every width as published
FSDP_SEQ = (4096, 2048, 1024)  # 20a: a microbatch's one row, cut in turn
FSDP_STEPS = 3
FSDP_R = 4                 # 20b: lm-100m's ranks stacked
PG_STEPS = (2, 4)          # 20c: the checkpoint at 2, resumed to 4
CHAOS_SEED, CHAOS_STEPS = 4, 30   # 20c: restores after the first save

def _fingerprint(state) -> list:
    """Each tensor of a state (params, moments, residuals) as two 64-bit
    sums of its 32-bit words (its bytes where their count is no multiple
    of 4) on the card, the second weighted by a hash of each word's
    position, a slice of 2^26 words at a time: two states of equal bytes
    give equal lists, and one word apart changes the first sum. What 20a
    compares, where a host copy of dbrx's 27 GB state took 9 s."""
    import torch

    from repro_torch.utils.tree import tree_leaves

    step = 1 << 26
    out = []
    for f in ("params", "opt", "residuals"):
        for t in tree_leaves(getattr(state, f)):
            if t is None:
                continue
            raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
            if raw.numel() % 4 == 0:
                raw = raw.view(torch.int32)
            s1 = torch.zeros((), dtype=torch.int64, device=raw.device)
            s2 = torch.zeros_like(s1)
            for a in range(0, raw.numel(), step):
                x = raw[a:a + step].to(torch.int64)
                pos = torch.arange(a, a + x.numel(), dtype=torch.int64,
                                   device=raw.device)
                s1 += x.sum()
                s2 += (x * ((pos * 2654435761) % 4294967291 + 1)).sum()
            out.append((tuple(t.shape), str(t.dtype), int(s1), int(s2)))
    return out


def _nccl_world_of_one(torch, d: str):
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{d}/rendezvous",
                            world_size=1, rank=0)


def _fsdp_cells():
    """20a's runs in the order tried: dbrx-132b's own train_config at
    FSDP_LAYERS layers, a microbatch's row cut on running out of memory,
    then qwen3-4b at 2 layers under the dry run's dense override."""
    from repro_torch import configs
    from repro_torch.configs._common import make_train_config

    dbrx = (FSDP_ARCH, configs.get_config(FSDP_ARCH, num_layers=FSDP_LAYERS),
            configs.get_train_config(FSDP_ARCH), "its own train_config")
    for seq in FSDP_SEQ:
        yield dbrx + (seq,)
    yield ("qwen3-4b", configs.get_config("qwen3-4b", num_layers=2),
           make_train_config(sync_mode="dense", fsdp=True),
           "the dry run's dense override", FSDP_SEQ[0])


def fsdp_full_width(torch, dev, coll_pg) -> dict:
    """20a: dbrx-132b's own train_config (dense, fsdp, bf16 moments, 8
    microbatches) at its published widths cut to FSDP_LAYERS layers, one
    FSDP_SEQ-token row a microbatch, over the NCCL world of 1 and over
    StackedCollectives(1): FSDP_STEPS steps each, bit-equal (by each
    state's ``_fingerprint``); the step
    time and peaks beside the dry run's estimate. A run out of memory
    goes on to the next of ``_fsdp_cells``, as does a dbrx row length
    whose dry-run peak estimate exceeds the card (but the last), each
    recorded under "reduced"."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import Trainer

    reduced, runs, trainer, first = [], None, None, None
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[20a] device memory in use before: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    for arch, cfg, tcfg, which, seq in _fsdp_cells():
        model = build_model(cfg)
        data = DataConfig(global_batch=tcfg.microbatches, seq_len=seq,
                          vocab_size=cfg.vocab_size)
        est = dryrun.train_cost(model, tcfg, 1, tcfg.microbatches, seq)
        if not est["fits"] and arch == FSDP_ARCH and seq != FSDP_SEQ[-1]:
            log(f"[20a] {arch} at {seq} tokens a row: the dry run's peak "
                f"estimate {est['peak_estimate'] / 1e9:.1f} GB does not fit")
            reduced.append(f"{arch} at {cfg.num_layers} layer(s) and {seq} "
                           f"tokens a row: the dry run's peak estimate "
                           f"{est['peak_estimate'] / 1e9:.1f} GB")
            continue
        runs = {}
        try:
            for name, coll in (("process_group", coll_pg),
                               ("stacked", None)):
                trainer = None
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                trainer = Trainer(model, tcfg, data, dp_total=1, device=dev,
                                  lowering="manual", coll=coll)
                trainer.init()
                log_ = trainer.run(FSDP_STEPS)
                torch.cuda.synchronize()
                runs[name] = {
                    "losses": list(log_.losses),
                    "step_s": list(log_.step_times),
                    "peak_allocated_gb": torch.cuda.max_memory_allocated()
                    / 1e9,
                    "peak_reserved_gb": torch.cuda.max_memory_reserved()
                    / 1e9}
                t0 = time.perf_counter()
                runs[name]["fingerprint"] = _fingerprint(trainer.state)
                runs[name]["fingerprint_s"] = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as exc:
            log(f"[20a] {arch} ({which}) at {cfg.num_layers} layer(s), "
                f"{seq} tokens a row ran out of memory: {str(exc)[:200]}")
            reduced.append(f"{arch} at {cfg.num_layers} layer(s) and {seq} "
                           "tokens a row: out of memory")
            runs = trainer = None
            continue
        finally:
            trainer = None
        break
    if not runs:
        fail("20a: no fsdp cell fits the card")
    same = (runs["process_group"].pop("fingerprint")
            == runs["stacked"].pop("fingerprint"))
    gc.collect()
    torch.cuda.empty_cache()
    pg = runs["process_group"]
    rec = {"arch": arch, "train_config": which, "layers": cfg.num_layers,
           "seq": seq, "rows": tcfg.microbatches, "reduced": reduced,
           "bit_equal_to_stacked": same, "runs": runs,
           "step_s_median": statistics.median(pg["step_s"][1:]),
           "dryrun": {"peak_estimate_gb": est["peak_estimate"] / 1e9,
                      "state_gb": est["state_memory"]["total"] / 1e9,
                      "gathered_params_gb": est["gathered_params"] / 1e9,
                      "bound_s": est["roofline"]["bound_s"]}}
    log(f"[20a] {arch} ({which}) at {cfg.num_layers} layer(s), fsdp over an "
        f"NCCL world of 1, {tcfg.microbatches} microbatches of one "
        f"{seq}-token row, {FSDP_STEPS} steps: losses {pg['losses']}, step "
        f"{rec['step_s_median'] * 1e3:.1f} ms (steps {pg['step_s']}), peak "
        f"allocated {pg['peak_allocated_gb']:.2f} GB, reserved "
        f"{pg['peak_reserved_gb']:.2f} GB; the dry run's estimate: peak "
        f"{rec['dryrun']['peak_estimate_gb']:.2f} GB (state "
        f"{rec['dryrun']['state_gb']:.2f} GB, gathered params "
        f"{rec['dryrun']['gathered_params_gb']:.2f} GB), bound "
        f"{rec['dryrun']['bound_s']:.4f} s; bit-equal to "
        f"StackedCollectives(1) {same} (fingerprints "
        f"{pg['fingerprint_s']:.2f} + "
        f"{runs['stacked']['fingerprint_s']:.2f} s); reduced {reduced}")
    if not same:
        fail("20a: the fsdp step over NCCL differs from the stacked one")
    if not all(math.isfinite(v) for v in pg["losses"]):
        fail(f"20a: non-finite losses {pg['losses']}")
    return rec


def fsdp_stacked(torch, dev) -> dict:
    """20b: lm-100m with dense sync and fsdp over StackedCollectives(4)
    against the replicated dense step, FSDP_STEPS steps from one seed:
    losses and gathered params within rtol 1e-5 and a floor of 1e-5 of
    each tensor's largest magnitude."""
    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.models.model import build_model
    from repro_torch.train import run_lm
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_leaves

    cfg, data = run_lm.lm_config(fast=False)
    model = build_model(cfg)
    out = {}
    for name, fsdp in (("replicated", False), ("fsdp", True)):
        trainer = Trainer(model, run_lm.train_config(100, mode="dense",
                                                     fsdp=fsdp), data,
                          dp_total=FSDP_R, device=dev)
        trainer.init()
        log_ = trainer.run(FSDP_STEPS)
        params = trainer.state.params
        if fsdp:
            params = ts.gather_params(params, trainer.fsdp_layout,
                                      StackedCollectives(FSDP_R, dev))
        out[name] = (list(log_.losses), [t.clone() for t in
                                         tree_leaves(params)],
                     list(log_.step_times))
        del trainer, params
        gc.collect()
    (l0, p0, t0), (l1, p1, t1) = out["replicated"], out["fsdp"]
    worst = 0.0
    close = len(p0) == len(p1)
    for a, b in zip(p1, p0):
        floor = 1e-5 * float(b.abs().max())
        ok = bool(torch.all((a - b).abs() <= 1e-5 * b.abs() + floor))
        close = close and ok
        worst = max(worst, float((a - b).abs().max()) / max(
            float(b.abs().max()), 1e-30))
    losses_close = all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(l1, l0))
    rec = {"losses": l1, "replicated_losses": l0,
           "params_close": close, "losses_close": losses_close,
           "max_rel_of_largest": worst,
           "step_ms": statistics.median(t1[1:]) * 1e3,
           "replicated_step_ms": statistics.median(t0[1:]) * 1e3}
    log(f"[20b] lm-100m, dense sync, fsdp over StackedCollectives({FSDP_R}), "
        f"{FSDP_STEPS} steps: losses {l1} (replicated {l0}), params within "
        f"rtol 1e-5 + 1e-5 of the largest {close} (worst {worst:.3g} of "
        f"the largest); step {rec['step_ms']:.1f} ms (replicated "
        f"{rec['replicated_step_ms']:.1f} ms)")
    if not (close and losses_close):
        fail("20b: stacked fsdp differs from the replicated dense step")
    return rec


def pg_checkpoints(torch, dev, wrappers, coll_pg, d: Path) -> tuple:
    """20c (in this process): lm-100m's widths at CKPT_LAYERS layers,
    SparCML, over the NCCL world of 1: a checkpoint at step 2 holds the
    stacked run's arrays; a fresh process-group Trainer resumed from it
    and run to step 4 is bit-equal to the stacked run continued.
    Returns (record, launches)."""
    import numpy as np

    from repro_torch.models.model import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import run_lm
    from repro_torch.train.trainer import Trainer

    cfg, data = run_lm.lm_config(fast=False)
    model = build_model(dataclasses.replace(cfg, num_layers=CKPT_LAYERS))
    tcfg = run_lm.train_config(100)
    for w in wrappers.values():
        w.launches = 0

    def trainer(coll, where):
        return Trainer(model, tcfg, data, dp_total=1, device=dev,
                       lowering="manual", coll=coll, ckpt_dir=str(d / where))

    pg = trainer(coll_pg, "pg")
    pg.init()
    pg.run(PG_STEPS[0])
    del pg
    stacked = trainer(None, "stacked")
    stacked.init()
    stacked.run(PG_STEPS[0])
    stacked.ckpt_dir = None         # its one checkpoint is the one compared
    arrays = {}
    for where in ("pg", "stacked"):
        step_dir = d / where / f"step_{PG_STEPS[0]:08d}"
        with np.load(step_dir / "arrays.npz") as z:
            arrays[where] = {k: z[k] for k in z.files}
        arrays[where + "_meta"] = ckpt.load_meta(str(d / where),
                                                 PG_STEPS[0])
    same_arrays = (arrays["pg"].keys() == arrays["stacked"].keys() and all(
        np.array_equal(arrays["pg"][k], arrays["stacked"][k])
        for k in arrays["pg"]) and arrays["pg_meta"]["paths"]
        == arrays["stacked_meta"]["paths"])
    del arrays
    t0 = time.perf_counter()
    resumed = trainer(coll_pg, "pg")
    at = resumed.init_or_resume()
    restore_s = time.perf_counter() - t0
    resumed.ckpt_dir = None
    resumed.run(PG_STEPS[1])
    stacked.run(PG_STEPS[1])
    same = at == PG_STEPS[0] and _same(_clone_state(resumed.state),
                                       _clone_state(stacked.state))
    launches = {nm: w.launches for nm, w in wrappers.items()}
    rec = {"checkpoint_arrays_equal": same_arrays, "resumed_at": at,
           "resume_bit_equal": same, "restore_s": restore_s,
           "launches": launches}
    log(f"[20c] lm-100m at {CKPT_LAYERS} layers, SparCML, NCCL world of 1: "
        f"the step-{PG_STEPS[0]} checkpoint's arrays equal the stacked "
        f"run's {same_arrays}; a fresh Trainer resumed at step {at} "
        f"({restore_s:.2f} s with the CRC checks) and run to "
        f"{PG_STEPS[1]} bit-equal to the stacked run continued {same}; "
        f"launches {launches}")
    if not (same_arrays and same):
        fail("20c: the process-group checkpoint differs from the stacked "
             "run's, or its resume does")
    del resumed, stacked
    gc.collect()
    return rec, launches


def run_chaos(wrappers, d: Path) -> tuple:
    """20c: run_lm --lowering manual --pipeline --chaos CHAOS_SEED over
    CHAOS_STEPS steps, lm-100m at CKPT_LAYERS layers, in this process
    under torchrun's variables for a world of 1 (run_lm joins its own
    NCCL group and leaves it): it must end at its last step with its
    planned faults injected, one restart a planned collective raise, the
    corrupted save skipped once, and the four kernels launched. Its
    Trainer is kept, and its saves and restores timed, by wrapping the
    Trainer's methods for the run. Returns (record, launches)."""
    import contextlib
    import io
    import socket

    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.train import run_lm
    from repro_torch.train.trainer import Trainer

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    was_env = {k: os.environ.get(k) for k in env}
    full = run_lm.lm_config
    inner = {n: getattr(Trainer, n)
             for n in ("run_pipelined", "_save", "_restore")}
    kept, times = {}, {"_save": [], "_restore": []}

    def keep(self, *a, **k):
        kept["trainer"] = self
        return inner["run_pipelined"](self, *a, **k)

    def timed(name):
        def run(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return inner[name](self, *a, **k)
            finally:
                times[name].append(time.perf_counter() - t0)
        return run

    for w in wrappers.values():
        w.launches = 0
    os.environ.update(env)
    run_lm.lm_config = lambda fast: (
        dataclasses.replace(full(fast)[0], num_layers=CKPT_LAYERS),
        full(fast)[1])
    Trainer.run_pipelined = keep
    Trainer._save, Trainer._restore = timed("_save"), timed("_restore")
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            run_lm.main(["--lowering", "manual", "--pipeline", "--chaos",
                         str(CHAOS_SEED), "--steps", str(CHAOS_STEPS),
                         "--ckpt-dir", str(d / "chaos_ckpt")])
    finally:
        seconds = time.perf_counter() - t0
        run_lm.lm_config = full
        for n, f in inner.items():
            setattr(Trainer, n, f)
        for k, v in was_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = {nm: w.launches for nm, w in wrappers.items()}
    t = kept.pop("trainer")
    reg = t.obs.metrics
    got = {"world": t.coll.p if t.coll is not None else None,
           "injected": [[e["fault"], e["step"]]
                        for e in reg.events_named("faults/injected")],
           "restarts": [e["error"]
                        for e in reg.events_named("driver/restart")],
           "fallbacks": len(reg.events_named("recovery/ckpt_fallback")),
           "step": int(t.state.step), "save_s": times["_save"],
           "restore_s": times["_restore"], "launches": launches}
    del t
    gc.collect()
    plan = FaultPlan.chaos(CHAOS_SEED, CHAOS_STEPS, ckpt_every=10)
    planned = sorted({(s.kind, s.step) for s in plan.specs})
    n_collective = len(plan.by_kind("collective"))
    as_planned = (got["world"] == 1 and got["step"] == CHAOS_STEPS
                  and sorted({tuple(e) for e in got["injected"]}) == planned
                  and got["restarts"] == ["FaultInjectionError"]
                  * n_collective and got["fallbacks"] == 1)
    rec = {**got, "planned": planned, "as_planned": as_planned,
           "seconds": seconds,
           "stdout": [ln for ln in out.getvalue().splitlines()
                      if ln.startswith(("done:", "chaos", "starting"))]}
    log(f"[20c] run_lm --pipeline --chaos {CHAOS_SEED} under torchrun's "
        f"variables (world {got['world']}, {CHAOS_STEPS} steps, "
        f"{seconds:.1f} s): injected "
        f"{got['injected']}, restarts {got['restarts']}, checkpoint "
        f"fallbacks {got['fallbacks']}; as planned {as_planned}; launches "
        f"{launches}; saves {[round(v, 2) for v in got['save_s']]} s, "
        f"restores {[round(v, 2) for v in got['restore_s']]} s")
    if not as_planned:
        fail(f"20c: the chaos run did not recover as planned: {got}")
    for nm in ("bucket_topk", "bucket_scatter_sum", "qsgd_pack",
               "qsgd_unpack_grouped"):
        if not launches.get(nm):
            fail(f"20c: {nm} was not launched on the chaos run")
    return rec, launches


def phase_fsdp(torch, dev, wrappers, out_dir: Path):
    """Phase 20 (see the module docstring). Returns (record, {path:
    launches})."""
    import torch.distributed as dist

    from repro_torch.comm.collectives import ProcessGroupCollectives

    rec: dict = {}
    paths: dict = {}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        d = Path(tmp)
        _nccl_world_of_one(torch, tmp)
        try:
            coll = ProcessGroupCollectives(device=dev)
            expandable = _expandable_segments(torch, True)
            try:
                t0 = time.perf_counter()
                rec["full_width"] = fsdp_full_width(torch, dev, coll)
                log(f"[20a] took {time.perf_counter() - t0:.1f} s")
            finally:
                if expandable:
                    _expandable_segments(torch, False)
            t0 = time.perf_counter()
            rec["stacked"] = fsdp_stacked(torch, dev)
            log(f"[20b] took {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            rec["checkpoints"], paths["pg_checkpoints"] = pg_checkpoints(
                torch, dev, wrappers, coll, d)
            log(f"[20c] checkpoints took {time.perf_counter() - t0:.1f} s")
        finally:
            dist.destroy_process_group()
        rec["chaos"], paths["pg_chaos"] = run_chaos(wrappers, d)
    return rec, paths


# ---------------------------------------------------------------- 22
AUTO_STEPS = 3             # 22a: lm-100m under "auto", then named
FSDP_SERVE_ARCH = "llama3-405b"
FSDP_SERVE_LAYERS = 2      # 22b: 126 -> 2 layers, every width as published
FSDP_SERVE_SLOTS = 8       # 128 -> 8 rows
FSDP_SERVE_CACHE = 2048    # 32768 -> 2048 positions
FSDP_SERVE_PROMPT = 128
FSDP_SERVE_STEPS = 16
FSDP_SERVE_P = 2           # stacked ranks holding the shards


def _expected_launches(plan, steps: int) -> dict:
    """What a stacked step's reduce half launches under ``plan``: one
    bucket_topk an EF bucket, one grouped densify + sum for every 64 EF
    buckets, one grouped pack and unpack for every 48 quantized DSAR
    buckets."""
    ef = [b for b in plan.buckets if b.has_residual]
    q = [b for b in ef if b.algorithm == "dsar_split_allgather"
         and plan.cfg.qsgd_bits is not None]
    return {"bucket_topk": len(ef) * steps, "bucket_scatter": 0,
            "bucket_scatter_sum": -(-len(ef) // 64) * steps,
            "qsgd_pack": -(-len(q) // 48) * steps, "qsgd_unpack": 0,
            "qsgd_unpack_grouped": -(-len(q) // 48) * steps}


def auto_main_path(torch, dev, wrappers, n: int = 1 << 24) -> tuple:
    """22a: lm-100m as phase 3 runs it with ``algorithm="auto"``: the
    Trainer fits the network on the stacked ranks and selects each
    bucket's algorithm; AUTO_STEPS steps through the kernels, launches
    against the resolved plan, bit-equal to the same steps with the
    resolved algorithm named. Then make_sparse_allreduce("auto") at Fig.
    3's shapes on a fit over its 8 ranks, against the exact f64 sum."""
    from collections import Counter

    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.core import allreduce as ar
    from repro_torch.core.topk import compress
    from repro_torch.models.model import build_model
    from repro_torch.train import run_lm
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.calibrate import calibrate
    from repro_torch.utils.tree import tree_leaves

    rec: dict = {}
    cfg, data = run_lm.lm_config(fast=False)
    tcfg = run_lm.train_config(AUTO_STEPS, algorithm="auto")
    t0 = time.perf_counter()
    trainer = Trainer(build_model(cfg), tcfg, data, dp_total=run_lm.DP,
                      device=dev)
    build_s = time.perf_counter() - t0
    net = trainer._calibrated_net()
    plan = trainer.plan
    picked = dict(Counter(b.algorithm for b in plan.buckets))
    log(f"[22a] lm-100m, algorithm 'auto': fitted on the {run_lm.DP} "
        f"stacked ranks (the device's sum; no wire) alpha {net.alpha:.4e} "
        f"s, {net.link_bytes_per_s / 1e9:.2f} GB/s; buckets by algorithm "
        f"{picked} (EF buckets {sum(b.has_residual for b in plan.buckets)}"
        f"); the Trainer with its fit and plan in {build_s:.2f} s")
    trainer.init()
    for w in wrappers.values():
        w.launches = 0
    tlog = trainer.run(AUTO_STEPS)
    launches = {n: w.launches for n, w in wrappers.items()}
    expect = _expected_launches(plan, AUTO_STEPS)
    step_ms = statistics.median(tlog.step_times) * 1e3
    log(f"[22a] {AUTO_STEPS} steps: losses {tlog.losses}, median step "
        f"{step_ms:.1f} ms; launches {launches} (the resolved plan's "
        f"{expect})")
    if launches != expect:
        fail(f"22a: launches {launches}, the resolved plan gives {expect}")
    if not all(math.isfinite(v) for v in tlog.losses):
        fail(f"22a: non-finite losses {tlog.losses}")
    # the same steps with the resolved algorithm named
    ef_algos = {b.algorithm for b in plan.buckets if b.has_residual}
    if len(ef_algos) != 1:
        fail(f"22a: the EF buckets resolved to {ef_algos}: no one named "
             "algorithm gives this plan")
    named = Trainer(build_model(cfg), dataclasses.replace(
        tcfg, sync=dataclasses.replace(tcfg.sync,
                                       algorithm=ef_algos.pop())),
        data, dp_total=run_lm.DP, device=dev)
    if named.plan.algorithms() != plan.algorithms():
        fail("22a: the named algorithm's plan is not the resolved one")
    named.init()
    nlog = named.run(AUTO_STEPS)
    same = nlog.losses == tlog.losses and all(
        torch.equal(a, b) for f in ("params", "residuals")
        for a, b in zip(tree_leaves(getattr(trainer.state, f)),
                        tree_leaves(getattr(named.state, f))))
    log(f"[22a] against the resolved algorithm named: bit-equal {same}")
    if not same:
        fail("22a: 'auto' differs from its resolved algorithm named")
    rec["lm100m"] = {"alpha_s": net.alpha,
                     "link_bytes_per_s": net.link_bytes_per_s,
                     "buckets_by_algorithm": picked,
                     "losses": list(tlog.losses),
                     "step_times_s": list(tlog.step_times),
                     "median_step_ms": step_ms, "launches": launches,
                     "bit_equal_named": same, "build_s": build_s}
    del trainer, named
    gc.collect()
    torch.cuda.empty_cache()

    # -- make_sparse_allreduce("auto") at Fig. 3's shapes
    p, b = 8, 512
    coll = StackedCollectives(p, dev)
    t0 = time.perf_counter()
    net8 = calibrate(coll)
    fit_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(2024)
    x = torch.randn((p, n), device=dev, generator=gen)
    clamped = {"ssar_balanced_split": ar.ssar_balanced_split_inside,
               "ssar_rearranged_rs": ar.ssar_rearranged_rs_inside}
    fig3 = {"alpha_s": net8.alpha, "link_bytes_per_s": net8.link_bytes_per_s,
            "fit_s": fit_s, "runs": []}
    fig3_launches = {nm: 0 for nm in wrappers}
    for k in (4, 64):
        f = ar.make_sparse_allreduce(coll, n, k, b, net=net8)
        for w in wrappers.values():
            w.launches = 0
        out = f(x)
        torch.cuda.synchronize()
        for nm, w in wrappers.items():
            fig3_launches[nm] += w.launches
        u_ref, _ = compress(x, k, b, impl="ref")
        exact = u_ref.densify(impl="ref").double().sum(0)
        got = out[0].double()
        if f.algorithm in clamped:
            u, _ = compress(x, k, b)
            dense, fold = clamped[f.algorithm](u, coll=coll)
            if not torch.equal(dense, out):
                fail(f"22a fig3 k={k}: make_sparse_allreduce differs from "
                     f"its *_inside function")
            got = got + fold.double().sum(0)
            del u, dense, fold
        scale = float(exact.abs().max())
        err = float(((got - exact).abs() - 1e-5 * exact.abs()).max()) / scale
        ms = time_ms(torch, lambda: f(x))
        row = {"k": k, "algorithm": f.algorithm, "ms": ms,
               "max_err_over_1e-5_rel": err}
        fig3["runs"].append(row)
        log(f"[22a] fig3 N={n} P={p} k={k}, 'auto' on the card's fit "
            f"(alpha {net8.alpha:.4e} s, {net8.link_bytes_per_s / 1e9:.2f} "
            f"GB/s, {fit_s:.2f} s): {f.algorithm}, {ms:.3f} ms; max "
            f"(|err| - 1e-5 |sum|) / max|sum| {err:.3e} (limit 1e-6)")
        if err > 1e-6:
            fail(f"22a fig3 k={k} {f.algorithm}: error {err:.3e}")
        del out, u_ref, exact, got
    rec["fig3"] = fig3
    del x
    gc.collect()
    torch.cuda.empty_cache()
    return rec, {"auto_main": launches, "auto_fig3": fig3_launches}


def fsdp_serving(torch, dev, wrappers, out_dir: Path) -> tuple:
    """22b: llama3-405b at its published widths, FSDP_SERVE_LAYERS layers,
    random bf16 weights: a prefill of FSDP_SERVE_SLOTS prompts and
    FSDP_SERVE_STEPS greedy decode steps with the params replicated, as
    fsdp shards over FSDP_SERVE_P stacked ranks, and as a one-process
    NCCL group's shards: logits and tokens bit-equal; each form's decode
    step and peak, the gathered layer's transient beside the dry run's
    estimate."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.comm.collectives import (ProcessGroupCollectives,
                                              StackedCollectives)
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model, init_params
    from repro_torch.serve.engine import build_prefill, build_serve_step
    from repro_torch.train import train_step as ts
    from repro_torch.utils.tree import tree_leaves

    cfg = configs.get_config(FSDP_SERVE_ARCH, num_layers=FSDP_SERVE_LAYERS)
    model = build_model(cfg)
    full = configs.get_config(FSDP_SERVE_ARCH).num_layers
    reduced = [f"depth {full} -> {FSDP_SERVE_LAYERS}",
               f"batch 128 -> {FSDP_SERVE_SLOTS} slots",
               f"cache 32768 -> {FSDP_SERVE_CACHE}"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    prompts = torch.randint(0, cfg.vocab_size,
                            (FSDP_SERVE_SLOTS, FSDP_SERVE_PROMPT),
                            device=dev, generator=gen, dtype=torch.int32)
    layout = ts.fsdp_layout_of(model, FSDP_SERVE_P)
    estimate = dryrun.gathered_unit_bytes(
        init_params(cfg, device="meta"), layout, cfg)

    def serve(held, fsdp, coll):
        pre = build_prefill(model, FSDP_SERVE_CACHE, fsdp=fsdp, coll=coll)
        step = build_serve_step(model, FSDP_SERVE_CACHE, fsdp=fsdp,
                                coll=coll)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        logits, state = pre(held, {"tokens": prompts})
        seen, toks = [logits], []
        for _ in range(FSDP_SERVE_STEPS):
            cur = torch.argmax(logits, -1, keepdim=True).to(torch.int32)
            toks.append(cur)
            logits, state = step(held, state, cur)
            seen.append(logits)
        torch.cuda.synchronize()
        return (torch.stack(seen), torch.cat(toks, 1),
                torch.cuda.max_memory_allocated() - base, base)

    def timed(held, fsdp, coll):
        """The decode step's median ms (CUDA events), its state as the
        prefill left it, FSDP_SERVE_STEPS steps."""
        pre = build_prefill(model, FSDP_SERVE_CACHE, fsdp=fsdp, coll=coll)
        step = build_serve_step(model, FSDP_SERVE_CACHE, fsdp=fsdp,
                                coll=coll)
        logits, state = pre(held, {"tokens": prompts})
        cur = torch.argmax(logits, -1, keepdim=True).to(torch.int32)
        ms = []
        for _ in range(FSDP_SERVE_STEPS):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            step(held, state, cur)
            t1.record()
            t1.synchronize()
            ms.append(t0.elapsed_time(t1))
        return statistics.median(ms)

    rec: dict = {"reduced": reduced, "params": n_params,
                 "gathered_estimate_bytes": estimate}
    forms: dict = {}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    want = serve(params, False, None)
    forms["replicated"] = (want, timed(params, False, None))
    coll = StackedCollectives(FSDP_SERVE_P, dev)
    held = ts.shard_params(params, layout, ts.held_ranks(coll, FSDP_SERVE_P))
    forms[f"stacked{FSDP_SERVE_P}"] = (serve(held, True, coll),
                                       timed(held, True, coll))
    del held
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        _nccl_world_of_one(torch, tmp)
        try:
            pg = ProcessGroupCollectives(device=dev)
            held = ts.shard_params(params, ts.fsdp_layout_of(model, 1),
                                   ts.held_ranks(pg, 1))
            forms["nccl1"] = (serve(held, True, pg), timed(held, True, pg))
            del held
        finally:
            dist.destroy_process_group()
    launches = {n: w.launches for n, w in wrappers.items()}
    for name, ((logits, toks, peak, base), ms) in forms.items():
        same = (torch.equal(logits, want[0]) and torch.equal(toks, want[1]))
        rec[name] = {"decode_step_ms": ms, "peak_above_held_bytes": peak,
                     "held_bytes": base, "bit_equal_replicated": same}
        log(f"[22b] {FSDP_SERVE_ARCH} at {FSDP_SERVE_LAYERS} layers, "
            f"{cfg.dtype}, "
            f"{n_params} params, {name}: decode step {ms:.2f} ms (median "
            f"of {FSDP_SERVE_STEPS}, CUDA events), {base / 1e9:.2f} GB held "
            f"before the prefill, peak {peak / 1e9:.2f} GB above it; logits "
            f"and tokens bit-equal to replicated {same}")
        if not same:
            fail(f"22b: fsdp serving ({name}) differs from replicated")
        del logits, toks
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    log(f"[22b] the gathered layer's transient (the stacked form's peak "
        f"above its held shards and caches) "
        f"{rec[f'stacked{FSDP_SERVE_P}']['peak_above_held_bytes'] / 1e9:.2f}"
        f" GB against the dry run's one gathered layer "
        f"{estimate / 1e9:.2f} GB; reduced {reduced}; launches {launches}")
    del params, want
    gc.collect()
    torch.cuda.empty_cache()
    return rec, {"serve_fsdp": launches}


def phase_auto_fsdp(torch, dev, wrappers, out_dir: Path) -> tuple:
    """Phase 22 (see the module docstring). Returns (record, {path:
    launches})."""
    rec: dict = {}
    t0 = time.perf_counter()
    rec["auto"], paths = auto_main_path(torch, dev, wrappers)
    log(f"[22a] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["serve_fsdp"], more = fsdp_serving(torch, dev, wrappers, out_dir)
    log(f"[22b] took {time.perf_counter() - t0:.1f} s")
    paths.update(more)
    return rec, paths


def _expandable_segments(torch, on: bool) -> bool:
    """Switch the caching allocator's expandable segments (new segments
    only; the cache is emptied first). False where the build has no such
    setting."""
    gc.collect()
    torch.cuda.empty_cache()
    setting = (getattr(torch._C, "_accelerator_setAllocatorSettings", None)
               or torch.cuda.memory._set_allocator_settings)
    try:
        setting(f"expandable_segments:{on}")
    except (AttributeError, RuntimeError) as exc:
        log(f"[17] expandable segments not available: {exc}")
        return False
    return True


def _to(tree, device):
    return {k: (_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


if __name__ == "__main__":
    main()
