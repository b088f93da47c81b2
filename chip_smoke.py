#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. environment: torch / CUDA versions, the card's name and power limit;
  1. build: compile the four CUDA kernels from src/repro_torch/csrc;
  2. one phase per kernel at the shapes of the main path (the 26 sparse
     buckets of lm-100m, R = 4 replicas): each kernel is held against its
     plain PyTorch version on the card, and timed with CUDA events beside
     the plain version, a PyTorch library call where one computes the
     same function, and the memory-bandwidth bound; qsgd_unpack is timed
     as the main path calls it, one grouped launch over the 26 buckets
     that writes their reduced buffers, and its single-bucket form is
     checked on every bucket and timed alone on the largest;
     The three per-bucket kernels are also timed as their 26 launches
     replayed from a CUDA graph (the device alone) and as the host's
     enqueue time;
  3. main paths, each with every kernel's launch count reset before and
     read after: Trainer.run of lm-100m with SparCML sync (DSAR + 4-bit
     QSGD, k = 8 of 512, R = 4 stacked replicas) for 6 steps (26 launches
     a step of bucket_topk, bucket_scatter and qsgd_pack, one grouped
     qsgd_unpack a step); 3 more under the profiler (the device's idle
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
     driver (K = 4, depth 2, under the profiler: the streams' busy and
     overlapping shares) must equal, bit for bit, the same step function
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
  7. the kernels line, the card line, and last the result line
     {"ok": true, "device": {...}}.

It imports torch and the port (``src/repro_torch``), never JAX. A longer
record of the run goes to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import gc
import json
import math
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

# Published peaks (NVIDIA data sheets): memory bytes/s and f32 (non-tensor)
# FLOP/s, by the card's name. An unknown card is refused rather than
# measured against the wrong roofline.
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),       # SXM, 80 GB
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks_for(name: str) -> tuple[float, float]:
    for key, val in PEAKS.items():
        if key in name:
            return val
    fail(f"no published peaks for {name!r}")


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
    from repro_torch.kernels.bucket_topk import ops as topk_ops
    from repro_torch.kernels.qsgd_pack import ops as pack_ops
    from repro_torch.kernels.qsgd_pack.ref import u32_to_i64
    from repro_torch.kernels.qsgd_unpack import ops as unpack_ops
    from repro_torch.kernels.qsgd_unpack.ref import (UnpackSegment,
                                                     qsgd_unpack_ref)
    from repro_torch.core.qsgd import random_bits
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import build_model
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.comm.executor import (apply_buckets_spmd,
                                           reduce_buckets_spmd)
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.runtime.driver import DriverConfig, run_pipelined
    from repro_torch.runtime.pipeline import attach_inflight, build_superstep
    from repro_torch.train import run_lm
    from repro_torch.train import train_step as ts
    from repro_torch.train.train_step import build_plan, init_state
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_leaves

    record: dict = {}
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- 0
    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    card = f"{name}, power limit not read"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            card = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired) as exc:
        card += f" ({exc})"
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
    cfg, _ = run_lm.lm_config(fast=False)
    tcfg = run_lm.train_config(STEPS)
    plan = build_plan(build_model(cfg), tcfg, run_lm.DP)
    sync = tcfg.sync
    r, b, k = run_lm.DP, sync.bucket_size, sync.k_per_bucket
    bq, bits = sync.qsgd_bucket, sync.qsgd_bits
    sparse = [bk for bk in plan.buckets if bk.sparse]
    if len(sparse) != 26:
        fail(f"lm-100m plan has {len(sparse)} sparse buckets, expected 26")
    big = max(range(len(sparse)), key=lambda i: sparse[i].n)
    log(f"[2] {len(sparse)} sparse buckets; largest {sparse[big].name} "
        f"({sparse[big].rows} x {sparse[big].cols}) = "
        f"{sparse[big].n / sum(bk.n for bk in sparse):.1%} of the entries")

    gen = torch.Generator(device=dev).manual_seed(1234)
    xs = []
    for i, bk in enumerate(sparse):
        x = torch.randn((r * bk.rows * (bk.cols // b), b), device=dev,
                        generator=gen)
        x[::7] = torch.round(x[::7] * 4) / 4          # magnitude ties
        x[::101] = 0.0                                # all-zero buckets
        xs.append(x)
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
          8 * n_top + 8 * rows_top * k, rows_top * k * b, 0.0,
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

    # -- bucket_scatter: bit-equal on the path's (distinct) indices;
    #    allclose 1e-6 with duplicates and sentinels
    dens = [scatter_ops.bucket_scatter(li, va, b, impl="cuda")
            for li, va in streams]
    for (li, va), got in zip(streams, dens):
        if not torch.equal(got, scatter_ops.bucket_scatter(li, va, b,
                                                           impl="ref")):
            fail("bucket_scatter kernel differs from its plain version")
    li, va = streams[big]
    dup = torch.randint(-2, 24, li.shape, dtype=torch.int32, device=dev,
                        generator=gen)
    dup[dup >= 16] = b + 3
    dup_err = float((scatter_ops.bucket_scatter(dup, va, b, impl="cuda")
                     - scatter_ops.bucket_scatter(dup, va, b, impl="ref"))
                    .abs().max())
    if not dup_err <= 1e-6:
        fail(f"bucket_scatter with duplicates: max abs err {dup_err}")
    idx64 = [li_.to(torch.int64) for li_, _ in streams]
    lib_out = [torch.empty((li_.shape[0], b), device=dev) for li_, _ in streams]

    def lib_scatter():
        for o, ix, (_, va_) in zip(lib_out, idx64, streams):
            o.zero_().scatter_add_(1, ix, va_)

    entry("bucket_scatter", "src/repro_torch/csrc/bucket_scatter.cu",
          "src/repro/kernels/bucket_scatter/kernel.py:29",
          "phase 2: bit-equal to bucket_scatter_ref on the path's streams "
          f"(26 buckets); duplicates + sentinels max abs err {dup_err}",
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
    del lib_out, idx64, streams, xs
    gc.collect()

    # -- qsgd_pack / qsgd_unpack on the owners' shards of the summed
    #    densified streams, laid out as the executor lays them out
    qx = []
    for bk, d in zip(sparse, dens):
        summed = d.reshape(r, bk.rows, bk.cols).sum(0)
        shard = bk.cols // r
        qx.append(summed.reshape(bk.rows, r, shard).permute(1, 0, 2)
                  .reshape(-1, bq).contiguous())
    del dens
    gc.collect()
    qr = [random_bits(x.numel(), gen, dev).reshape(x.shape) for x in qx]
    n_q = sum(x.numel() for x in qx)
    rows_q = sum(x.shape[0] for x in qx)
    vpw = 32 // bits
    s_lv = 2 ** (bits - 1) - 1
    for x, rd in zip(qx, qr):                          # 'max': bit-equal
        p, sc = pack_ops.qsgd_pack(x, rd, bits, "max", impl="cuda")
        pr, scr = pack_ops.qsgd_pack(x, rd, bits, "max", impl="ref")
        if not (torch.equal(sc, scr)
                and torch.equal(p.view(torch.int32), pr.view(torch.int32))):
            fail("qsgd_pack ('max') differs from its plain version")
    packs, pack_err, flips, n_codes = [], 0.0, 0, 0
    shifts = torch.arange(vpw, device=dev) * bits
    for x, rd in zip(qx, qr):                          # 'l2': the path's mode
        p, sc = pack_ops.qsgd_pack(x, rd, bits, "l2", impl="cuda")
        pr, scr = pack_ops.qsgd_pack(x, rd, bits, "l2", impl="ref")
        c = (u32_to_i64(p)[..., None] >> shifts) & (2**bits - 1)
        cr = (u32_to_i64(pr)[..., None] >> shifts) & (2**bits - 1)
        dc = (c - cr).abs()
        if int(dc.max()) > 1:
            fail("qsgd_pack ('l2') codes differ by more than one level")
        flips += int((dc > 0).sum())
        n_codes += dc.numel()
        pack_err = max(pack_err, float(
            (qsgd_unpack_ref(p, sc, bits) - qsgd_unpack_ref(pr, scr, bits))
            .abs().max()))
        packs.append((p, sc))
    if flips > 1e-4 * n_codes:
        fail(f"qsgd_pack ('l2'): {flips} of {n_codes} codes moved a level")
    mode = sync.qsgd_scale
    entry("qsgd_pack", "src/repro_torch/csrc/qsgd_pack.cu",
          "src/repro/kernels/qsgd_pack/kernel.py:46",
          "phase 2: bit-equal to qsgd_pack_ref in 'max' mode; in 'l2' mode "
          f"{flips} of {n_codes} codes one level apart (limit 1e-4)",
          time_ms(torch, lambda: [pack_ops.qsgd_pack(x, rd, bits, mode,
                                                     impl="cuda")
                                  for x, rd in zip(qx, qr)]),
          time_ms(torch, lambda: [pack_ops.qsgd_pack(x, rd, bits, mode,
                                                     impl="ref")
                                  for x, rd in zip(qx, qr)], reps=3),
          None,
          8 * n_q + n_q * bits // 8 + 4 * rows_q, 6 * n_q, pack_err,
          time_ms(torch, lambda: pack_ops.qsgd_pack(qx[big], qr[big], bits,
                                                    mode, impl="cuda")),
          time_ms(torch, lambda: pack_ops.qsgd_pack(qx[big], qr[big], bits,
                                                    mode, impl="ref"),
                  reps=3),
          device_ms=graph_ms(torch, lambda: [pack_ops.qsgd_pack(
              x, rd, bits, mode, impl="cuda") for x, rd in zip(qx, qr)]),
          host_ms=host_ms(torch, lambda: [pack_ops.qsgd_pack(
              x, rd, bits, mode, impl="cuda") for x, rd in zip(qx, qr)]))
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
    del segs, qx, qr, packs
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 3
    wrappers = {"bucket_topk": topk_ops.bucket_topk,
                "bucket_scatter": scatter_ops.bucket_scatter,
                "qsgd_pack": pack_ops.qsgd_pack,
                "qsgd_unpack": unpack_ops.qsgd_unpack,
                "qsgd_unpack_grouped": unpack_ops.qsgd_unpack_grouped}
    expect = {"bucket_topk": len(sparse) * STEPS,
              "bucket_scatter": len(sparse) * STEPS,
              "qsgd_pack": len(sparse) * STEPS,
              "qsgd_unpack": 0,                     # the grouped form instead
              "qsgd_unpack_grouped": STEPS}
    cfg, data = run_lm.lm_config(fast=False)
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
    # retire intervals of the units (each step time is its unit's / K).
    # The host runs only as far ahead as the launch queue lets it, so the
    # first interval holds the fill (the first unit and most of the
    # second) and the last one only the drain; the units between them
    # are the steady state.
    units_ms = [pipe_times[i] * K_UNIT * 1e3
                for i in range(0, len(pipe_times), K_UNIT)]
    pipe_ms = statistics.median(units_ms[1:-1]) / K_UNIT
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
    rand0 = ts.step_rand_fn(tcfg3.seed, 0, dev)
    reduce = lambda: reduce_buckets_spmd(trainer.plan, leaves_r,
                                         st.residuals, p_data=run_lm.DP,
                                         rand_fn=rand0)
    reduce_ms = time_ms(torch, reduce, reps=3)
    reduced, new_res = reduce()
    lr0 = torch.tensor(1e-4)
    update_ms = time_ms(torch, lambda: ts.update(
        st, apply_buckets_spmd(trainer.plan, reduced, leaves_r), lr0, tcfg3),
        reps=3)
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
                                     steps=K_UNIT, guard=True)

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
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


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


def _to(tree, device):
    return {k: (_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


if __name__ == "__main__":
    main()
