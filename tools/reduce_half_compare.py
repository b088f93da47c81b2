#!/usr/bin/env python3
"""Time the stacked lm-100m reduce half of two or more trees of the
repository against each other on one card, in turns.

    python3 tools/reduce_half_compare.py LABEL=TREE [LABEL=TREE ...]

TREE is the root of a checkout (the current one is ``.``; an older commit
unpacked with ``git archive <commit> | tar -x -C build/parent``). Each
tree is measured in a process of its own that imports that tree's
``src/repro_torch`` (and builds its kernels), in the order A B .. B A,
twice, so that a drift of the card shows as a gap between the two
readings of one tree. A process measures, at lm-100m (R = 4 stacked
replicas, DSAR + 4-bit QSGD):

- ``reduce_ms``: ``reduce_buckets_spmd`` alone on one step's gradients,
  telemetry off, the median of 5 CUDA-event timings after a warm-up;
- ``reduce_tel_ms``: the same with the per-bucket telemetry rows on, and
  ``telemetry_ms`` the difference, telemetry's own cost;
- ``reduce_peak_gb``: the most device memory one call held above what was
  in use before it;
- ``step_ms``: ``Trainer.run`` of 6 synchronous steps, the median of
  steps 2-6 (host clock to the loss on the host);
- ``dsar_k64_ms`` and ``dsar_qsgd_k64_ms``: ``make_sparse_allreduce`` at
  the Fig. 3 size (8 stacked ranks, N = 2^24, k = 64 of 512), the device
  alone (CUDA-graph replays).

Prints one JSON line a process and a summary line of medians; the record
goes to chiprun_out/reduce_half_compare.json.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.comm.collectives import StackedCollectives
    from repro_torch.comm.executor import reduce_buckets_spmd
    from repro_torch.core.allreduce import make_sparse_allreduce
    from repro_torch.core.qsgd import QSGDConfig, random_bits
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.model import build_model
    from repro_torch.train import run_lm
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer

    def event_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    def graph_ms(fn, replays=5):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        return event_ms(lambda: [g.replay() for _ in range(replays)]) / replays

    dev = torch.device("cuda")
    cfg, data = run_lm.lm_config(fast=False)
    trainer = Trainer(build_model(cfg), run_lm.train_config(6), data,
                      dp_total=run_lm.DP, device=dev)
    trainer.init()
    log = trainer.run(6)
    rec = {"step_ms": statistics.median(log.step_times[1:]) * 1e3}
    st = trainer.state
    _, leaves = ts.rank_grads(trainer.model, st.params, ts.batch_to_device(
        synthetic_batch(data, 0), dev), run_lm.DP, trainer.tcfg.microbatches)
    rand0 = ts.StepBits(trainer.tcfg.seed, 0, dev, run_lm.DP)

    def reduce(telemetry=False):
        return reduce_buckets_spmd(trainer.plan, leaves, st.residuals,
                                   p_data=run_lm.DP, rand_fn=rand0,
                                   telemetry=telemetry)

    rec["reduce_ms"] = event_ms(reduce)
    rec["reduce_tel_ms"] = event_ms(lambda: reduce(True))
    rec["telemetry_ms"] = rec["reduce_tel_ms"] - rec["reduce_ms"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = reduce()
    torch.cuda.synchronize()
    rec["reduce_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    del out, leaves, trainer, st
    torch.cuda.empty_cache()
    n, p, k = 1 << 24, 8, 64
    gen = torch.Generator(device=dev).manual_seed(2024)
    x = torch.randn((p, n), device=dev, generator=gen)
    rand = random_bits(p * n, gen, dev).reshape(p, n)
    coll = StackedCollectives(p, dev)
    for label, q in (("dsar_k64_ms", None),
                     ("dsar_qsgd_k64_ms", QSGDConfig(4, 1024))):
        f = make_sparse_allreduce(coll, n, k, 512,
                                  algorithm="dsar_split_allgather", qsgd=q)
        r_in = rand if q else None
        rec[label] = graph_ms(lambda: f(x, r_in))
    return rec


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve())), flush=True)
        return
    trees = dict(arg.split("=", 1) for arg in sys.argv[1:])
    if not trees:
        sys.exit("give at least one LABEL=TREE")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    order = list(trees) + list(reversed(trees))
    runs = []
    for _ in range(2):
        for label in order:
            out = subprocess.run([sys.executable, __file__, "--child",
                                  trees[label]], capture_output=True,
                                 text=True)
            if out.returncode != 0:
                sys.exit(f"{label}: {out.stderr[-4000:]}")
            rec = {"label": label, **json.loads(out.stdout.splitlines()[-1])}
            runs.append(rec)
            print(json.dumps(rec), flush=True)
    summary = {label: {key: statistics.median(r[key] for r in runs
                                              if r["label"] == label)
                       for key in runs[0] if key != "label"}
               for label in trees}
    print(json.dumps({"card": card, "medians": summary}), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "reduce_half_compare.json").write_text(json.dumps(
        {"card": card, "runs": runs, "medians": summary}, indent=1))


if __name__ == "__main__":
    main()
