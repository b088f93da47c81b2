#!/usr/bin/env python3
"""The qwen3-4b train_4k step with the chunked attention on and forced
off, as the rows a rank a microbatch grow, on one card.

    python3 tools/long_rows_compare.py [--replicas 2 1] [--rows 1 2 4 8]
                                       [--layers 2] [--steps 2]

Each (replicas R, rows r, path) runs in a process of its own (a run that
runs out of memory leaves nothing behind in the next): qwen3-4b at its
published widths, ``--layers`` of its 36 layers, bf16, ``Trainer.run``
under its train_config (DSAR + 4-bit QSGD, k = 4 of 512, ZeRO-1, 8
microbatches, remat on), R ranks stacked on the card, r rows of 4096
tokens a rank a microbatch (R x 8 x r rows a step), the caching
allocator's expandable segments on (as the smoke's phase 19). The path
"plain" raises ``layers._CHUNKED_MIN`` past any length, as the smoke does.
A process records the last step's time (host clock to the loss on the
host), the peaks allocated and reserved, the bytes ``init_or_resume``
allocated, and the losses; or that it ran out of memory. Rows grow for an
R until both paths run out.

Prints one JSON line a process, the card's name and power limit, and a
table; the record goes to chiprun_out/long_rows_compare.json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-4b"
SEQ = 4096


def child(replicas: int, rows: int, path: str, layers: int,
          steps: int) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import Trainer

    if path == "plain":
        L._CHUNKED_MIN = 1 << 62
    dev = torch.device("cuda")
    cfg = configs.get_config(ARCH, num_layers=layers)
    tcfg = configs.get_train_config(ARCH)
    data = DataConfig(replicas * tcfg.microbatches * rows, SEQ,
                      cfg.vocab_size, 1234)
    rec = {"replicas": replicas, "rows": rows, "path": path,
           "layers": layers, "microbatches": tcfg.microbatches,
           "tokens": data.global_batch * SEQ}
    try:
        before = torch.cuda.memory_allocated()
        trainer = Trainer(build_model(cfg), tcfg, data, dp_total=replicas,
                          device=dev)
        trainer.init_or_resume()
        torch.cuda.synchronize()
        rec["state_gb"] = (torch.cuda.memory_allocated() - before) / 1e9
        tlog = trainer.run(steps)
        rec.update(ran=True, losses=list(tlog.losses),
                   step_ms=tlog.step_times[-1] * 1e3)
    except torch.cuda.OutOfMemoryError as exc:
        rec.update(ran=False, out_of_memory=str(exc).splitlines()[0])
    rec.update(peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               card_gb=torch.cuda.mem_get_info()[1] / 1e9)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, nargs="+", default=[2, 1])
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--child", nargs=3, metavar=("R", "ROWS", "PATH"))
    args = ap.parse_args()
    if args.child:
        r, rows, path = args.child
        print(json.dumps(child(int(r), int(rows), path, args.layers,
                               args.steps)), flush=True)
        return

    import torch
    if not torch.cuda.is_available():
        sys.exit("long_rows_compare: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    runs = []
    for r in args.replicas:
        for rows in sorted(args.rows):
            got = []
            for path in ("chunked", "plain"):
                proc = subprocess.run(
                    [sys.executable, __file__, "--layers", str(args.layers),
                     "--steps", str(args.steps), "--child", str(r),
                     str(rows), path],
                    capture_output=True, text=True, env=env, timeout=900)
                lines = [ln for ln in proc.stdout.splitlines()
                         if ln.startswith("{")]
                rec = (json.loads(lines[-1]) if lines else
                       {"replicas": r, "rows": rows, "path": path,
                        "ran": False, "error": proc.stderr[-2000:]})
                print(json.dumps(rec), flush=True)
                got.append(rec)
            runs.extend(got)
            if not any(g["ran"] for g in got):
                break
    print(f"card: {card}")
    print("| R | rows | path | tokens a step | step ms | peak alloc GB | "
          "peak reserved GB | state GB |")
    print("|---|---|---|---|---|---|---|---|")
    for g in runs:
        step = f"{g['step_ms']:.1f}" if g.get("ran") else "out of memory"
        print(f"| {g['replicas']} | {g['rows']} | {g['path']} | "
              f"{g.get('tokens', '')} | {step} | "
              f"{g.get('peak_allocated_gb', float('nan')):.2f} | "
              f"{g.get('peak_reserved_gb', float('nan')):.2f} | "
              f"{g.get('state_gb', float('nan')):.2f} |")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "long_rows_compare.json").write_text(json.dumps(
        {"card": card, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
