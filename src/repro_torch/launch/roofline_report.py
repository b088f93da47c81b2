"""The dry run's JSONs as one markdown table (the JAX package's
``repro.launch.roofline_report``).

    PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
        [--dir build/dryrun] [--layout stacked2] [--full]
"""
from __future__ import annotations

import argparse
import json
import os


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def load(dirname: str, layout: str | None = None) -> list[dict]:
    recs = []
    for f in sorted(os.listdir(dirname)):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(dirname, f)) as fh:
            rec = json.load(fh)
        if layout and rec.get("layout") != layout:
            continue
        recs.append(rec)
    return recs


ARCH_ORDER = ["llama-3.2-vision-11b", "mamba2-370m", "minicpm-2b", "qwen3-4b",
              "llama3-405b", "internlm2-20b", "dbrx-132b",
              "moonshot-v1-16b-a3b", "zamba2-2.7b", "hubert-xlarge"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def one_liner(rec: dict) -> str:
    """One sentence: what would move the dominant term down."""
    dom = rec["roofline"]["dominant"]
    shape = rec["shape"]
    if not rec.get("fits", True):
        return ("does not fit one card: fewer rows a microbatch, fewer "
                "stacked ranks, or ranks on cards of their own")
    if dom == "memory":
        if shape == "train_4k":
            return ("fuse the eager elementwise chains (softmax, norms, "
                    "casts): every op's operands and results are charged")
        if shape == "prefill_32k":
            return "fuse the chunked attention's per-chunk elementwise ops"
        return "batch more decode slots per weight read (weights dominate)"
    if dom == "collective":
        if rec.get("sync_mode") == "dense":
            return "SparCML TopK+QSGD compression of the gradient exchange"
        return "raise k/bucket locality; overlap the exchange with backward"
    return "compute-bound: more rows a microbatch amortize weight reads"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--layout", default=None,
                    help="only this layout (e.g. stacked2)")
    ap.add_argument("--full", action="store_true",
                    help="include the what-would-help sentence")
    args = ap.parse_args(argv)
    recs = {(r["arch"], r["shape"]): r for r in load(args.dir, args.layout)}

    print("| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | bound (s) "
          "| dominant | MODEL/counted flops | MFU bound | state/dev "
          "| peak est. | fits |")
    print("|" + "---|" * 12)
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            rec = recs.get((arch, shape))
            if rec is None:
                continue
            if rec["status"] == "skipped":
                print(f"| {arch} | {shape} | — | — | — | — | SKIP | — | — "
                      f"| — | — | {rec['reason']} |")
                continue
            if rec["status"] != "ok":
                print(f"| {arch} | {shape} | ERROR | | | | | | | | | |")
                continue
            r = rec["roofline"]
            print(
                f"| {arch} | {shape} "
                f"| {r['t_compute_s']:.3g} | {r['t_memory_s']:.3g} "
                f"| {r['t_collective_s']:.3g} | {r['bound_s']:.3g} "
                f"| **{r['dominant']}** | {r['useful_flops_ratio']:.2f} "
                f"| {r['mfu_bound']:.1%} "
                f"| {fmt_bytes(rec['state_memory']['total'])} "
                f"| {fmt_bytes(rec['peak_estimate'])} "
                f"| {'yes' if rec['fits'] else 'no'} |")
            if args.full:
                print(f"|  |  | | | | | | | | | | ^ {one_liner(rec)} |")


if __name__ == "__main__":
    main()
