"""The readings that a cell's limits are set from (not run by the
benchmark's own runs).

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 ... \\
        --control-seeds 1 2 3 [--out chiprun_out/calibrate.jsonl]

For each of ``--seeds``: the program's first steps against the
reference's (``check.numbers``), the lower readings. For
each of ``--control-seeds``, on one card and without the program, each
against the reference in float32 on the same inputs: the reference with every linear layer in fp8 (the control), and
the reference with two faults planted, half of each rank's microbatches
left out (the mean over the rest) and the exchange between the ranks
left out. A state left unchanged reads 1 on ``update_gap`` and
``grad_gap`` by their definition and needs no run. One JSON line a
reading, on standard output and appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench import spec


def program_reading(cell, seed: int, device):
    """The program's first steps on ``seed`` against the reference's."""
    from portbench import check
    from portbench.run import Run

    t = time.perf_counter()
    run = Run(cell, seed, device)
    run.free()
    ref = run.reference()
    return {"cell": cell.name, "seed": seed, "kind": "program",
            "numbers": check.numbers(run.first, ref),
            "details": check.details(run.first, ref),
            "losses": run.first["losses"], "ref_losses": ref["losses"],
            "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for key, value in cell.traffic.get("env", {}).items():
        os.environ[key] = value
    sys.path.insert(0, str(spec.ROOT / "src"))
    import torch

    from portbench import check, measure
    from portbench.reference.layers import Prec
    from portbench.run import Run

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    print(measure.card_line(), flush=True)

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in args.seeds:
        emit(program_reading(cell, seed, "cuda"))
    for seed in args.control_seeds:
        run = Run(cell, seed, "cuda", steps=False)
        base = run.reference()
        for kind, kw in (("control_fp8", {"prec": Prec(fp8=True)}),
                         ("fault_half_batch", {"fault": "half_batch"}),
                         ("fault_no_exchange", {"fault": "no_exchange"})):
            t = time.perf_counter()
            other = run.reference(**kw)
            emit({"cell": cell.name, "seed": seed, "kind": kind,
                  "numbers": check.numbers(other, base),
                  "details": check.details(other, base),
                  "seconds": time.perf_counter() - t})
            del other
        del run, base
    return 0


if __name__ == "__main__":
    sys.exit(main())
