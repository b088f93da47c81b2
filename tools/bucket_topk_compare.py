#!/usr/bin/env python3
"""Time builds of the bucket_topk kernel against each other on one card.

    python3 tools/bucket_topk_compare.py LABEL=SOURCE[:FLAG,...] ...

Each argument builds SOURCE (a ``bucket_topk.cu`` with the entry point
``bucket_topk_f32``; FLAGs are extra nvcc flags such as ``-DNAME=1``)
with the port's nvcc flags into a library of its own under
``build/topk_compare/``. An older version of the
source comes from git, e.g.
``git show <commit>:src/repro_torch/csrc/bucket_topk.cu > build/old.cu``.

At every shape -- lm-100m's 26 sparse bucket shapes at its k (R = 4
replicas, ties and all-zero rows injected as chip_smoke.py phase 2 does),
then the k sweep of chip_smoke.py -- each build's three outputs are held
bit for bit to the plain version, then the builds are timed in turns
(A B .. B A, so a drift of the card shows as a gap between the two
readings of one build): CUDA events (median of 5 after a warm-up) and
the device alone (a CUDA-graph replay). One JSON line a shape; the whole
record goes to chiprun_out/bucket_topk_compare.json.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (its timers and the k sweep's shapes)


def build(label: str, spec: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    source, _, flags = spec.partition(":")
    out = ROOT / "build" / "topk_compare" / label / "libtopk.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *filter(None, flags.split(",")),
           "-Xptxas", "-v", "-shared", str(ROOT / source), "-o", str(out)]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"{label}: nvcc failed\n{run.stdout}{run.stderr}")
    for line in (run.stdout + run.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build {label}] {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(out))
    lib.bucket_topk_f32.argtypes = _build.ENTRY_POINTS["bucket_topk_f32"]
    lib.bucket_topk_f32.restype = ctypes.c_int
    return lib


def launch(torch, lib, x, k):
    from repro_torch.kernels import _build

    nb, b = x.shape
    val = torch.empty((nb, k), dtype=x.dtype, device=x.device)
    lidx = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    res = torch.empty_like(x)
    _build.check(lib.bucket_topk_f32(
        x.data_ptr(), val.data_ptr(), lidx.data_ptr(), res.data_ptr(), nb, b,
        k, _build.stream(x)), "bucket_topk")
    return val, lidx, res


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("needs an NVIDIA GPU")
    if len(sys.argv) < 2:
        chip_smoke.fail("give at least one LABEL=SOURCE[:FLAG,...]")
    from repro_torch.kernels.bucket_topk import ops as topk_ops
    from repro_torch.train import run_lm

    libs = {}
    for arg in sys.argv[1:]:
        label, _, spec = arg.partition("=")
        libs[label] = build(label, spec)
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    order = list(libs) + list(libs)[::-1]
    rows = []
    sparse, sync = chip_smoke.lm_sparse_buckets()
    shapes = [("lm-100m", sync.k_per_bucket)] + [
        ((n, b), k) for n, b, k in chip_smoke.TOPK_SWEEP]
    for name, k in shapes:
        if name == "lm-100m":
            xs, _ = chip_smoke.topk_inputs(torch, dev, sparse, run_lm.DP,
                                           sync.bucket_size)
        else:
            xs = [torch.randn(name, device=dev, generator=torch.Generator(
                device=dev).manual_seed(sum(name)))]
        for label, lib in libs.items():
            for x in xs:
                got = launch(torch, lib, x, k)
                want = topk_ops.bucket_topk(x, k, impl="ref")
                if not all(torch.equal(g.view(torch.int32),
                                       w.view(torch.int32))
                           for g, w in zip(got, want)):
                    chip_smoke.fail(f"{label} at {name} k={k} differs from "
                                    "the plain version")
        row = {"shape": name, "k": k, "ms": {}, "device_ms": {}}
        for label in order:
            fn = lambda lib=libs[label]: [launch(torch, lib, x, k) for x in xs]
            row["ms"].setdefault(label, []).append(chip_smoke.time_ms(torch, fn))
            row["device_ms"].setdefault(label, []).append(
                chip_smoke.graph_ms(torch, fn))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del xs
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bucket_topk_compare.json").write_text(json.dumps(
        {"card": card, "builds": sys.argv[1:], "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
