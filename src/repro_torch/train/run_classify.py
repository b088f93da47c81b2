"""Large-scale sparse classification (paper §8.2 / Table 2, the MPI-OPT
scenario) on one GPU: logistic regression over a URL-like trigram-sparse
dataset on 8 data-parallel ranks, exploiting NATURAL gradient sparsity.

    PYTHONPATH=src python -m repro_torch.train.run_classify
    PYTHONPATH=src python -m repro_torch.train.run_classify --device cpu
    PYTHONPATH=src python -m repro_torch.train.run_classify --algorithm auto

The PyTorch counterpart of ``examples/classify_sparse.py``: 2048 samples
x 2^20 features, 64 nonzeros a sample, 8 ranks of 16 samples a step, 16
steps at learning rate 0.5, each rank's gradient TopK-compressed (8 of
every 512; a rank's gradient has at most 1024 nonzeros, so almost nothing
is dropped) and summed with ``make_sparse_allreduce`` over a
``StackedCollectives`` of the 8 ranks: ``dense`` against
``ssar_split_allgather``. It prints each one's train accuracy and time.
``--algorithm`` runs one algorithm instead; ``auto`` is the one the cost
model selects on network parameters fitted on the 8 stacked ranks (the
device's sum; printed with the choice). Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.comm.collectives import StackedCollectives
from repro_torch.comm.plan import SPARSE_ALGORITHMS
from repro_torch.core.allreduce import make_sparse_allreduce
from repro_torch.data.sparse_datasets import make_url_like_dataset
from repro_torch.device import resolve_device
from repro_torch.utils.calibrate import calibrate

N_FEATURES = 1 << 20
SAMPLES = 2048
NNZ = 64
RANKS = 8
STEPS = 16
LR = 0.5
BATCH = 16          # per rank
K_PER_BUCKET = 8
BUCKET = 512
ALGORITHMS = ("dense", "ssar_split_allgather")


def load(device, n_samples: int = SAMPLES, n_features: int = N_FEATURES,
         nnz: int = NNZ, seed: int = 0):
    """The seeded dataset as (idx int64, val f32, y f32) on ``device``."""
    idx, val, y = make_url_like_dataset(n_samples=n_samples,
                                        n_features=n_features,
                                        nnz_per_sample=nnz, seed=seed)
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            torch.from_numpy(val).to(device), torch.from_numpy(y).to(device))


def rank_grads(w, data, step: int, ranks: int = RANKS,
               batch: int = BATCH) -> torch.Tensor:
    """(ranks, n) logistic-loss gradients: rank r takes the ``batch``
    samples from (step*ranks + r)*batch, as the example does."""
    idx, val, y = data
    n_samples, n = idx.shape[0], w.shape[0]
    lo = (step * ranks + torch.arange(ranks, device=w.device)) * batch \
        % n_samples
    rows = lo[:, None] + torch.arange(batch, device=w.device)   # (R, bs)
    ii, vv, yy = idx[rows], val[rows], y[rows]
    m = (vv * w[ii]).sum(-1)
    coef = -yy / (1 + torch.exp(yy * m)) / batch
    g = torch.zeros(ranks * n, dtype=torch.float32, device=w.device)
    flat = ii + (torch.arange(ranks, device=w.device) * n)[:, None, None]
    g.index_add_(0, flat.reshape(-1), (coef[..., None] * vv).reshape(-1))
    return g.reshape(ranks, n)


def accuracy(w, data) -> float:
    idx, val, y = data
    m = (val * w[idx]).sum(1)
    return float((torch.sign(m) == y).to(torch.float32).mean())


def train(algorithm: str, data, n: int, device, steps: int = STEPS,
          ranks: int = RANKS, batch: int = BATCH, lr: float = LR,
          k_per_bucket: int = K_PER_BUCKET, bucket_size: int = BUCKET,
          net=None):
    """Weights (n,) after ``steps`` steps of the loop, and the seconds the
    steps took (to the last one's end on the device). ``net``: the
    ``NetworkParams`` "auto" selects on."""
    f = make_sparse_allreduce(StackedCollectives(ranks, device), n,
                              k_per_bucket=k_per_bucket,
                              bucket_size=bucket_size, algorithm=algorithm,
                              net=net)
    w = torch.zeros(n, dtype=torch.float32, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for step in range(steps):
        summed = f(rank_grads(w, data, step, ranks, batch))[0]
        w = w - lr * summed / ranks
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return w, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--algorithm", default=None,
                    choices=("auto", "dense") + SPARSE_ALGORITHMS,
                    help="one algorithm instead of the example's "
                         f"{ALGORITHMS}")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    data = load(dev)
    print(f"dataset: {SAMPLES} samples x {N_FEATURES} trigram features "
          f"(density {NNZ / N_FEATURES:.5%}) on {dev}: gradients are "
          "naturally sparse")
    net = None
    if args.algorithm == "auto":
        coll = StackedCollectives(RANKS, dev)
        net = calibrate(coll)
        picked = make_sparse_allreduce(coll, N_FEATURES, K_PER_BUCKET, BUCKET,
                                       net=net).algorithm
        print(f"auto: alpha {net.alpha:.4g} s, {net.link_bytes_per_s:.4g} "
              f"B/s (fitted on {RANKS} stacked ranks) selects {picked}")
    out = {}
    for algo in (args.algorithm,) if args.algorithm else ALGORITHMS:
        w, dt = train(algo, data, N_FEATURES, dev, net=net)
        out[algo] = (w, dt, accuracy(w, data))
        print(f"  {algo:22s}: {STEPS} steps in {dt:.2f}s, "
              f"train accuracy {out[algo][2]:.3f}")
    return out


if __name__ == "__main__":
    main()
