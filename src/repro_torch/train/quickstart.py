"""Quickstart: train a small LM with SparCML gradient compression (the
JAX package's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.train.quickstart
    PYTHONPATH=src python -m repro_torch.train.quickstart --device cpu --steps 2

Trains quickstart-12m (4 layers, d = 256, GQA 8/4 heads, vocab 2048, f32)
on 16 x 128 synthetic tokens a step with 4 data-parallel replicas
stacked on one device, first with a dense allreduce, then with the
paper's Quantized TopK SGD (Alg. 2: bucketed top-k with error feedback,
8 of every 512, DSAR split/allgather, a 4-bit QSGD second phase), and
prints each run's losses, its final loss and the analytic bytes on the
wire a rank a step (``wire_bytes_per_step``). The reference's 2-way
model (tensor-parallel) axis has no counterpart in the port: each
replica holds the whole model. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.compressor import SyncConfig, wire_bytes_per_step
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model, init_params
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.train.state import TrainConfig
from repro_torch.train.trainer import Trainer

DP = 4
CFG = ModelConfig(name="quickstart-12m", family="dense", num_layers=4,
                  d_model=256, num_heads=8, num_kv_heads=4, d_ff=512,
                  vocab_size=2048, dtype=torch.float32,
                  param_dtype=torch.float32, max_seq_len=256)
DATA = DataConfig(global_batch=16, seq_len=128, vocab_size=2048)
SYNCS = [
    ("dense allreduce      ", SyncConfig(mode="dense")),
    ("sparcml topk 1.6%+EF ", SyncConfig(
        mode="sparcml", k_per_bucket=8, bucket_size=512,
        algorithm="dsar_split_allgather", qsgd_bits=4,
        min_sparse_size=16384)),
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    model = build_model(CFG)
    shapes = init_params(CFG, device="meta")
    for label, sync in SYNCS:
        tcfg = TrainConfig(sync=sync, optimizer=OptimizerConfig(),
                           schedule=ScheduleConfig(peak_lr=1e-3,
                                                   warmup_steps=10,
                                                   total_steps=500))
        trainer = Trainer(model, tcfg, DATA, dp_total=DP,
                          device=args.device)
        log = trainer.run(args.steps)
        for i in range(0, args.steps, 10):
            print(f"  [{label}] step {i:3d} loss {log.losses[i]:.4f}")
        rep = wire_bytes_per_step(shapes, sync, p=DP)
        print(f"  [{label}] final loss {log.losses[-1]:.4f} | "
              f"wire bytes/step: {rep['sparcml_bytes'] / 1e6:.2f} MB "
              f"({rep['sparcml_bytes']:.1f} B, {rep['ratio']:.1f}x less "
              f"than dense)\n")


if __name__ == "__main__":
    main()
