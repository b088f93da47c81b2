"""Train the LM with SparCML gradient sync (DSAR + 4-bit QSGD) on one GPU.

    PYTHONPATH=src python -m repro_torch.train.run_lm --steps 20
    PYTHONPATH=src python -m repro_torch.train.run_lm --fast

The PyTorch counterpart of ``examples/train_lm_topk.py``: lm-100m (12
layers, d=768, GQA 12/4 heads, SwiGLU 2048, vocab 32768, f32) at global
batch 32 x 512 in 2 microbatches, 4 data-parallel replicas stacked on one
device, k = 8 of every 512, DSAR split-allgather, 4-bit QSGD. ``--fast``
is the example's lm-12m. ZeRO-1, checkpoints and the pipelined runtime
are not ported yet: the optimizer state stays replicated.
"""
from __future__ import annotations

import argparse
import statistics

import torch

from repro_torch.core.compressor import SyncConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.train.state import TrainConfig
from repro_torch.train.trainer import Trainer

DP = 4


def lm_config(fast: bool) -> tuple[ModelConfig, DataConfig]:
    if fast:
        cfg = ModelConfig(name="lm-12m", family="dense", num_layers=4,
                          d_model=256, num_heads=8, num_kv_heads=4, d_ff=512,
                          vocab_size=2048, dtype=torch.float32,
                          param_dtype=torch.float32, max_seq_len=256)
        return cfg, DataConfig(global_batch=16, seq_len=128, vocab_size=2048)
    cfg = ModelConfig(name="lm-100m", family="dense", num_layers=12,
                      d_model=768, num_heads=12, num_kv_heads=4, d_ff=2048,
                      vocab_size=32768, dtype=torch.float32,
                      param_dtype=torch.float32, max_seq_len=1024)
    return cfg, DataConfig(global_batch=32, seq_len=512, vocab_size=32768)


def train_config(steps: int, mode: str = "sparcml") -> TrainConfig:
    return TrainConfig(
        sync=SyncConfig(mode=mode, k_per_bucket=8, bucket_size=512,
                        algorithm="dsar_split_allgather", qsgd_bits=4,
                        min_sparse_size=65536),
        optimizer=OptimizerConfig(kind="adamw"),
        schedule=ScheduleConfig(kind="wsd", peak_lr=6e-4, warmup_steps=20,
                                total_steps=steps),
        microbatches=2,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fast", action="store_true")
    args = ap.parse_args(argv)

    cfg, data = lm_config(args.fast)
    steps = min(args.steps, 60) if args.fast else args.steps
    model = build_model(cfg)
    print(f"model: {cfg.name}, {cfg.param_count() / 1e6:.1f}M params")
    trainer = Trainer(model, train_config(steps), data, dp_total=DP)
    if trainer.plan is not None:
        print(trainer.plan.describe())
    log = trainer.run(steps)
    print(f"done: step {steps}, loss {log.losses[0]:.3f} -> "
          f"{log.losses[-1]:.3f}, median step "
          f"{statistics.median(log.step_times) * 1e3:.1f} ms")
    return log


if __name__ == "__main__":
    main()
