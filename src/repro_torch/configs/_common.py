"""Shared helpers for the arch config modules (the JAX package's
``repro.configs._common``).

One difference: the reference's ``default_sync`` pins ``impl="ref"``, its
non-Pallas formulation, because its Pallas kernels could not lower inside
auto-SPMD regions. In the port ``impl="ref"`` would force the plain
PyTorch versions on every device and take the CUDA kernels off the card's
path, so the port keeps ``SyncConfig``'s own ``impl="auto"``: the kernels
on CUDA tensors, their plain versions on CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.compressor import SyncConfig
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.train.state import TrainConfig


def default_sync(mode: str = "sparcml", k: int = 4, qsgd_bits=4
                 ) -> SyncConfig:
    """The paper-faithful Quantized TopK setting: k/512 per bucket (the ASR
    experiment uses 4/512), DSAR with a 4-bit QSGD second phase."""
    return SyncConfig(
        mode=mode, k_per_bucket=k, bucket_size=512,
        algorithm="dsar_split_allgather" if mode == "sparcml" else "dense",
        qsgd_bits=qsgd_bits if mode == "sparcml" else None,
        min_sparse_size=65536,
    )


def make_train_config(*, sync_mode: str, schedule_kind: str = "cosine",
                      peak_lr: float = 3e-4, opt_dtype=torch.float32,
                      microbatches: int = 1, fsdp: bool = False,
                      k: int = 4, qsgd_bits=4) -> TrainConfig:
    """The reference's training config. ``fsdp`` (ZeRO-3 parameter
    placement, dense sync only) is not ported and raises."""
    if fsdp:
        raise NotImplementedError(
            "fsdp (ZeRO-3 parameter placement) is not ported yet (ROADMAP "
            "Queue 1, item 10 — fsdp)")
    return TrainConfig(
        sync=default_sync(sync_mode, k=k, qsgd_bits=qsgd_bits),
        optimizer=OptimizerConfig(kind="adamw", state_dtype=opt_dtype),
        schedule=ScheduleConfig(kind=schedule_kind, peak_lr=peak_lr,
                                warmup_steps=200, total_steps=20000),
        microbatches=microbatches,
        zero1=(sync_mode == "sparcml"),
    )
