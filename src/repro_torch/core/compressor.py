"""Gradient synchronization configuration (the user-facing knob set)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.core.qsgd import QSGDConfig


@dataclass(frozen=True)
class SyncConfig:
    """How gradients are synchronized across data-parallel replicas."""

    mode: str = "dense"              # 'dense' | 'sparcml'
    k_per_bucket: int = 4            # paper §8.3: 4/512 for ASR, 8..16/512 CIFAR
    bucket_size: int = 512
    algorithm: str = "auto"          # ssar_recursive_double|ssar_split_allgather|
                                     # dsar_split_allgather|dense|auto
    qsgd_bits: Optional[int] = None  # quantize DSAR dense phase (2/4/8)
    qsgd_bucket: int = 1024
    qsgd_scale: str = "l2"
    min_sparse_size: int = 65536     # buckets/leaves below this use dense psum
    mean: bool = True
    # Kernel choice. The JAX package defaults to "ref" because its Pallas
    # kernels could not be lowered inside auto-SPMD regions; the port has
    # no such regions, so "auto" runs the CUDA kernels on CUDA tensors and
    # their plain versions on CPU tensors.
    impl: str = "auto"
    ef_dtype: Any = torch.float32
    fusion_bucket_bytes: int = 4 << 20  # fused-plan bucket size

    def qsgd(self) -> QSGDConfig | None:
        if self.qsgd_bits is None:
            return None
        return QSGDConfig(self.qsgd_bits, self.qsgd_bucket, self.qsgd_scale)
