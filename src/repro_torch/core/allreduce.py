"""Allreduce building blocks. This slice ports the one the stacked-replica
executor needs: the QSGD round trip of DSAR's dense phase."""
from __future__ import annotations

import torch

from repro_torch.core.qsgd import QSGDConfig
from repro_torch.kernels.qsgd_pack.ops import qsgd_pack
from repro_torch.kernels.qsgd_unpack.ops import qsgd_unpack


def _qsgd_roundtrip(x2d: torch.Tensor, rand2d: torch.Tensor, qsgd: QSGDConfig,
                    impl: str, out_dtype=torch.float32) -> torch.Tensor:
    """quantize -> dequantize (the wire fidelity without the wire)."""
    packed, scale = qsgd_pack(x2d, rand2d, qsgd.bits, qsgd.scale_mode,
                              impl=impl)
    return qsgd_unpack(packed, scale, qsgd.bits, out_dtype, impl=impl)
