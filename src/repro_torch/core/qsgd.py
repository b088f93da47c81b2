"""QSGD bucketed stochastic quantization (paper §6), flat-vector API.

Applied to the dense second phase of DSAR_Split_allgather: quantize the
reduced N/P shard before the allgather, cutting its bandwidth term by
32/bits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.qsgd_pack.ops import qsgd_pack
from repro_torch.kernels.qsgd_unpack.ops import qsgd_unpack


class QSGDConfig(NamedTuple):
    bits: int = 4
    bucket_size: int = 1024  # "in the order of 1024 consecutive entries" (§6)
    scale_mode: str = "l2"   # QSGD uses the bucket L2 norm


def quantize(x: torch.Tensor, cfg: QSGDConfig, rand: torch.Tensor,
             impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """x: flat (n,), zero-padded to a multiple of cfg.bucket_size.

    rand: flat uint32 (n,). Returns (packed (nb, W) u32, scales (nb, 1) f32).
    """
    (n,) = x.shape
    bq = cfg.bucket_size
    nb = -(-n // bq)
    pad = nb * bq - n
    if pad:
        x = F.pad(x, (0, pad))
        rand = F.pad(rand, (0, pad))
    return qsgd_pack(x.reshape(nb, bq), rand.reshape(nb, bq), cfg.bits,
                     cfg.scale_mode, impl=impl)


def dequantize(packed: torch.Tensor, scale: torch.Tensor, cfg: QSGDConfig,
               n: int, out_dtype=torch.float32,
               impl: str = "auto") -> torch.Tensor:
    xhat = qsgd_unpack(packed, scale, cfg.bits, out_dtype, impl=impl)
    return xhat.reshape(-1)[:n]


def random_bits(n: int, generator: Optional[torch.Generator] = None,
                device="cpu") -> torch.Tensor:
    """Uniform u32 noise for stochastic rounding (an explicit operand).

    Drawn as full-range int32 from ``generator`` (Philox on a CUDA device)
    and reinterpreted as uint32."""
    bits = torch.empty(n, dtype=torch.int32, device=device)
    bits.random_(-2**31, 2**31, generator=generator)
    return bits.view(torch.uint32)
