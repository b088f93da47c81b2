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
    """x: (n,) or (*lead, n), zero-padded to a multiple of cfg.bucket_size.

    rand: uint32 of x's shape. Returns (packed (*lead, nb, W) u32,
    scales (*lead, nb, 1) f32).
    """
    *lead, n = x.shape
    bq = cfg.bucket_size
    nb = -(-n // bq)
    pad = nb * bq - n
    if pad:
        x = F.pad(x, (0, pad))
        rand = F.pad(rand.view(torch.int32), (0, pad)).view(torch.uint32)
    packed, scale = qsgd_pack(x.reshape(-1, bq).contiguous(),
                              rand.reshape(-1, bq).contiguous(), cfg.bits,
                              cfg.scale_mode, impl=impl)
    return (packed.reshape(*lead, nb, packed.shape[-1]),
            scale.reshape(*lead, nb, 1))


def dequantize(packed: torch.Tensor, scale: torch.Tensor, cfg: QSGDConfig,
               n: int, out_dtype=torch.float32,
               impl: str = "auto") -> torch.Tensor:
    """packed (*lead, nb, W), scale (*lead, nb, 1) -> (*lead, n)."""
    *lead, nb, w = packed.shape
    xhat = qsgd_unpack(packed.reshape(-1, w), scale.reshape(-1, 1), cfg.bits,
                       out_dtype, impl=impl)
    return xhat.reshape(*lead, -1)[..., :n]


def random_bits(n: int, generator: Optional[torch.Generator] = None,
                device="cpu", out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Uniform u32 noise for stochastic rounding (an explicit operand).

    Drawn as full-range int32 from ``generator`` (Philox on a CUDA device)
    and reinterpreted as uint32; into ``out`` (n contiguous int32) when
    given, with the bits a fresh tensor would get."""
    bits = (torch.empty(n, dtype=torch.int32, device=device) if out is None
            else out)
    bits.random_(-2**31, 2**31, generator=generator)
    return bits.view(torch.uint32)
