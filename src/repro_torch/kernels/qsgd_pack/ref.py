"""Plain PyTorch version of QSGD bucketed stochastic quantization + packing.

QSGD (paper §6): split into buckets of Bq entries, one full-precision
scale per bucket, each entry stochastically rounded to s = 2^(bits-1) - 1
signed levels and bit-packed (32//bits codes per u32).

Shared semantics (with the CUDA kernel and
``src/repro/kernels/qsgd_pack/ref.py``):
  x:    (nb, Bq) float
  rand: (nb, Bq) uint32 — stochastic-rounding noise (an explicit operand
        so every implementation can be fed the same bits)
  -> packed (nb, Bq*bits//32) uint32, scale (nb, 1) float32

Code for entry v with scale σ:  level = floor(|v|/σ * s + u), u∈[0,1);
stored biased: code = sign(v)*level + s ∈ [0, 2s]. σ is the bucket L2
norm (QSGD) or max-norm (scale_mode='max').

PyTorch has no shifts or sums on ``torch.uint32``, so the bit work runs in
int64 and the words are cast at the edges (:func:`u32_to_i64`,
:func:`i64_to_u32`).
"""
from __future__ import annotations

import torch

U32_TO_UNIT = float(2.0**-32)


def levels(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def u32_to_i64(t: torch.Tensor) -> torch.Tensor:
    """uint32 words -> their values as int64."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def i64_to_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32 words."""
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32).view(
        torch.uint32)


def bucket_scale(x: torch.Tensor, scale_mode: str) -> torch.Tensor:
    xf = x.to(torch.float32)
    if scale_mode == "l2":
        return torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
    if scale_mode == "max":
        return torch.amax(xf.abs(), dim=1, keepdim=True)
    raise ValueError(scale_mode)


def qsgd_pack_ref(x: torch.Tensor, rand: torch.Tensor, bits: int,
                  scale_mode: str = "l2"):
    nb, bq = x.shape
    vpw = 32 // bits
    s = levels(bits)
    xf = x.to(torch.float32)
    scale = bucket_scale(xf, scale_mode)  # (nb, 1)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    u = u32_to_i64(rand).to(torch.float32) * U32_TO_UNIT
    level = torch.floor(xf.abs() / safe * s + u)
    level = level.clamp(0, s).to(torch.int64)
    code = torch.where(xf < 0, -level, level) + s  # biased, in [0, 2s]
    code = torch.where(scale > 0, code, torch.full_like(code, s))
    shifts = torch.arange(vpw, dtype=torch.int64, device=x.device) * bits
    packed = (code.reshape(nb, bq // vpw, vpw) << shifts).sum(dim=2)
    return i64_to_u32(packed), scale
