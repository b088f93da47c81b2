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

The grouped form (:func:`qsgd_pack_grouped_ref`) packs every DSAR + QSGD
bucket of a step, each a :class:`PackSegment`: its QSGD rows read where
they lie in the summed (p_pod, rows, p_data*shard) buffer, in the
reference's ``transpose(0, 2, 1, 3)`` order (``reduce_buckets_spmd``);
with p_pod = p_data = 1 that is the rows in order. The codes come out in the layout ``qsgd_unpack``'s
``UnpackSegment`` reads.
"""
from __future__ import annotations

from typing import NamedTuple

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


class PackSegment(NamedTuple):
    """One bucket's summed buffer and rounding bits.

    QSGD row q = ((pod*p_data + rank)*rows + row)*(shard//bq) + jq is the
    bq entries at ``x.view(p_pod, rows, p_data, shard)[pod, row, rank,
    jq*bq:]`` (with p_pod = p_data = 1, the bq entries at q*bq of the flat
    ``x``). Its bits are ``rand`` (flat, QSGD-row order: the layout of
    ``rand_fn(bucket_idx, n)``) at q*bq, and its codes row q of the
    packed output."""
    x: torch.Tensor        # p_pod*rows*p_data*shard f32 entries
    rand: torch.Tensor     # as many u32
    p_pod: int
    p_data: int
    rows: int
    shard: int
    bq: int


def check_pack_geometry(p_pod: int, p_data: int, rows: int, shard: int,
                        bq: int, bits: int) -> int:
    """Raise unless a segment's geometry is one the pack takes; return its
    number of QSGD rows."""
    if bits not in (2, 4, 8):
        raise ValueError(f"qsgd_pack: bits={bits}")
    if min(p_pod, p_data, bq) < 1 or min(rows, shard) < 0:
        raise ValueError(f"qsgd_pack: bad geometry "
                         f"{(p_pod, p_data, rows, shard, bq)}")
    if bq % (32 // bits):
        raise ValueError(f"qsgd_pack: Bq={bq} is not a whole number of "
                         "words")
    if shard % bq:
        raise ValueError(f"qsgd_pack: shard={shard} is not a multiple of "
                         f"bq={bq}, so a QSGD row would cross a rank's "
                         "shard")
    return p_pod * rows * p_data * shard // bq


def check_pack_segment(seg: PackSegment, bits: int) -> int:
    """Raise unless the segment's geometry and sizes agree; return its
    number of QSGD rows."""
    nq = check_pack_geometry(*seg[2:7], bits)
    n = nq * seg.bq
    if seg.x.numel() != n or seg.rand.numel() != n:
        raise ValueError(f"qsgd_pack: x has {seg.x.numel()} and rand "
                         f"{seg.rand.numel()} entries, the geometry needs {n}")
    return nq


def pack_rows(seg: PackSegment) -> torch.Tensor:
    """The segment's (nq, bq) QSGD rows in q order (a copy unless they
    lie in order)."""
    return (seg.x.reshape(seg.p_pod, seg.rows, seg.p_data, seg.shard)
            .permute(0, 2, 1, 3).reshape(-1, seg.bq))


def qsgd_pack_grouped_ref(segments, bits: int, scale_mode: str = "l2"):
    """(packed (nq, bq*bits//32) u32, scale (nq, 1) f32) per segment."""
    outs = []
    for seg in segments:
        check_pack_segment(seg, bits)
        outs.append(qsgd_pack_ref(pack_rows(seg), seg.rand.reshape(-1, seg.bq),
                                  bits, scale_mode))
    return outs
