"""Plain PyTorch version of QSGD unpack+dequantize (inverse of qsgd_pack).

The reference source writes ``code / s * scale``. XLA compiles that as
``code * (scale * fl(1/s))``: it turns the division by the constant s into
a multiply by its f32 reciprocal and reassociates it with the scale. The
port reproduces that compiled arithmetic, which is what the reference
package computes, bit for bit.

The grouped form (:func:`qsgd_unpack_grouped_ref`) is what the
stacked-replica executor does with the dequantized shards of every DSAR +
QSGD bucket: the reference's ``reduce_buckets_spmd`` unpacks the flat
(p_pod*p_data*rows*shard/bq, bq) codes, permutes them back from
(p_pod, p_data, rows, shard) to (p_pod, rows, p_data*shard), sums over the
pods and multiplies by the mean scale. The per-rank executor's segments
are ``row_major``: its allgather hands every rank the codes laid out
(rows, p_data, shard), already the output's order, and it runs the pod
phase (a collective) and the mean after the unpack, so there p_pod = 1
and mean = 1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.qsgd_pack.ref import levels, u32_to_i64


class UnpackSegment(NamedTuple):
    """One bucket's packed shards and where they land.

    Entry e = ((pod*p_data + rank)*rows + row)*shard + j of the flat codes
    (QSGD row e // bq) belongs to ``out[row, rank*shard + j]``; with
    ``row_major``, entry e = ((pod*rows + row)*p_data + rank)*shard + j
    does."""
    packed: torch.Tensor   # (p_pod*p_data*rows*shard//bq, bq*bits//32) u32
    scale: torch.Tensor    # (p_pod*p_data*rows*shard//bq, 1) f32
    p_pod: int
    p_data: int
    rows: int
    shard: int
    bq: int
    mean: float            # the factor applied after the sum over pods
    row_major: bool = False


def check_unpack_geometry(p_pod: int, p_data: int, rows: int, shard: int,
                          bq: int, bits: int) -> int:
    """Raise unless a segment's geometry is one the unpack takes; return
    its number of QSGD rows."""
    if bits not in (2, 4, 8):
        raise ValueError(f"qsgd_unpack: bits={bits}")
    if min(p_pod, p_data, bq) < 1 or min(rows, shard) < 0:
        raise ValueError(f"qsgd_unpack: bad geometry "
                         f"{(p_pod, p_data, rows, shard, bq)}")
    if bq % (32 // bits):
        raise ValueError(f"qsgd_unpack: bq={bq} is not a whole number "
                         "of words")
    if shard % bq:
        raise ValueError(f"qsgd_unpack: shard={shard} is not a multiple "
                         f"of bq={bq}, so a QSGD row would cross an "
                         "output row")
    return p_pod * p_data * rows * (shard // bq)


def check_segment(seg: UnpackSegment, bits: int) -> None:
    """Raise unless the segment's geometry and shapes agree."""
    nq = check_unpack_geometry(*seg[2:7], bits)
    want = (nq, seg.bq * bits // 32)
    if seg.packed.shape != want or seg.scale.shape != (nq, 1):
        raise ValueError(f"qsgd_unpack: packed {tuple(seg.packed.shape)} and "
                         f"scale {tuple(seg.scale.shape)}, the geometry needs "
                         f"{want} and ({nq}, 1)")


def qsgd_unpack_ref(packed: torch.Tensor, scale: torch.Tensor, bits: int,
                    out_dtype=torch.float32):
    nb, w = packed.shape
    vpw = 32 // bits
    s = levels(bits)
    mask = 2**bits - 1
    shifts = torch.arange(vpw, dtype=torch.int64, device=packed.device) * bits
    biased = (u32_to_i64(packed)[:, :, None] >> shifts) & mask  # (nb, w, vpw)
    code = (biased - s).to(torch.float32)
    recip = torch.tensor(1.0, dtype=torch.float32) / s
    step = scale.to(torch.float32) * recip.to(scale.device)      # (nb, 1)
    xhat = code * step[:, :, None]
    return xhat.reshape(nb, w * vpw).to(out_dtype)


def qsgd_unpack_grouped_ref(segments, bits: int) -> list:
    """One (rows, p_data*shard) f32 buffer per segment:
    ``sum over pods of unpack(...)[row, rank*shard + j]``, then ``* mean``."""
    outs = []
    for seg in segments:
        check_segment(seg, bits)
        mb = seg.p_data * seg.shard
        xq = qsgd_unpack_ref(seg.packed, seg.scale, bits)
        if seg.row_major:
            dpod = xq.reshape(seg.p_pod, seg.rows, mb)
        else:
            dpod = (xq.reshape(seg.p_pod, seg.p_data, seg.rows, seg.shard)
                    .permute(0, 2, 1, 3).reshape(seg.p_pod, seg.rows, mb))
        outs.append(dpod.sum(dim=0) * seg.mean)
    return outs
