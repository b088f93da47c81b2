"""Launcher of the hand-written CUDA kernel ``csrc/qsgd_unpack.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/qsgd_unpack/kernel.py``
(``qsgd_unpack_pallas``) and, in its grouped form, the permute, pod sum
and mean scale that the executor ran after it. Bound by bytes: the packed
words are read once and the f32 output written once (see the source for
the design).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qsgd_unpack.ref import UnpackSegment, check_segment


class _Seg(ctypes.Structure):
    """``QsgdUnpackSeg`` of the CUDA source, field for field."""
    _fields_ = [("packed", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("p_pod", ctypes.c_int),
                ("p_data", ctypes.c_int), ("rows", ctypes.c_int),
                ("shard", ctypes.c_int), ("bq", ctypes.c_int),
                ("mean", ctypes.c_float), ("row_major", ctypes.c_int)]


def launch_grouped(segments, out: torch.Tensor, bits: int) -> int:
    """Write the segments' reduced (rows, p_data*shard) buffers one after
    another into ``out``, a contiguous 1-D f32 CUDA tensor of
    sum(rows*p_data*shard) entries, with one library call; returns the
    number of kernels it launched (one for every 48 non-empty segments).

    Every buffer starts on a 16-byte boundary when ``out`` does: each size
    is a multiple of bq, itself a multiple of 4. The checks are plain
    Python, host time the card waits for when nothing else is queued, so
    they touch each tensor once."""
    for seg in segments:
        check_segment(seg, bits)
    _build.require_cuda("qsgd_unpack", out, *[
        t for seg in segments for t in (seg.packed, seg.scale)])
    sizes = [s.rows * s.p_data * s.shard for s in segments]
    if out.dtype != torch.float32 or out.shape != (sum(sizes),):
        raise ValueError(f"qsgd_unpack: out {out.dtype} {tuple(out.shape)}, "
                         f"the segments need float32 ({sum(sizes)},)")
    base = out.data_ptr()
    if base % 16:
        raise ValueError("qsgd_unpack: out must start on a 16-byte boundary "
                         "(the kernel stores float4)")
    descs = (_Seg * len(segments))()
    for i, (seg, size) in enumerate(zip(segments, sizes)):
        if seg.packed.dtype != torch.uint32 or seg.scale.dtype != torch.float32:
            raise ValueError(f"qsgd_unpack: takes uint32 packed and float32 "
                             f"scale, got {seg.packed.dtype}, "
                             f"{seg.scale.dtype}")
        if seg.p_pod * size >= 2**31:
            raise ValueError("qsgd_unpack: a segment of 2^31 entries or more")
        packed = seg.packed.data_ptr()
        if packed % 16:
            raise ValueError("qsgd_unpack: packed must start on a 16-byte "
                             "boundary (the kernel loads uint4)")
        descs[i] = _Seg(packed, seg.scale.data_ptr(), base, *seg[2:7],
                        seg.mean, int(seg.row_major))
        base += 4 * size
    launched = ctypes.c_int(0)
    with torch.cuda.device(out.device):
        rc = _build.lib().qsgd_unpack_grouped_f32(
            ctypes.addressof(descs), len(segments), bits, _build.stream(out),
            ctypes.byref(launched))
    _build.check(rc, "qsgd_unpack")
    return launched.value


def qsgd_unpack_grouped_cuda(segments, bits: int) -> tuple[list, int]:
    """One (rows, p_data*shard) f32 buffer per segment, from one call, and
    the number of kernels launched; the buffers are views of one
    allocation."""
    sizes = [s.rows * s.p_data * s.shard for s in segments]
    flat = torch.empty(sum(sizes), dtype=torch.float32,
                       device=segments[0].packed.device)
    launched = launch_grouped(segments, flat, bits)
    # the views come after the launch: the card works while they are made
    return [part.view(s.rows, s.p_data * s.shard)
            for part, s in zip(flat.split(sizes), segments)], launched


def qsgd_unpack_cuda(packed: torch.Tensor, scale: torch.Tensor,
                     bits: int) -> tuple[torch.Tensor, int]:
    """packed (nb,W) u32, scale (nb,1) f32 CUDA -> xhat (nb, W*32/bits) f32
    and the number of kernels launched (0 when nb = 0): a one-segment call
    of the grouped kernel (p_pod = p_data = 1, rows = nb, shard = bq,
    mean 1)."""
    if packed.dim() != 2:
        raise ValueError(f"qsgd_unpack: packed {tuple(packed.shape)} is not "
                         "(nb, W)")
    nb, w = packed.shape
    bq = w * (32 // bits)
    outs, launched = qsgd_unpack_grouped_cuda(
        [UnpackSegment(packed, scale, 1, 1, nb, bq, bq, 1.0)], bits)
    return outs[0], launched
