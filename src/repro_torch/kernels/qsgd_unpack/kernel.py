"""Launcher of the hand-written CUDA kernel ``csrc/qsgd_unpack.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/qsgd_unpack/kernel.py``
(``qsgd_unpack_pallas``) and, in its grouped form, the permute, pod sum
and mean scale that the executor ran after it. Bound by bytes: the packed
words are read once and the f32 output written once (see the source for
the design).

A grouped call's fixed part is an :class:`UnpackTable` (the geometries
checked, the offsets of every input and output and a ``QsgdUnpackSeg``
descriptor each): the stacked executor builds it once per plan and
patches only the pointers a step (:func:`qsgd_unpack_table_cuda`, the
codes read from the flat outputs of the grouped pack); a segment list
builds one per call.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qsgd_unpack.ref import (UnpackSegment,
                                                 check_segment,
                                                 check_unpack_geometry)


class _Seg(ctypes.Structure):
    """``QsgdUnpackSeg`` of the CUDA source, field for field."""
    _fields_ = [("packed", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("p_pod", ctypes.c_int),
                ("p_data", ctypes.c_int), ("rows", ctypes.c_int),
                ("shard", ctypes.c_int), ("bq", ctypes.c_int),
                ("mean", ctypes.c_float), ("row_major", ctypes.c_int)]


class UnpackTable:
    """The fixed part of a grouped qsgd_unpack call at ``bits`` over
    segments of geometry (p_pod, p_data, rows, shard, bq, mean,
    row_major) (see ``ref.UnpackSegment``): segment i's codes, (nq,
    bq*bits/32) u32, lie at ``packed_off[i]`` of one flat u32 buffer, each
    on a 16-byte boundary (one after the other unless given), its scales
    (nq,) at ``scale_off[i]`` of one flat f32 buffer, and its reduced
    (rows, p_data*shard) buffer at ``out_off[i]`` of one flat f32 output,
    every buffer on a 16-byte boundary (each size is a multiple of bq,
    itself a multiple of 4). Built once; a call fills a copy of its
    descriptor array with the pointers."""

    def __init__(self, geoms, bits: int, packed_off=None, scale_off=None):
        self.geoms = [(int(a), int(b), int(c), int(d), int(e), float(m),
                       bool(rm)) for a, b, c, d, e, m, rm in geoms]
        self.bits = bits
        self.n = len(self.geoms)
        self.nqs = [check_unpack_geometry(*g[:5], bits) for g in self.geoms]
        self.code_shapes = [(nq, g[4] * bits // 32)
                            for g, nq in zip(self.geoms, self.nqs)]
        self.out_shapes = [(g[2], g[1] * g[3]) for g in self.geoms]
        self.out_sizes = [r * c for r, c in self.out_shapes]
        for g, size in zip(self.geoms, self.out_sizes):
            if g[0] * size >= 2**31:
                raise ValueError("qsgd_unpack: a segment of 2^31 entries or "
                                 "more")
        self.packed_off = ([int(o) for o in packed_off]
                           if packed_off is not None else
                           _build.offsets(-(-nq * w // 4) * 4
                                    for nq, w in self.code_shapes))
        if any(o % 4 for o in self.packed_off):
            raise ValueError("qsgd_unpack: packed must start on a 16-byte "
                             "boundary (the kernel loads uint4)")
        self.scale_off = ([int(o) for o in scale_off]
                          if scale_off is not None else _build.offsets(self.nqs))
        self.packed_end = max((o + nq * w for o, (nq, w) in
                               zip(self.packed_off, self.code_shapes)),
                              default=0)
        self.scale_end = max((o + nq for o, nq in
                              zip(self.scale_off, self.nqs)), default=0)
        self.out_off = _build.offsets(self.out_sizes)
        self.out_total = sum(self.out_sizes)
        desc = np.zeros(self.n, dtype=np.dtype(_Seg))
        for f, col in zip(("p_pod", "p_data", "rows", "shard", "bq", "mean",
                           "row_major"), zip(*self.geoms)):
            desc[f] = col
        self.desc = desc
        self.packed_bytes = _build.byte_offsets(self.packed_off)
        self.scale_bytes = _build.byte_offsets(self.scale_off)
        self.out_bytes = _build.byte_offsets(self.out_off)

    def segments(self, packed: torch.Tensor, scale: torch.Tensor) -> list:
        """The ``UnpackSegment`` of each segment: views of the flat codes
        and scales."""
        return [UnpackSegment(packed[po:po + nq * w].view(nq, w),
                              scale[so:so + nq].view(nq, 1), *g)
                for po, so, (nq, w), g in zip(self.packed_off,
                                              self.scale_off,
                                              self.code_shapes, self.geoms)]

    def launch(self, packed_ptrs, scale_ptrs, out: torch.Tensor) -> int:
        """Write every segment's buffer into ``out`` (the caller's
        contiguous f32 CUDA tensor of ``out_total`` entries, on a 16-byte
        boundary) with one library call; returns the kernels launched (one
        for every 48 non-empty segments)."""
        launched = ctypes.c_int(0)
        d = self.desc.copy()
        d["packed"] = packed_ptrs
        d["scale"] = scale_ptrs
        d["out"] = out.data_ptr() + self.out_bytes
        with torch.cuda.device(out.device):
            rc = _build.lib().qsgd_unpack_grouped_f32(
                d.ctypes.data, self.n, self.bits, _build.stream(out),
                ctypes.byref(launched))
        _build.check(rc, "qsgd_unpack")
        return launched.value


def _check_out(out: torch.Tensor, total: int) -> None:
    if out.dtype != torch.float32 or out.shape != (total,):
        raise ValueError(f"qsgd_unpack: out {out.dtype} {tuple(out.shape)}, "
                         f"the segments need float32 ({total},)")
    if out.data_ptr() % 16:
        raise ValueError("qsgd_unpack: out must start on a 16-byte boundary "
                         "(the kernel stores float4)")


def _check_packed_base(ptr: int) -> None:
    if ptr % 16:
        raise ValueError("qsgd_unpack: packed must start on a 16-byte "
                         "boundary (the kernel loads uint4)")


def launch_grouped(segments, out: torch.Tensor, bits: int) -> int:
    """Write the segments' reduced (rows, p_data*shard) buffers one after
    another into ``out``, a contiguous 1-D f32 CUDA tensor of
    sum(rows*p_data*shard) entries, with one library call (an
    :class:`UnpackTable` of the segments' geometries); returns the number
    of kernels it launched (one for every 48 non-empty segments)."""
    for seg in segments:
        check_segment(seg, bits)
    _build.require_cuda("qsgd_unpack", out, *[
        t for seg in segments for t in (seg.packed, seg.scale)])
    for seg in segments:
        if seg.packed.dtype != torch.uint32 or seg.scale.dtype != torch.float32:
            raise ValueError(f"qsgd_unpack: takes uint32 packed and float32 "
                             f"scale, got {seg.packed.dtype}, "
                             f"{seg.scale.dtype}")
    table = UnpackTable([seg[2:9] for seg in segments], bits)
    _check_out(out, table.out_total)
    packed_ptrs = [seg.packed.data_ptr() for seg in segments]
    for p in packed_ptrs:
        _check_packed_base(p)
    return table.launch(packed_ptrs, [seg.scale.data_ptr() for seg in
                                      segments], out)


def qsgd_unpack_table_cuda(table: UnpackTable, packed: torch.Tensor,
                           scale: torch.Tensor) -> tuple:
    """Every segment of ``table`` from the flat codes and scales (as
    ``qsgd_pack``'s table writes them): the flat (out_total,) f32 output
    and the number of kernels launched."""
    _build.require_cuda("qsgd_unpack", packed, scale)
    if (packed.dtype != torch.uint32 or scale.dtype != torch.float32
            or packed.dim() != 1 or scale.dim() != 1
            or packed.numel() < table.packed_end
            or scale.numel() < table.scale_end):
        raise ValueError(f"qsgd_unpack: codes {packed.dtype} "
                         f"{tuple(packed.shape)} and scales {scale.dtype} "
                         f"{tuple(scale.shape)}, the table needs uint32 of "
                         f"{table.packed_end} and float32 of "
                         f"{table.scale_end} entries or more")
    _check_packed_base(packed.data_ptr())
    out = torch.empty(table.out_total, dtype=torch.float32,
                      device=packed.device)
    _check_out(out, table.out_total)
    launched = table.launch(packed.data_ptr() + table.packed_bytes,
                            scale.data_ptr() + table.scale_bytes, out)
    return out, launched


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
