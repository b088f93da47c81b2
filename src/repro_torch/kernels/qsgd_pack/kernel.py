"""Launcher of the hand-written CUDA kernel ``csrc/qsgd_pack.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/qsgd_pack/kernel.py``
(``qsgd_pack_pallas``) and, in its grouped form, the permute copy the
executor made before it. Bound by bytes: x and rand are read once, the
packed codes written once (see the source for the design). One kernel
serves every entry point: the single-bucket pack is one segment with
p_pod = p_data = 1, whose rows lie in order.

A grouped call's fixed part is a :class:`PackTable` (the geometries
checked, the offsets of every input and output and a ``QsgdPackSeg``
descriptor each): the stacked executor builds it once per plan and
patches only the pointers a step (:func:`qsgd_pack_table_cuda`, the sums
read from one flat buffer); a segment list builds one per call.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qsgd_pack.ref import (PackSegment,
                                               check_pack_geometry,
                                               check_pack_segment)


class _Seg(ctypes.Structure):
    """``QsgdPackSeg`` of the CUDA source, field for field."""
    _fields_ = [("x", ctypes.c_void_p), ("rand", ctypes.c_void_p),
                ("packed", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("p_pod", ctypes.c_int), ("p_data", ctypes.c_int),
                ("rows", ctypes.c_int), ("shard", ctypes.c_int),
                ("bq", ctypes.c_int)]


class PackTable:
    """The fixed part of a grouped qsgd_pack call at ``bits`` over
    segments of geometry (p_pod, p_data, rows, shard, bq) (see
    ``ref.PackSegment``): segment i reads ``x_sizes[i]`` sums, at
    ``x_off[i]`` of one flat f32 buffer (one after the other unless
    given), and as many rounding bits; its codes, (nq, bq*bits/32) u32,
    lie at ``packed_off[i]`` of one flat u32 output, each on a 16-byte
    boundary (as the grouped unpack needs), and its scales (nq,) at
    ``scale_off[i]`` of one flat f32 output. Built once; a call fills
    a copy of its descriptor array with the pointers."""

    def __init__(self, geoms, bits: int, x_off=None):
        self.geoms = [tuple(int(v) for v in g) for g in geoms]
        self.bits = bits
        self.n = len(self.geoms)
        self.nqs = [check_pack_geometry(*g, bits) for g in self.geoms]
        for (*_, bq), nq in zip(self.geoms, self.nqs):
            if bq % 4:
                raise ValueError(f"qsgd_pack: Bq={bq} must divide into "
                                 "float4 loads")
            if nq >= 2**31:
                raise ValueError("qsgd_pack: 2^31 QSGD rows or more")
        self.x_sizes = [nq * g[4] for g, nq in zip(self.geoms, self.nqs)]
        self.x_off = (_build.offsets(self.x_sizes) if x_off is None
                      else [int(o) for o in x_off])
        if any(o % 4 for o in self.x_off):
            raise ValueError("qsgd_pack: every x must start on a 16-byte "
                             "boundary (the kernel loads float4)")
        self.x_end = max((o + n for o, n in zip(self.x_off, self.x_sizes)),
                         default=0)
        self.code_shapes = [(nq, g[4] * bits // 32)
                            for g, nq in zip(self.geoms, self.nqs)]
        words = [nq * w for nq, w in self.code_shapes]
        self.packed_off = _build.offsets(-(-w // 4) * 4 for w in words)
        self.packed_total = (self.packed_off[-1] + -(-words[-1] // 4) * 4
                             if words else 0)
        self.scale_off = _build.offsets(self.nqs)
        self.scale_total = sum(self.nqs)
        desc = np.zeros(self.n, dtype=np.dtype(_Seg))
        for f, col in zip(("p_pod", "p_data", "rows", "shard", "bq"),
                          zip(*self.geoms)):
            desc[f] = col
        self.desc = desc
        self.x_bytes = _build.byte_offsets(self.x_off)
        self.packed_bytes = _build.byte_offsets(self.packed_off)
        self.scale_bytes = _build.byte_offsets(self.scale_off)

    def segments(self, x: torch.Tensor, rands) -> list:
        """The ``PackSegment`` of each segment: its sums a view of the
        flat ``x``, its bits ``rands[i]``."""
        return [PackSegment(x[o:o + n], rand, *g) for o, n, rand, g in
                zip(self.x_off, self.x_sizes, rands, self.geoms)]

    def views(self, packed: torch.Tensor, scale: torch.Tensor) -> list:
        """Each segment's (packed (nq, W) u32, scale (nq, 1) f32): views of
        the flat outputs."""
        return [(packed[po:po + nq * w].view(nq, w),
                 scale[so:so + nq].view(nq, 1))
                for po, so, (nq, w) in zip(self.packed_off, self.scale_off,
                                           self.code_shapes)]

    def launch(self, x_ptrs, rand_ptrs, packed: torch.Tensor,
               scale: torch.Tensor, scale_mode: str) -> int:
        """Pack every segment into ``packed`` and ``scale`` (the caller's
        contiguous CUDA tensors of ``packed_total`` u32 and ``scale_total``
        f32) with one library call; returns the kernels launched (one for
        every 48 non-empty segments)."""
        if scale_mode not in ("l2", "max"):
            raise ValueError(f"qsgd_pack: scale_mode={scale_mode!r}")
        launched = ctypes.c_int(0)
        d = self.desc.copy()
        d["x"] = x_ptrs
        d["rand"] = rand_ptrs
        d["packed"] = packed.data_ptr() + self.packed_bytes
        d["scale"] = scale.data_ptr() + self.scale_bytes
        with torch.cuda.device(packed.device):
            rc = _build.lib().qsgd_pack_grouped_f32(
                d.ctypes.data, self.n, self.bits,
                int(scale_mode == "max"), _build.stream(packed),
                ctypes.byref(launched))
        _build.check(rc, "qsgd_pack")
        return launched.value

    def outputs(self, device) -> tuple:
        """Empty flat (packed, scale) outputs on ``device``."""
        return (torch.empty(self.packed_total, dtype=torch.uint32,
                            device=device),
                torch.empty(self.scale_total, dtype=torch.float32,
                            device=device))


def _check_rand(rand: torch.Tensor, n: int) -> None:
    if rand.dtype != torch.uint32:
        raise ValueError(f"qsgd_pack: takes uint32 rand, got {rand.dtype}")
    if rand.numel() != n:
        raise ValueError(f"qsgd_pack: rand has {rand.numel()} entries, the "
                         f"geometry needs {n}")


def _check_aligned(*ptrs) -> None:
    if any(p % 16 for p in ptrs):
        raise ValueError("qsgd_pack: x and rand must start on a 16-byte "
                         "boundary (the kernel loads float4 / uint4)")


def qsgd_pack_table_cuda(table: PackTable, x: torch.Tensor, rands,
                         scale_mode: str = "l2") -> tuple:
    """Every segment of ``table``: its sums at ``table.x_off`` of the flat
    f32 ``x``, its bits ``rands[i]``. Returns the flat (packed, scale)
    outputs and the number of kernels launched."""
    _build.require_cuda("qsgd_pack", x, *rands)
    if x.dtype != torch.float32 or x.dim() != 1 or x.numel() < table.x_end:
        raise ValueError(f"qsgd_pack: x is {x.dtype} {tuple(x.shape)}, the "
                         f"table needs float32 of {table.x_end} entries or "
                         "more")
    if len(rands) != table.n:
        raise ValueError(f"qsgd_pack: {len(rands)} rounding bits for "
                         f"{table.n} segments")
    for rand, n in zip(rands, table.x_sizes):
        _check_rand(rand, n)
    rand_ptrs = [r.data_ptr() for r in rands]
    _check_aligned(x.data_ptr(), *rand_ptrs)
    packed, scale = table.outputs(x.device)
    launched = table.launch(x.data_ptr() + table.x_bytes, rand_ptrs, packed,
                            scale, scale_mode)
    return packed, scale, launched


def qsgd_pack_grouped_cuda(segments, bits: int,
                           scale_mode: str = "l2") -> tuple[list, int]:
    """(packed (nq, bq*bits/32) u32, scale (nq, 1) f32) per segment, from
    one library call, and the number of kernels launched (one for every
    48 non-empty segments): a :class:`PackTable` of the segments'
    geometries, launched on their tensors. The outputs are views of two
    allocations; each packed view starts on a 16-byte boundary, as the
    grouped unpack needs."""
    if scale_mode not in ("l2", "max"):
        raise ValueError(f"qsgd_pack: scale_mode={scale_mode!r}")
    for seg in segments:
        check_pack_segment(seg, bits)
    _build.require_cuda("qsgd_pack", *[
        t for seg in segments for t in (seg.x, seg.rand)])
    for seg in segments:
        if seg.x.dtype != torch.float32:
            raise ValueError(f"qsgd_pack: takes float32 x and uint32 rand, "
                             f"got {seg.x.dtype}, {seg.rand.dtype}")
        _check_rand(seg.rand, seg.rand.numel())
    table = PackTable([seg[2:7] for seg in segments], bits)
    x_ptrs = [seg.x.data_ptr() for seg in segments]
    rand_ptrs = [seg.rand.data_ptr() for seg in segments]
    _check_aligned(*x_ptrs, *rand_ptrs)
    packed, scale = table.outputs(segments[0].x.device)
    launched = table.launch(x_ptrs, rand_ptrs, packed, scale, scale_mode)
    # the views come after the launch: the card works while they are made
    return table.views(packed, scale), launched


def qsgd_pack_cuda(x: torch.Tensor, rand: torch.Tensor, bits: int,
                   scale_mode: str = "l2") -> tuple[tuple, int]:
    """x (nb,Bq) f32, rand (nb,Bq) u32 CUDA -> ((packed (nb, Bq*bits/32)
    u32, scale (nb,1) f32), kernels launched): one segment, p_pod =
    p_data = 1, rows = nb, shard = bq."""
    if x.dim() != 2 or x.shape != rand.shape:
        raise ValueError(f"qsgd_pack: x {tuple(x.shape)} and rand "
                         f"{tuple(rand.shape)} must be the same (nb, Bq)")
    nb, bq = x.shape
    outs, launched = qsgd_pack_grouped_cuda(
        [PackSegment(x, rand, 1, 1, nb, bq, bq)], bits,
        scale_mode)
    return outs[0], launched
