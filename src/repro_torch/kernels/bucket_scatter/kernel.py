"""Launcher of the hand-written CUDA kernel ``csrc/bucket_scatter.cu``.

Replaces the Pallas TPU kernel
``src/repro/kernels/bucket_scatter/kernel.py`` (``bucket_scatter_pallas``)
and the sum over ranks run after it. Bound by bytes: the dense (G, nb, B)
sum is written once and the k-wide streams read once; the scatter and the
sum run in shared memory (see the source for the design). One kernel
serves every entry point: the single-source densify is a segment with
G = S = 1.

A grouped call's fixed part is a :class:`ScatterSumTable` (the segments'
shapes checked, their offsets and a ``BucketScatterSumSeg`` descriptor
each): the stacked executor builds it once per plan and patches only the
pointers a step (:func:`bucket_scatter_sum_table_cuda`, the streams read
from flat buffers); a segment list builds one per call.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucket_scatter.ref import (ScatterSumSegment,
                                                    check_scatter_sum)

MAX_B = 8192


class _Seg(ctypes.Structure):
    """``BucketScatterSumSeg`` of the CUDA source, field for field."""
    _fields_ = [("lidx", ctypes.c_void_p), ("val", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("g", ctypes.c_int),
                ("s", ctypes.c_int), ("nb", ctypes.c_int),
                ("k", ctypes.c_int), ("b", ctypes.c_int)]


class ScatterSumTable:
    """The fixed part of a grouped bucket_scatter_sum call over segments
    of shapes ``(g, s, nb, k, b)``: segment i's (g, s, nb, k) streams lie
    at ``in_off[i]`` of flat lidx (int32) and val (f32) buffers, one
    segment after the other, and its (g, nb, b) sum at ``out_off[i]`` of
    one flat f32 output of ``out_total`` entries, every sum on a 16-byte
    boundary (each size is a multiple of b, itself a multiple of 4).
    Built once; a call fills a copy of its descriptor array with
    the pointers."""

    def __init__(self, shapes):
        self.shapes = [tuple(int(v) for v in sh) for sh in shapes]
        for g, s, nb, k, b in self.shapes:
            if min(g, nb) < 0 or s < 1 or k < 1:
                raise ValueError(f"bucket_scatter_sum: bad segment shape "
                                 f"{(g, s, nb, k)}")
            if b % 4 or not 4 <= b <= MAX_B:
                raise ValueError(f"bucket_scatter_sum: B={b} must be a "
                                 f"multiple of 4 in [4, {MAX_B}]")
            if g * nb >= 2**31 or s >= 2**31 or k >= 2**31:
                raise ValueError("bucket_scatter_sum: 2^31 output rows or "
                                 "more")
        self.n = len(self.shapes)
        self.in_sizes = [g * s * nb * k for g, s, nb, k, _ in self.shapes]
        self.in_off = _build.offsets(self.in_sizes)
        self.in_total = sum(self.in_sizes)
        self.out_shapes = [(g, nb, b) for g, _, nb, _, b in self.shapes]
        self.out_sizes = [g * nb * b for g, nb, b in self.out_shapes]
        self.out_off = _build.offsets(self.out_sizes)
        self.out_total = sum(self.out_sizes)
        desc = np.zeros(self.n, dtype=np.dtype(_Seg))
        for f, col in zip(("g", "s", "nb", "k", "b"), zip(*self.shapes)):
            desc[f] = col
        self.desc = desc
        self.in_bytes = _build.byte_offsets(self.in_off)
        self.out_bytes = _build.byte_offsets(self.out_off)

    def segments(self, lidx: torch.Tensor, val: torch.Tensor) -> list:
        """The ``ScatterSumSegment`` of each segment: views of the flat
        stream buffers."""
        return [ScatterSumSegment(lidx[o:o + n].view(g, s, nb, k),
                                  val[o:o + n].view(g, s, nb, k), b)
                for o, n, (g, s, nb, k, b) in
                zip(self.in_off, self.in_sizes, self.shapes)]

    def views(self, out: torch.Tensor) -> list:
        """Each segment's (g, nb, b) sum: a view of the flat ``out``."""
        return [out[o:o + n].view(sh) for o, n, sh in
                zip(self.out_off, self.out_sizes, self.out_shapes)]

    def launch(self, lidx_ptrs, val_ptrs, out: torch.Tensor) -> int:
        """Densify and sum every segment into ``out`` (checked by the
        caller: a contiguous f32 CUDA tensor of ``out_total`` entries),
        with one library call; returns the kernels launched (one for every
        64 non-empty segments)."""
        launched = ctypes.c_int(0)
        d = self.desc.copy()
        d["lidx"] = lidx_ptrs
        d["val"] = val_ptrs
        d["out"] = out.data_ptr() + self.out_bytes
        with torch.cuda.device(out.device):
            rc = _build.lib().bucket_scatter_sum_grouped_f32(
                d.ctypes.data, self.n, _build.stream(out),
                ctypes.byref(launched))
        _build.check(rc, "bucket_scatter_sum")
        return launched.value


def bucket_scatter_sum_table_cuda(table: ScatterSumTable, lidx: torch.Tensor,
                                  val: torch.Tensor) -> tuple:
    """Every segment of ``table`` from the flat stream buffers ``lidx``
    (int32) and ``val`` (f32): the flat (out_total,) f32 sums and the
    number of kernels launched."""
    _build.require_cuda("bucket_scatter_sum", lidx, val)
    if (lidx.dtype != torch.int32 or val.dtype != torch.float32
            or lidx.dim() != 1 or val.dim() != 1
            or min(lidx.numel(), val.numel()) < table.in_total):
        raise ValueError(f"bucket_scatter_sum: the streams are {lidx.dtype} "
                         f"{tuple(lidx.shape)} and {val.dtype} "
                         f"{tuple(val.shape)}, the table needs int32 and "
                         f"float32 of {table.in_total} entries or more")
    out = torch.empty(table.out_total, dtype=torch.float32, device=val.device)
    launched = table.launch(lidx.data_ptr() + table.in_bytes,
                            val.data_ptr() + table.in_bytes, out)
    return out, launched


def _check(seg: ScatterSumSegment) -> None:
    check_scatter_sum(seg.lidx, seg.val, seg.b)
    if seg.lidx.dtype != torch.int32 or seg.val.dtype != torch.float32:
        raise ValueError(f"bucket_scatter_sum: takes int32 lidx and float32 "
                         f"val, got {seg.lidx.dtype}, {seg.val.dtype}")


def bucket_scatter_sum_grouped_cuda(segments) -> tuple[list, int]:
    """One (G, nb, B) f32 sum per segment, from one library call, and the
    number of kernels launched (one for every 64 non-empty segments): a
    :class:`ScatterSumTable` of the segments' shapes, launched on their
    tensors. The sums are views of one allocation."""
    for seg in segments:
        _check(seg)
    _build.require_cuda("bucket_scatter_sum", *[
        t for seg in segments for t in (seg.lidx, seg.val)])
    table = ScatterSumTable([(*seg.lidx.shape, seg.b) for seg in segments])
    flat = torch.empty(table.out_total, dtype=torch.float32,
                       device=segments[0].val.device)
    launched = table.launch([seg.lidx.data_ptr() for seg in segments],
                            [seg.val.data_ptr() for seg in segments], flat)
    # the views come after the launch: the card works while they are made
    return table.views(flat), launched


def bucket_scatter_sum_cuda(lidx: torch.Tensor, val: torch.Tensor,
                            b: int) -> tuple[torch.Tensor, int]:
    """lidx (G,S,nb,k) i32, val (G,S,nb,k) f32 CUDA -> (G, nb, b) f32 and
    the number of kernels launched: a one-segment grouped call."""
    outs, launched = bucket_scatter_sum_grouped_cuda(
        [ScatterSumSegment(lidx, val, b)])
    return outs[0], launched


def bucket_scatter_cuda(lidx: torch.Tensor, val: torch.Tensor,
                        b: int) -> tuple[torch.Tensor, int]:
    """lidx (nb,k) i32, val (nb,k) f32 CUDA -> dense (nb, b) f32 and the
    number of kernels launched: one source (G = S = 1)."""
    _build.require_cuda("bucket_scatter", lidx, val)
    if lidx.dim() != 2 or lidx.shape != val.shape:
        raise ValueError(f"bucket_scatter: lidx {tuple(lidx.shape)} and val "
                         f"{tuple(val.shape)} must be the same (nb, k)")
    nb, k = lidx.shape
    out, launched = bucket_scatter_sum_cuda(lidx.view(1, 1, nb, k),
                                            val.view(1, 1, nb, k), b)
    return out.view(nb, b), launched
