"""Launcher of the hand-written CUDA kernel ``csrc/bucket_scatter.cu``.

Replaces the Pallas TPU kernel
``src/repro/kernels/bucket_scatter/kernel.py`` (``bucket_scatter_pallas``)
and the sum over ranks run after it. Bound by bytes: the dense (G, nb, B)
sum is written once and the k-wide streams read once; the scatter and the
sum run in shared memory (see the source for the design). One kernel
serves both entry points: the single-source densify is a segment with
G = S = 1.
"""
from __future__ import annotations

import ctypes

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


def _check(seg: ScatterSumSegment) -> None:
    check_scatter_sum(seg.lidx, seg.val, seg.b)
    if seg.lidx.dtype != torch.int32 or seg.val.dtype != torch.float32:
        raise ValueError(f"bucket_scatter_sum: takes int32 lidx and float32 "
                         f"val, got {seg.lidx.dtype}, {seg.val.dtype}")
    if seg.b % 4 or not 4 <= seg.b <= MAX_B:
        raise ValueError(f"bucket_scatter_sum: B={seg.b} must be a multiple "
                         f"of 4 in [4, {MAX_B}]")
    g, s, nb, k = seg.lidx.shape
    if g * nb >= 2**31 or s >= 2**31 or k >= 2**31:
        raise ValueError("bucket_scatter_sum: 2^31 output rows or more")


def bucket_scatter_sum_grouped_cuda(segments) -> tuple[list, int]:
    """One (G, nb, B) f32 sum per segment, from one library call, and the
    number of kernels launched (one for every 64 non-empty segments). The
    sums are views of one allocation, each on a 16-byte boundary (every
    size is a multiple of B, itself a multiple of 4)."""
    for seg in segments:
        _check(seg)
    _build.require_cuda("bucket_scatter_sum", *[
        t for seg in segments for t in (seg.lidx, seg.val)])
    shapes = [(seg.lidx.shape[0], seg.lidx.shape[2], seg.b)
              for seg in segments]
    sizes = [g * nb * b for g, nb, b in shapes]
    dev = segments[0].val.device
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    descs = (_Seg * len(segments))()
    base = flat.data_ptr()
    for i, (seg, size) in enumerate(zip(segments, sizes)):
        descs[i] = _Seg(seg.lidx.data_ptr(), seg.val.data_ptr(), base,
                        *seg.lidx.shape, seg.b)
        base += 4 * size
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = _build.lib().bucket_scatter_sum_grouped_f32(
            ctypes.addressof(descs), len(segments), _build.stream(flat),
            ctypes.byref(launched))
    _build.check(rc, "bucket_scatter_sum")
    # the views come after the launch: the card works while they are made
    return [part.view(shape) for part, shape in
            zip(flat.split(sizes), shapes)], launched.value


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
