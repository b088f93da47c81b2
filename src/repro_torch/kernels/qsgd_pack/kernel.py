"""Launcher of the hand-written CUDA kernel ``csrc/qsgd_pack.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/qsgd_pack/kernel.py``
(``qsgd_pack_pallas``) and, in its grouped form, the permute copy the
executor made before it. Bound by bytes: x and rand are read once, the
packed codes written once (see the source for the design). One kernel
serves both entry points: the single-bucket pack is one segment with
p_pod = p_data = 1, whose rows lie in order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qsgd_pack.ref import PackSegment, check_pack_segment


class _Seg(ctypes.Structure):
    """``QsgdPackSeg`` of the CUDA source, field for field."""
    _fields_ = [("x", ctypes.c_void_p), ("rand", ctypes.c_void_p),
                ("packed", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("p_pod", ctypes.c_int), ("p_data", ctypes.c_int),
                ("rows", ctypes.c_int), ("shard", ctypes.c_int),
                ("bq", ctypes.c_int)]


def qsgd_pack_grouped_cuda(segments, bits: int,
                           scale_mode: str = "l2") -> tuple[list, int]:
    """(packed (nq, bq*bits/32) u32, scale (nq, 1) f32) per segment, from
    one library call, and the number of kernels launched (one for every
    48 non-empty segments). The outputs are views of two allocations;
    each packed view starts on a 16-byte boundary, as the grouped unpack
    needs."""
    if scale_mode not in ("l2", "max"):
        raise ValueError(f"qsgd_pack: scale_mode={scale_mode!r}")
    nqs = [check_pack_segment(seg, bits) for seg in segments]
    _build.require_cuda("qsgd_pack", *[
        t for seg in segments for t in (seg.x, seg.rand)])
    for seg, nq in zip(segments, nqs):
        if seg.x.dtype != torch.float32 or seg.rand.dtype != torch.uint32:
            raise ValueError(f"qsgd_pack: takes float32 x and uint32 rand, "
                             f"got {seg.x.dtype}, {seg.rand.dtype}")
        if seg.bq % 4:
            raise ValueError(f"qsgd_pack: Bq={seg.bq} must divide into "
                             "float4 loads")
        if seg.x.data_ptr() % 16 or seg.rand.data_ptr() % 16:
            raise ValueError("qsgd_pack: x and rand must start on a 16-byte "
                             "boundary (the kernel loads float4 / uint4)")
        if nq >= 2**31:
            raise ValueError("qsgd_pack: 2^31 QSGD rows or more")
    words = [nq * (seg.bq * bits // 32) for seg, nq in zip(segments, nqs)]
    starts = [0]
    for w in words:                       # each segment's words start on
        starts.append(starts[-1] + -(-w // 4) * 4)   # a 16-byte boundary
    dev = segments[0].x.device
    packed = torch.empty(starts[-1], dtype=torch.uint32, device=dev)
    scale = torch.empty(sum(nqs), dtype=torch.float32, device=dev)
    descs = (_Seg * len(segments))()
    s0 = 0
    for i, (seg, nq) in enumerate(zip(segments, nqs)):
        descs[i] = _Seg(seg.x.data_ptr(), seg.rand.data_ptr(),
                        packed.data_ptr() + 4 * starts[i],
                        scale.data_ptr() + 4 * s0, *seg[2:7])
        s0 += nq
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = _build.lib().qsgd_pack_grouped_f32(
            ctypes.addressof(descs), len(segments), bits,
            int(scale_mode == "max"), _build.stream(packed),
            ctypes.byref(launched))
    _build.check(rc, "qsgd_pack")
    # the views come after the launch: the card works while they are made
    outs, s0 = [], 0
    for seg, nq, w, start in zip(segments, nqs, words, starts):
        outs.append((packed[start:start + w].view(nq, seg.bq * bits // 32),
                     scale[s0:s0 + nq].view(nq, 1)))
        s0 += nq
    return outs, launched.value


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
