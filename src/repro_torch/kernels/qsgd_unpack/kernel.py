"""Launcher of the hand-written CUDA kernel ``csrc/qsgd_unpack.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/qsgd_unpack/kernel.py``
(``qsgd_unpack_pallas``). Bound by bytes: the packed words are read once
and the f32 output written once (see the source for the design).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def qsgd_unpack_cuda(packed: torch.Tensor, scale: torch.Tensor, bits: int):
    """packed (nb,W) u32, scale (nb,1) f32 CUDA -> xhat (nb, W*32/bits) f32."""
    _build.require_cuda("qsgd_unpack", packed, scale)
    if packed.dtype != torch.uint32 or scale.dtype != torch.float32:
        raise ValueError(f"qsgd_unpack: takes uint32 packed and float32 "
                         f"scale, got {packed.dtype}, {scale.dtype}")
    if packed.dim() != 2 or tuple(scale.shape) != (packed.shape[0], 1):
        raise ValueError(f"qsgd_unpack: packed {tuple(packed.shape)} needs "
                         f"scale (nb, 1), got {tuple(scale.shape)}")
    if bits not in (2, 4, 8):
        raise ValueError(f"qsgd_unpack: bits={bits}")
    nb, w = packed.shape
    out = torch.empty((nb, w * (32 // bits)), dtype=torch.float32,
                      device=packed.device)
    with torch.cuda.device(packed.device):
        rc = _build.lib().qsgd_unpack_f32(
            packed.data_ptr(), scale.data_ptr(), out.data_ptr(), nb, w,
            bits, _build.stream(packed))
    _build.check(rc, "qsgd_unpack")
    return out
