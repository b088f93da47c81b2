"""Launcher of the hand-written CUDA kernel ``csrc/qsgd_pack.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/qsgd_pack/kernel.py``
(``qsgd_pack_pallas``). Bound by bytes: x and rand are read once, the
packed codes written once (see the source for the design).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def qsgd_pack_cuda(x: torch.Tensor, rand: torch.Tensor, bits: int,
                   scale_mode: str = "l2"):
    """x (nb,Bq) f32, rand (nb,Bq) u32 CUDA -> (packed (nb, Bq*bits/32) u32,
    scale (nb,1) f32)."""
    _build.require_cuda("qsgd_pack", x, rand)
    if x.dtype != torch.float32 or rand.dtype != torch.uint32:
        raise ValueError(f"qsgd_pack: takes float32 x and uint32 rand, got "
                         f"{x.dtype}, {rand.dtype}")
    if x.dim() != 2 or x.shape != rand.shape:
        raise ValueError(f"qsgd_pack: x {tuple(x.shape)} and rand "
                         f"{tuple(rand.shape)} must be the same (nb, Bq)")
    if bits not in (2, 4, 8) or scale_mode not in ("l2", "max"):
        raise ValueError(f"qsgd_pack: bits={bits} scale_mode={scale_mode!r}")
    nb, bq = x.shape
    vpw = 32 // bits
    if bq % vpw or bq % 4:
        raise ValueError(f"qsgd_pack: Bq={bq} must divide into {vpw}-code "
                         "words and float4 loads")
    if x.data_ptr() % 16 or rand.data_ptr() % 16:
        raise ValueError("qsgd_pack: x and rand must start on a 16-byte "
                         "boundary (the kernel loads float4 / uint4)")
    packed = torch.empty((nb, bq // vpw), dtype=torch.uint32, device=x.device)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.lib().qsgd_pack_f32(
            x.data_ptr(), rand.data_ptr(), packed.data_ptr(),
            scale.data_ptr(), nb, bq, bits, int(scale_mode == "max"),
            _build.stream(x))
    _build.check(rc, "qsgd_pack")
    return packed, scale
