"""Launcher of the hand-written CUDA kernel ``csrc/bucket_scatter.cu``.

Replaces the Pallas TPU kernel
``src/repro/kernels/bucket_scatter/kernel.py`` (``bucket_scatter_pallas``).
Bound by bytes: the dense (nb, B) output is written once; the scatter
itself runs in shared memory (see the source for the design).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_B = 8192


def bucket_scatter_cuda(lidx: torch.Tensor, val: torch.Tensor, b: int):
    """lidx (nb,k) i32, val (nb,k) f32 CUDA -> dense (nb, b) f32."""
    _build.require_cuda("bucket_scatter", lidx, val)
    if lidx.dtype != torch.int32 or val.dtype != torch.float32:
        raise ValueError(f"bucket_scatter: takes int32 lidx and float32 val, "
                         f"got {lidx.dtype}, {val.dtype}")
    if lidx.dim() != 2 or lidx.shape != val.shape:
        raise ValueError(f"bucket_scatter: lidx {tuple(lidx.shape)} and val "
                         f"{tuple(val.shape)} must be the same (nb, k)")
    if b % 4 or not 4 <= b <= MAX_B or lidx.shape[1] < 1:
        raise ValueError(f"bucket_scatter: B={b} must be a multiple of 4 in "
                         f"[4, {MAX_B}], k >= 1")
    nb, k = lidx.shape
    out = torch.empty((nb, b), dtype=torch.float32, device=val.device)
    with torch.cuda.device(val.device):
        rc = _build.lib().bucket_scatter_f32(
            lidx.data_ptr(), val.data_ptr(), out.data_ptr(), nb, k, b,
            _build.stream(val))
    _build.check(rc, "bucket_scatter")
    return out
