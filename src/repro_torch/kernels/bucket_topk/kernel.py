"""Launcher of the hand-written CUDA kernel ``csrc/bucket_topk.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/bucket_topk/kernel.py``
(``bucket_topk_pallas``). Bound by bytes: x is read once and the residual
written once; the selection is a radix select of the k-th largest |x| in
at most four digit passes over a warp's shared-memory histogram, whatever
k is (see the source for the design).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

SUPPORTED_B = (128, 256, 512, 1024)


def bucket_topk_cuda(x: torch.Tensor, k: int):
    """x: (nb, B) f32 CUDA -> (val (nb,k), lidx (nb,k) i32, res (nb,B))."""
    _build.require_cuda("bucket_topk", x)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"bucket_topk: takes 2-D float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    nb, b = x.shape
    if b not in SUPPORTED_B or not 1 <= k <= b:
        raise ValueError(f"bucket_topk: B={b} k={k} (B must be one of "
                         f"{SUPPORTED_B}, 1 <= k <= B)")
    val = torch.empty((nb, k), dtype=x.dtype, device=x.device)
    lidx = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    res = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _build.lib().bucket_topk_f32(
            x.data_ptr(), val.data_ptr(), lidx.data_ptr(), res.data_ptr(),
            nb, b, k, _build.stream(x))
    _build.check(rc, "bucket_topk")
    return val, lidx, res
