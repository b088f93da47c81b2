"""Launcher of the hand-written CUDA kernel ``csrc/bucket_topk.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/bucket_topk/kernel.py``
(``bucket_topk_pallas``). Bound by bytes: x is read once and the residual
written once; the selection is a radix select of the k-th largest |x| in
at most four digit passes over a shared-memory histogram, whatever k is:
one warp a row up to B = 1024, one block a row above (see the source for
the design).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# B: every multiple of B_QUANTUM up to MAX_B (bucket_scatter's limit too)
B_QUANTUM = 128
MAX_B = 8192


def supported_b(b: int) -> bool:
    return b % B_QUANTUM == 0 and B_QUANTUM <= b <= MAX_B


def require_supported_b(b: int) -> None:
    """Raise, naming the limit, unless the CUDA kernel takes rows of B."""
    if not supported_b(b):
        raise ValueError(f"bucket_topk: the CUDA kernel takes B a multiple "
                         f"of {B_QUANTUM} up to {MAX_B}, got bucket_size={b}")


def bucket_topk_cuda(x: torch.Tensor, k: int):
    """x: (nb, B) f32 CUDA -> (val (nb,k), lidx (nb,k) i32, res (nb,B))."""
    _build.require_cuda("bucket_topk", x)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"bucket_topk: takes 2-D float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    nb, b = x.shape
    require_supported_b(b)
    if not 1 <= k <= b:
        raise ValueError(f"bucket_topk: k={k} outside 1 <= k <= B={b}")
    val = torch.empty((nb, k), dtype=x.dtype, device=x.device)
    lidx = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    res = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _build.lib().bucket_topk_f32(
            x.data_ptr(), val.data_ptr(), lidx.data_ptr(), res.data_ptr(),
            nb, b, k, _build.stream(x))
    _build.check(rc, "bucket_topk")
    return val, lidx, res
