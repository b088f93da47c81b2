"""Public wrapper for bucket_topk with dispatch by the tensor's device.

impl='auto' -> the CUDA kernel for a CUDA tensor, the plain PyTorch
               version for a CPU tensor (there is no fallback: a CUDA
               tensor launches the kernel or raises).
impl='cuda' -> the CUDA kernel; raises for a CPU tensor.
impl='ref'  -> the plain PyTorch version on any device.

``bucket_topk.launches`` counts kernel launches (and nothing else), so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bucket_topk.kernel import (bucket_topk_cuda,
                                                    require_supported_b)
from repro_torch.kernels.bucket_topk.ref import bucket_topk_ref


def bucket_topk(x: torch.Tensor, k: int, impl: str = "auto"):
    """Per-bucket top-|k| select/compact. x: (nb, B).

    Returns (val (nb,k), lidx (nb,k) i32 ascending, residual (nb,B)).
    """
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "ref":
        return bucket_topk_ref(x, k)
    if impl != "cuda":
        raise ValueError(f"bucket_topk: unknown impl {impl!r}")
    out = bucket_topk_cuda(x, k)
    bucket_topk.launches += 1
    return out


bucket_topk.launches = 0


def check_bucket_size(bucket_size: int, device, impl: str = "auto") -> None:
    """Raise, naming the limit, when ``bucket_topk`` would launch its CUDA
    kernel on ``device`` for rows of ``bucket_size`` that the kernel does
    not take: the builders of the step and of the allreduce call this, so
    the refusal comes before any launch."""
    if impl == "ref" or (impl == "auto"
                         and torch.device(device).type != "cuda"):
        return
    require_supported_b(bucket_size)
