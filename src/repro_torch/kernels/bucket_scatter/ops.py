"""Public wrapper for bucket_scatter with dispatch by the tensor's device
(see ``bucket_topk/ops.py`` for the impl values and the launch count)."""
from __future__ import annotations

import torch

from repro_torch.kernels.bucket_scatter.kernel import bucket_scatter_cuda
from repro_torch.kernels.bucket_scatter.ref import bucket_scatter_ref


def bucket_scatter(lidx: torch.Tensor, val: torch.Tensor, b: int,
                   impl: str = "auto"):
    """Densify per-bucket streams: (nb,k) idx/val -> (nb,B) dense (adds
    dups, drops out-of-range sentinel indices)."""
    if impl == "auto":
        impl = "cuda" if val.is_cuda else "ref"
    if impl == "ref":
        return bucket_scatter_ref(lidx, val, b)
    if impl != "cuda":
        raise ValueError(f"bucket_scatter: unknown impl {impl!r}")
    out = bucket_scatter_cuda(lidx, val, b)
    bucket_scatter.launches += 1
    return out


bucket_scatter.launches = 0
