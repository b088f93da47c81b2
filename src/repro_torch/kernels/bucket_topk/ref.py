"""Plain PyTorch version of bucket_topk (stable-sort selection).

Semantics (shared with the CUDA kernel and with
``src/repro/kernels/bucket_topk/ref.py``):
  input  x:   (nb, B) values
  output val: (nb, k) selected values, ordered by ascending local index
         lidx:(nb, k) int32 local indices (within bucket), ascending
         res: (nb, B) residual = x with selected entries zeroed

Selection: top-k by |x| per bucket; ties go to the LOWER index.
``torch.topk`` promises no order among ties, so the selection is a stable
descending sort whose first k positions are then sorted by index.
"""
from __future__ import annotations

import torch


def bucket_topk_ref(x: torch.Tensor, k: int):
    order = torch.sort(x.abs(), dim=1, descending=True, stable=True).indices
    lidx = torch.sort(order[:, :k], dim=1).values
    val = torch.gather(x, 1, lidx)
    res = x.scatter(1, lidx, 0.0)
    return val, lidx.to(torch.int32), res
