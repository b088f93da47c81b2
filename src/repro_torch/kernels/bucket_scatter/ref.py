"""Plain PyTorch version of bucket_scatter (stream densification).

  lidx: (nb, k) int32 local indices in [0, B) — may contain duplicates
        (duplicates accumulate, in j order) or out-of-range sentinels
        (>= B, or < 0: dropped)
  val:  (nb, k)
  -> dense (nb, B) with dense[r, lidx[r, j]] += val[r, j]

Dropped entries are routed to a spill column B that is cut off at the
end. One ``scatter_add_`` per j touches each row once, so duplicates sum
in j order on every device, as the oracle's scatter does.
"""
from __future__ import annotations

import torch


def bucket_scatter_ref(lidx: torch.Tensor, val: torch.Tensor, b: int):
    nb, k = lidx.shape
    idx = lidx.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < b), idx, b)
    out = torch.zeros((nb, b + 1), dtype=val.dtype, device=val.device)
    for j in range(k):
        out.scatter_add_(1, idx[:, j:j + 1], val[:, j:j + 1])
    return out[:, :b].contiguous()
