"""Plain PyTorch version of bucket_scatter (stream densification) and of
bucket_scatter_sum (the densify of S sources summed in source order).

  lidx: (nb, k) int32 local indices in [0, B) — may contain duplicates
        (duplicates accumulate, in j order) or out-of-range sentinels
        (>= B, or < 0: dropped)
  val:  (nb, k)
  -> dense (nb, B) with dense[r, lidx[r, j]] += val[r, j]

Dropped entries are routed to a spill column B that is cut off at the
end. One ``scatter_add_`` per j touches each row once, so duplicates sum
in j order on every device, as the oracle's scatter does.

``bucket_scatter_sum_ref`` takes (G, S, nb, k) streams and returns
(G, nb, B): each source densified as above, then the sources added in
index order, ((d_0 + d_1) + d_2) + ..., as
``comm.collectives.ordered_sum`` adds ranks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ScatterSumSegment(NamedTuple):
    """One bucket of a grouped bucket_scatter_sum: S sources' streams for
    G independent outputs of nb rows of B."""
    lidx: torch.Tensor     # (G, S, nb, k) int32
    val: torch.Tensor      # (G, S, nb, k) f32
    b: int


def bucket_scatter_ref(lidx: torch.Tensor, val: torch.Tensor, b: int):
    nb, k = lidx.shape
    idx = lidx.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < b), idx, b)
    out = torch.zeros((nb, b + 1), dtype=val.dtype, device=val.device)
    for j in range(k):
        out.scatter_add_(1, idx[:, j:j + 1], val[:, j:j + 1])
    return out[:, :b].contiguous()


def check_scatter_sum(lidx: torch.Tensor, val: torch.Tensor, b: int) -> None:
    """Raise unless lidx/val are one (G, S, nb, k) shape with k >= 1."""
    if lidx.dim() != 4 or lidx.shape != val.shape or lidx.shape[3] < 1 \
            or lidx.shape[1] < 1:
        raise ValueError(f"bucket_scatter_sum: lidx {tuple(lidx.shape)} and "
                         f"val {tuple(val.shape)} must be one (G, S, nb, k) "
                         "with S, k >= 1")
    if b < 1:
        raise ValueError(f"bucket_scatter_sum: B={b}")


def bucket_scatter_sum_ref(lidx: torch.Tensor, val: torch.Tensor, b: int):
    check_scatter_sum(lidx, val, b)
    g, s, nb, k = lidx.shape
    dense = bucket_scatter_ref(lidx.reshape(-1, k), val.reshape(-1, k), b)
    parts = dense.reshape(g, s, nb, b).unbind(1)
    acc = parts[0].clone()
    for t in parts[1:]:
        acc += t
    return acc
