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


def bucket_topk_ef_grouped_ref(table, res, buf: torch.Tensor,
                               val: torch.Tensor, lidx: torch.Tensor):
    """The grouped EF add + TopK (``ops.bucket_topk_ef_grouped``) bucket by
    bucket: ``bucket_topk_ref(res + slice)``, the streams written into the
    flat buffers at ``table.stream_off``; returns the new residuals."""
    out = []
    for r, (cs, cols), off, n in zip(res, table.spans, table.stream_off,
                                     table.stream_sizes):
        acc = r.to(torch.float32) + buf[:, :, cs:cs + cols]
        v, li, rest = bucket_topk_ref(acc.reshape(-1, table.b), table.k)
        val[off:off + n] = v.reshape(-1)
        lidx[off:off + n] = li.reshape(-1)
        out.append(rest.reshape(acc.shape))
    return out
