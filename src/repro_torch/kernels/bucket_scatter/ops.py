"""Public wrappers for bucket_scatter and bucket_scatter_sum with dispatch
by the tensor's device (see ``bucket_topk/ops.py`` for the impl values;
ref.py for the semantics).

``bucket_scatter.launches`` counts the single-source densify's kernel
launches; ``bucket_scatter_sum.launches`` counts those of the fused
densify + source-order sum, one segment, grouped or from a
plan-built table (:func:`bucket_scatter_sum_table`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucket_scatter.kernel import (
    ScatterSumTable, bucket_scatter_cuda, bucket_scatter_sum_cuda,
    bucket_scatter_sum_grouped_cuda, bucket_scatter_sum_table_cuda)
from repro_torch.kernels.bucket_scatter.ref import (bucket_scatter_ref,
                                                    bucket_scatter_sum_ref)


def bucket_scatter(lidx: torch.Tensor, val: torch.Tensor, b: int,
                   impl: str = "auto"):
    """Densify per-bucket streams: (nb,k) idx/val -> (nb,B) dense (adds
    dups, drops out-of-range sentinel indices)."""
    if _build.resolve_impl(impl, val, "bucket_scatter") == "ref":
        return bucket_scatter_ref(lidx, val, b)
    out, launched = bucket_scatter_cuda(lidx, val, b)
    bucket_scatter.launches += launched
    return out


bucket_scatter.launches = 0


def bucket_scatter_sum(lidx: torch.Tensor, val: torch.Tensor, b: int,
                       impl: str = "auto"):
    """Densify S sources' streams and sum them in source order:
    (G,S,nb,k) idx/val -> (G,nb,B), bit for bit the single-source densify
    of each source followed by ``ordered_sum`` over S."""
    if _build.resolve_impl(impl, val, "bucket_scatter_sum") == "ref":
        return bucket_scatter_sum_ref(lidx, val, b)
    out, launched = bucket_scatter_sum_cuda(lidx, val, b)
    bucket_scatter_sum.launches += launched
    return out


bucket_scatter_sum.launches = 0


def bucket_scatter_sum_grouped(segments, impl: str = "auto") -> list:
    """bucket_scatter_sum of every ``ref.ScatterSumSegment``: one library
    call, one kernel launch for every 64 non-empty segments (counted in
    ``bucket_scatter_sum.launches``)."""
    if not segments:
        return []
    if _build.resolve_impl(impl, segments[0].val,
                            "bucket_scatter_sum") == "ref":
        return [bucket_scatter_sum_ref(*seg) for seg in segments]
    outs, launched = bucket_scatter_sum_grouped_cuda(segments)
    bucket_scatter_sum.launches += launched
    return outs


def bucket_scatter_sum_table(table: ScatterSumTable, lidx: torch.Tensor,
                             val: torch.Tensor, impl: str = "auto"):
    """bucket_scatter_sum of every segment of ``table``, the streams read
    at ``table.in_off`` of the flat ``lidx``/``val``: the flat
    (``table.out_total``,) f32 sums, segment i's (g, nb, b) at
    ``table.out_off[i]``. One library call on a CUDA tensor (counted in
    ``bucket_scatter_sum.launches``)."""
    if _build.resolve_impl(impl, val, "bucket_scatter_sum") == "ref":
        parts = [bucket_scatter_sum_ref(*seg).reshape(-1)
                 for seg in table.segments(lidx, val)]
        return torch.cat(parts) if parts else val.new_empty(0)
    out, launched = bucket_scatter_sum_table_cuda(table, lidx, val)
    bucket_scatter_sum.launches += launched
    return out
