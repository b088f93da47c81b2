"""Public wrappers for bucket_scatter and bucket_scatter_sum with dispatch
by the tensor's device (see ``bucket_topk/ops.py`` for the impl values;
ref.py for the semantics).

``bucket_scatter.launches`` counts the single-source densify's kernel
launches; ``bucket_scatter_sum.launches`` counts those of the fused
densify + source-order sum, one segment or grouped."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucket_scatter.kernel import (
    bucket_scatter_cuda, bucket_scatter_sum_cuda,
    bucket_scatter_sum_grouped_cuda)
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
