"""Public wrapper for bucket_topk with dispatch by the tensor's device.

impl='auto' -> the CUDA kernel for a CUDA tensor, the plain PyTorch
               version for a CPU tensor (there is no fallback: a CUDA
               tensor launches the kernel or raises).
impl='cuda' -> the CUDA kernel; raises for a CPU tensor.
impl='ref'  -> the plain PyTorch version on any device.

``bucket_topk.launches`` counts kernel launches (and nothing else), so a
run can show that its main path went through the kernel; the grouped
entry (:func:`bucket_topk_ef_grouped`) adds the kernels its one library
call launched, and ``bucket_topk.grouped_buckets`` the EF buckets that
call took.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucket_topk.kernel import (
    EfTopkTable, bucket_topk_cuda, bucket_topk_ef_grouped_cuda,
    require_supported_b)
from repro_torch.kernels.bucket_topk.ref import (bucket_topk_ef_grouped_ref,
                                                 bucket_topk_ref)


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
bucket_topk.grouped_buckets = 0


def bucket_topk_ef_grouped(table: EfTopkTable, res, buf: torch.Tensor,
                           val: torch.Tensor, lidx: torch.Tensor,
                           impl: str = "auto") -> list:
    """The error-feedback add and the TopK of every EF bucket of
    ``table`` over one packed group buffer ``buf``: bucket i's rows are
    ``res[i] + buf[:, :, cs:cs + cols]`` (f32), its val/lidx go to the flat
    ``val``/``lidx`` at ``table.stream_off[i]`` and its new residual is
    returned, a (lead, rows, cols) tensor a bucket. On a CUDA tensor one
    library call (``bucket_topk_ef_grouped_f32``, the add fused into the
    kernel); on a CPU tensor ``bucket_topk_ref(res + slice)`` a bucket."""
    if _build.resolve_impl(impl, buf, "bucket_topk") == "ref":
        return bucket_topk_ef_grouped_ref(table, res, buf, val, lidx)
    out, launched = bucket_topk_ef_grouped_cuda(table, res, buf, val, lidx)
    bucket_topk.launches += launched
    bucket_topk.grouped_buckets += table.n
    return out


def check_bucket_size(bucket_size: int, device, impl: str = "auto") -> None:
    """Raise, naming the limit, when ``bucket_topk`` would launch its CUDA
    kernel on ``device`` for rows of ``bucket_size`` that the kernel does
    not take: the builders of the step and of the allreduce call this, so
    the refusal comes before any launch."""
    if impl == "ref" or (impl == "auto"
                         and torch.device(device).type != "cuda"):
        return
    require_supported_b(bucket_size)
