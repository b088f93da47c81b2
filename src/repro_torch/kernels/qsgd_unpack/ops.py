"""Public wrappers for qsgd_unpack with dispatch by the tensor's device (see
``bucket_topk/ops.py`` for the impl values and the launch count)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qsgd_unpack.kernel import (UnpackTable,
                                                    qsgd_unpack_cuda,
                                                    qsgd_unpack_grouped_cuda,
                                                    qsgd_unpack_table_cuda)
from repro_torch.kernels.qsgd_unpack.ref import (qsgd_unpack_grouped_ref,
                                                 qsgd_unpack_ref)


def qsgd_unpack(packed: torch.Tensor, scale: torch.Tensor, bits: int = 4,
                out_dtype=torch.float32, impl: str = "auto"):
    """packed u32 (nb, W), scale (nb, 1) -> xhat (nb, W*32//bits)."""
    if bits not in (2, 4, 8):
        raise ValueError(f"qsgd_unpack: bits={bits}")
    if impl == "auto":
        impl = "cuda" if packed.is_cuda else "ref"
    if impl == "ref":
        return qsgd_unpack_ref(packed, scale, bits, out_dtype)
    if impl != "cuda":
        raise ValueError(f"qsgd_unpack: unknown impl {impl!r}")
    out, launched = qsgd_unpack_cuda(packed, scale, bits)
    qsgd_unpack.launches += launched
    return out.to(out_dtype)


qsgd_unpack.launches = 0


def qsgd_unpack_grouped(segments, bits: int = 4, impl: str = "auto") -> list:
    """Every DSAR + QSGD bucket's reduced (rows, p_data*shard) f32 buffer
    from its packed shards (``ref.UnpackSegment``): unpack, sum over pods,
    times the mean. One library call for all segments, one kernel launch
    for every 48 non-empty ones; ``launches`` counts kernel launches."""
    if not segments:
        return []
    if impl == "auto":
        impl = "cuda" if segments[0].packed.is_cuda else "ref"
    if impl == "ref":
        return qsgd_unpack_grouped_ref(segments, bits)
    if impl != "cuda":
        raise ValueError(f"qsgd_unpack_grouped: unknown impl {impl!r}")
    outs, launched = qsgd_unpack_grouped_cuda(segments, bits)
    qsgd_unpack_grouped.launches += launched
    return outs


qsgd_unpack_grouped.launches = 0


def qsgd_unpack_table(table: UnpackTable, packed: torch.Tensor,
                      scale: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Every segment of ``table`` from the flat codes and scales (segment
    i's at ``table.packed_off[i]`` and ``table.scale_off[i]``): the flat
    (``table.out_total``,) f32 output, segment i's reduced (rows,
    p_data*shard) buffer at ``table.out_off[i]``. One library call on a
    CUDA tensor (counted in ``qsgd_unpack_grouped.launches``)."""
    if _build.resolve_impl(impl, packed, "qsgd_unpack_grouped") == "ref":
        parts = [o.reshape(-1) for o in qsgd_unpack_grouped_ref(
            table.segments(packed, scale), table.bits)]
        return torch.cat(parts) if parts else scale.new_empty(0)
    out, launched = qsgd_unpack_table_cuda(table, packed, scale)
    qsgd_unpack_grouped.launches += launched
    return out
