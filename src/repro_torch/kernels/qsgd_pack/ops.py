"""Public wrappers for qsgd_pack with dispatch by the tensor's device (see
``bucket_topk/ops.py`` for the impl values; ref.py for the semantics).
``qsgd_pack.launches`` counts the kernel's launches, from the
single-bucket call, the grouped one and the plan-built table's alike."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qsgd_pack.kernel import (PackTable, qsgd_pack_cuda,
                                                  qsgd_pack_grouped_cuda,
                                                  qsgd_pack_table_cuda)
from repro_torch.kernels.qsgd_pack.ref import (qsgd_pack_grouped_ref,
                                               qsgd_pack_ref)


def qsgd_pack(x: torch.Tensor, rand: torch.Tensor, bits: int = 4,
              scale_mode: str = "l2", impl: str = "auto"):
    """Quantize+pack buckets. x, rand: (nb, Bq) -> (packed u32
    (nb, Bq*bits/32), scale f32 (nb, 1))."""
    if bits not in (2, 4, 8):
        raise ValueError(f"qsgd_pack: bits={bits}")
    if x.shape[1] % (32 // bits):
        raise ValueError(f"qsgd_pack: Bq={x.shape[1]} is not a whole number "
                         "of words")
    if _build.resolve_impl(impl, x, "qsgd_pack") == "ref":
        return qsgd_pack_ref(x, rand, bits, scale_mode)
    out, launched = qsgd_pack_cuda(x, rand, bits, scale_mode)
    qsgd_pack.launches += launched
    return out


qsgd_pack.launches = 0


def qsgd_pack_grouped(segments, bits: int = 4, scale_mode: str = "l2",
                      impl: str = "auto") -> list:
    """Every DSAR + QSGD bucket's (packed, scale) from its summed buffer
    (``ref.PackSegment``): one library call, one kernel launch for every
    48 non-empty segments (counted in ``qsgd_pack.launches``)."""
    if not segments:
        return []
    if _build.resolve_impl(impl, segments[0].x, "qsgd_pack") == "ref":
        return qsgd_pack_grouped_ref(segments, bits, scale_mode)
    outs, launched = qsgd_pack_grouped_cuda(segments, bits, scale_mode)
    qsgd_pack.launches += launched
    return outs


def qsgd_pack_table(table: PackTable, x: torch.Tensor, rands,
                    scale_mode: str = "l2", impl: str = "auto") -> tuple:
    """Every segment of ``table``: its sums at ``table.x_off`` of the flat
    f32 ``x``, its bits ``rands[i]``. Returns the flat (packed u32, scale
    f32) outputs, segment i's codes at ``table.packed_off[i]`` and scales
    at ``table.scale_off[i]``. One library call on a CUDA tensor (counted
    in ``qsgd_pack.launches``)."""
    if _build.resolve_impl(impl, x, "qsgd_pack") == "ref":
        packed = torch.zeros(table.packed_total, dtype=torch.uint32,
                             device=x.device)
        scale = torch.zeros(table.scale_total, dtype=torch.float32,
                            device=x.device)
        outs = qsgd_pack_grouped_ref(table.segments(x, rands), table.bits,
                                     scale_mode)
        for (pv, sv), (pw, sw) in zip(table.views(packed, scale), outs):
            pv.copy_(pw)
            sv.copy_(sw)
        return packed, scale
    packed, scale, launched = qsgd_pack_table_cuda(table, x, rands,
                                                   scale_mode)
    qsgd_pack.launches += launched
    return packed, scale
