"""Public wrapper for qsgd_pack with dispatch by the tensor's device (see
``bucket_topk/ops.py`` for the impl values and the launch count; ref.py
for the semantics)."""
from __future__ import annotations

import torch

from repro_torch.kernels.qsgd_pack.kernel import qsgd_pack_cuda
from repro_torch.kernels.qsgd_pack.ref import qsgd_pack_ref


def qsgd_pack(x: torch.Tensor, rand: torch.Tensor, bits: int = 4,
              scale_mode: str = "l2", impl: str = "auto"):
    """Quantize+pack buckets. x, rand: (nb, Bq) -> (packed u32
    (nb, Bq*bits/32), scale f32 (nb, 1))."""
    if bits not in (2, 4, 8):
        raise ValueError(f"qsgd_pack: bits={bits}")
    if x.shape[1] % (32 // bits):
        raise ValueError(f"qsgd_pack: Bq={x.shape[1]} is not a whole number "
                         "of words")
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "ref":
        return qsgd_pack_ref(x, rand, bits, scale_mode)
    if impl != "cuda":
        raise ValueError(f"qsgd_pack: unknown impl {impl!r}")
    out = qsgd_pack_cuda(x, rand, bits, scale_mode)
    qsgd_pack.launches += 1
    return out


qsgd_pack.launches = 0
