"""Public wrapper for qsgd_unpack with dispatch by the tensor's device (see
``bucket_topk/ops.py`` for the impl values and the launch count)."""
from __future__ import annotations

import torch

from repro_torch.kernels.qsgd_unpack.kernel import qsgd_unpack_cuda
from repro_torch.kernels.qsgd_unpack.ref import qsgd_unpack_ref


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
    out = qsgd_unpack_cuda(packed, scale, bits).to(out_dtype)
    qsgd_unpack.launches += 1
    return out


qsgd_unpack.launches = 0
