"""Plain PyTorch version of QSGD unpack+dequantize (inverse of qsgd_pack).

The reference source writes ``code / s * scale``. XLA compiles that as
``code * (scale * fl(1/s))``: it turns the division by the constant s into
a multiply by its f32 reciprocal and reassociates it with the scale. The
port reproduces that compiled arithmetic, which is what the reference
package computes, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.qsgd_pack.ref import levels, u32_to_i64


def qsgd_unpack_ref(packed: torch.Tensor, scale: torch.Tensor, bits: int,
                    out_dtype=torch.float32):
    nb, w = packed.shape
    vpw = 32 // bits
    s = levels(bits)
    mask = 2**bits - 1
    shifts = torch.arange(vpw, dtype=torch.int64, device=packed.device) * bits
    biased = (u32_to_i64(packed)[:, :, None] >> shifts) & mask  # (nb, w, vpw)
    code = (biased - s).to(torch.float32)
    recip = torch.tensor(1.0, dtype=torch.float32) / s
    step = scale.to(torch.float32) * recip.to(scale.device)      # (nb, 1)
    xhat = code * step[:, :, None]
    return xhat.reshape(nb, w * vpw).to(out_dtype)
