"""Device selection for the port's entry points.

Entry points run on the card unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for ``device``; raises if CUDA is asked for and absent.

    On CUDA it also turns TF32 off for matmuls and cuDNN: the JAX
    package's reference numerics are full f32, and PyTorch would otherwise
    run f32 convolutions (and, if enabled, matmuls) in TF32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on an NVIDIA GPU by "
                "default; pass device='cpu' to run its plain versions on "
                "the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
