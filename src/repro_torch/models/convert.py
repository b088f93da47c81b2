"""Weights from the JAX package to the port.

The port keeps the reference's parameter layout and key names, so a
params tree of numpy arrays (``jax.tree.map(np.asarray, params)``, or the
arrays of a reference checkpoint) converts leaf for leaf."""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu") -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
