"""Weights and decode states from the JAX package to the port.

The port keeps the reference's parameter layout and key names, so a
params tree of numpy arrays (``jax.tree.map(np.asarray, params)``, or the
arrays of a reference checkpoint) converts leaf for leaf, nested stacks
(hybrid, vlm) included. A decode state keeps the reference's cache
layouts too (``models/model.DecodeState``), so a reference
``DecodeState`` converts field for field: ``kv`` and the vlm's
``cross_kv`` (a (k, v) pair) to ``KVCache``s, the ssm and hybrid
families' ``conv`` and ``ssm`` to tensors."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import KVCache
from repro_torch.models.model import DecodeState


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device="cpu") -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def decode_state_from_jax(state, device="cpu") -> DecodeState:
    """A reference ``DecodeState`` of numpy arrays (``jax.tree.map(
    np.asarray, state)``) -> the port's, on ``device``."""
    def pair(kv):
        return None if kv is None else KVCache(_tensor(kv[0], device),
                                               _tensor(kv[1], device))

    def one(a):
        return None if a is None else _tensor(a, device)

    return DecodeState(_tensor(state.pos, device).to(torch.int32),
                       kv=pair(state.kv), cross_kv=pair(state.cross_kv),
                       conv=one(state.conv), ssm=one(state.ssm))
