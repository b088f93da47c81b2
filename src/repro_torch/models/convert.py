"""Weights and decode states from the JAX package to the port.

The port keeps the reference's parameter layout and key names, so a
params tree of numpy arrays (``jax.tree.map(np.asarray, params)``, or the
arrays of a reference checkpoint) converts leaf for leaf. A decode state
keeps the reference's cache layout too, (L, B, W, nkv, hd), so a
reference ``DecodeState`` converts field for field."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import KVCache
from repro_torch.models.model import DecodeState


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, device="cpu") -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def decode_state_from_jax(state, device="cpu") -> DecodeState:
    """A reference ``DecodeState`` of numpy arrays (``jax.tree.map(
    np.asarray, state)``) -> the port's, on ``device``. Only the dense
    family's state (``pos`` and the stacked ``kv``) is ported; a state
    that carries the other families' caches raises."""
    for name in ("cross_kv", "conv", "ssm"):
        if getattr(state, name, None) is not None:
            raise NotImplementedError(
                f"decode state field {name!r}: its family is not ported yet "
                "(ROADMAP Queue 1 item 12)")
    return DecodeState(_tensor(state.pos, device).to(torch.int32),
                       KVCache(_tensor(state.kv.k, device),
                               _tensor(state.kv.v, device)))
