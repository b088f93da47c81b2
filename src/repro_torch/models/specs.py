"""Path-based sharding specs for the model parameters.

A spec is a tuple of axis names, one per dim of the leaf (None = not
sharded). The port runs on one device, so nothing is actually sharded;
the specs exist because the sync plan's canonical layout puts the dim
named 'model' first, and the plan must match the JAX package's
(``repro.models.specs``) leaf for leaf. Leading stack axes (layer
nesting) are never sharded. ``fsdp`` is the tuple of data axes or None
(sparcml sync needs DP-replicated params).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ModelConfig
from repro_torch.utils.tree import tree_flatten, tree_unflatten


def _leaf_spec(names: tuple[str, ...], ndim: int, fsdp, cfg: ModelConfig
               ) -> tuple:
    name = names[-1]

    def with_stack(*trailing) -> tuple:
        """Pad leading stack axes with None."""
        return (None,) * (ndim - len(trailing)) + tuple(trailing)

    if name == "embed":
        return (None, "model")
    if name == "unembed":
        return (fsdp, "model")
    if name in ("vision_proj", "frontend_proj"):
        return (fsdp, "model")
    if name == "pos_embed":
        return (None, fsdp)

    in_moe = "moe" in names
    if in_moe and name in ("wi", "wg"):
        return with_stack("model", fsdp, None)   # (E,d,ff): EP over experts
    if in_moe and name == "wo":
        return with_stack("model", None, fsdp)
    if name == "router":
        return with_stack(None, None)

    if name in ("wq", "wk", "wv", "wi", "wg", "in_proj"):
        return with_stack(fsdp, "model")
    if name in ("wo", "out_proj"):
        return with_stack("model", fsdp)

    # norms, gates, conv, A_log, D, dt_bias, scale ... replicated
    return ()


def param_specs(params_or_shapes, cfg: ModelConfig,
                fsdp_axes: Optional[tuple] = None) -> dict:
    """Dict tree of spec tuples matching the params tree (leaves need only
    ``.shape``)."""
    fsdp = fsdp_axes if fsdp_axes else None
    leaves, paths = tree_flatten(params_or_shapes)
    return tree_unflatten(paths, [
        _leaf_spec(path, len(leaf.shape), fsdp, cfg)
        for leaf, path in zip(leaves, paths)])
