"""Path-based sharding specs for the model parameters.

A spec is a tuple of axis names, one per dim of the leaf (None = not
sharded). The port runs on one device, so nothing is actually sharded;
the specs exist because the sync plan's canonical layout puts the dim
named 'model' first, and the plan must match the JAX package's
(``repro.models.specs``) leaf for leaf. Leading stack axes (layer
nesting) are never sharded. ``fsdp`` is the tuple of data axes or None
(sparcml sync needs DP-replicated params).

The data axes are the one sharding the port does hold: under fsdp
(ZeRO-3) every rank keeps its slice of the dim that the reference's
spec shards over ``fsdp`` (:func:`fsdp_layout`), and the leaves whose
spec names no data axis (norms, the embedding) stay whole on every rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

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


FSDP_AXES = ("data",)


class FsdpLeaf(NamedTuple):
    """How fsdp over ``p`` ranks holds one leaf: ``dim`` is the dim the
    reference's spec shards over the data axes (None: every rank holds
    the whole leaf), ``size`` its length, ``shard`` each rank's slice of
    it: the dim zero-padded to ``p * shard`` and rank r holding
    ``[r * shard, (r + 1) * shard)`` (the reference's tiling where p
    divides the dim)."""
    dim: Optional[int]
    size: int
    shard: int
    p: int

    def rank_range(self, r: int) -> tuple[int, int]:
        """Rank r's [start, stop) of the padded dim."""
        return r * self.shard, (r + 1) * self.shard

    def pad(self, x: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """``x`` with the sharded dim (after ``lead`` leading axes)
        zero-padded to ``p * shard``."""
        dim = self.dim + lead
        pad = self.p * self.shard - x.shape[dim]
        if not pad:
            return x
        return torch.nn.functional.pad(
            x, [0, 0] * (x.dim() - 1 - dim) + [0, pad])

    def cut(self, full: torch.Tensor, ranks: Sequence[int]) -> torch.Tensor:
        """The ``ranks``' shards of a whole leaf, stacked (len(ranks),
        *shard shape); a replicated leaf comes back whole, no rank axis."""
        if self.dim is None:
            return full
        full = self.pad(full)
        return torch.stack([full.narrow(self.dim, r * self.shard, self.shard)
                            for r in ranks])

    def unpad(self, padded: torch.Tensor) -> torch.Tensor:
        """The leaf from its dim padded to ``p * shard`` (a view)."""
        if self.dim is None or padded.shape[self.dim] == self.size:
            return padded
        return padded.narrow(self.dim, 0, self.size)


def fsdp_layout(params_or_shapes, cfg: ModelConfig, p: int) -> dict:
    """Dict tree of :class:`FsdpLeaf` matching the params tree: each
    leaf's dim from ``param_specs(..., FSDP_AXES)`` (leaves need only
    ``.shape``). A pure function of the shapes, the config and p."""
    leaves, paths = tree_flatten(params_or_shapes)
    specs = tree_flatten(param_specs(params_or_shapes, cfg, FSDP_AXES))[0]
    out = []
    for leaf, spec in zip(leaves, specs):
        dims = [i for i, ax in enumerate(spec) if ax == FSDP_AXES]
        if not dims:
            out.append(FsdpLeaf(None, 0, 0, p))
            continue
        size = leaf.shape[dims[0]]
        out.append(FsdpLeaf(dims[0], size, -(-size // p), p))
    return tree_unflatten(paths, out)
