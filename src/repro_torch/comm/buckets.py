"""Canonical layout + leaf<->fusion-bucket packing.

Canonical layout: the 'model'-sharded axis of a leaf is moved to the
front so the (m, B) bucket reshape never crosses a shard boundary.
Leaves without a model-sharded axis canonicalize to a single row.

A spec is a tuple of axis names (None or 'model', or a tuple of names),
one entry per leading dim of the leaf; only which entry names 'model'
matters here.

Fusion packing: all leaves of a plan *group* (same canonical row count)
are concatenated along the column axis into one fused buffer, padded at
the tail to the plan's bucket quantum. Packing and unpacking are pure
reshapes, concatenations and slices.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import math

import torch
import torch.nn.functional as F

if TYPE_CHECKING:
    from repro_torch.comm.plan import GroupSpec


# --------------------------------------------------------------------------
# Canonical layout (model-sharded axis first, trailing dims bucket-padded)
# --------------------------------------------------------------------------

def model_axis(spec) -> int | None:
    """Index of the dim sharded over 'model' in a spec, if any."""
    if spec is None:
        return None
    for i, s in enumerate(spec):
        names = s if isinstance(s, tuple) else (s,)
        if "model" in names:
            return i
    return None


def canonical_shape(shape: tuple[int, ...], spec, bucket_size: int
                    ) -> tuple[int, int]:
    """(rows, padded_cols) of the canonical 2-D layout for a leaf."""
    ax = model_axis(spec)
    if ax is None or len(shape) <= 1:
        lead, rest = 1, math.prod(shape)
    else:
        lead = shape[ax]
        rest = math.prod(shape) // lead
    cols = -(-rest // bucket_size) * bucket_size
    return lead, cols


def to_canonical(g: torch.Tensor, spec, bucket_size: int,
                 batch_dims: int = 0) -> torch.Tensor:
    """Leaf -> (rows, cols). ``batch_dims`` leading dims (the stacked
    replica axis) are kept in front: (*batch, rows, cols)."""
    lead = tuple(g.shape[:batch_dims])
    shape = tuple(g.shape[batch_dims:])
    rows, cols = canonical_shape(shape, spec, bucket_size)
    ax = model_axis(spec)
    if ax is not None and len(shape) > 1 and ax != 0:
        g = torch.movedim(g, batch_dims + ax, batch_dims)
    g2 = g.reshape(*lead, rows, -1)
    pad = cols - g2.shape[-1]
    if pad:
        g2 = F.pad(g2, (0, pad))
    return g2


def from_canonical(c: torch.Tensor, orig_shape: tuple[int, ...], spec
                   ) -> torch.Tensor:
    ax = model_axis(spec)
    if ax is None or len(orig_shape) <= 1:
        n = math.prod(orig_shape)
        return c.reshape(-1)[:n].reshape(orig_shape)
    moved = (orig_shape[ax],) + tuple(
        s for i, s in enumerate(orig_shape) if i != ax)
    rest = math.prod(moved[1:])
    out = c[:, :rest].reshape(moved)
    return torch.movedim(out, 0, ax)


# --------------------------------------------------------------------------
# Group pack / unpack
# --------------------------------------------------------------------------

def pack_group(group: "GroupSpec", leaves: Sequence[torch.Tensor],
               bucket_size: int, dtype=torch.float32,
               batch_dims: int = 0) -> torch.Tensor:
    """Fuse a group's leaves into one canonical (*batch, rows, group.cols)
    buffer. Column offsets follow ``group.slots``; the tail past the last
    slot is zero padding up to the bucket quantum."""
    segs = [
        to_canonical(leaves[slot.leaf_id], slot.spec, bucket_size,
                     batch_dims=batch_dims).to(dtype)
        for slot in group.slots
    ]
    buf = segs[0] if len(segs) == 1 else torch.cat(segs, dim=-1)
    pad = group.cols - buf.shape[-1]
    if pad:
        buf = F.pad(buf, (0, pad))
    return buf


def unpack_group(group: "GroupSpec", buf: torch.Tensor,
                 leaves: Sequence[torch.Tensor]
                 ) -> list[tuple[int, torch.Tensor]]:
    """Split a reduced group buffer back into (leaf_id, leaf-shaped tensor)
    pairs, cast to each leaf's dtype."""
    out = []
    for slot in group.slots:
        seg = buf[:, slot.offset:slot.offset + slot.cols]
        leaf = leaves[slot.leaf_id]
        out.append((slot.leaf_id,
                    from_canonical(seg, slot.shape, slot.spec).to(leaf.dtype)))
    return out
