"""Collectives over one data-parallel axis, for code written per rank.

The algorithms of ``core/allreduce.py`` and the per-rank executor talk to
other ranks only through a :class:`CollectiveContext`. Every per-rank
tensor carries a leading axis of the ranks this process holds, ``L``; the
primitives follow ``jax.lax`` inside ``shard_map`` over that axis:

* ``axis_rank()``      — (L,) int64, each held rank's index on the axis;
* ``psum(x)``          — every rank gets the sum over the axis;
* ``psum_scatter(x, axis)`` — tiled reduce-scatter: ``axis`` splits
  into p chunks and rank j gets chunk j of the sum
  (``jax.lax.psum_scatter(..., tiled=True)``);
* ``all_gather(x, axis)`` — tiled: the p ranks' tensors concatenated
  along ``axis`` (an axis of the per-rank shape, the ``L`` axis not
  counted), every rank gets the result;
* ``all_to_all(x, axis)`` — tiled: ``axis`` splits into p chunks, chunk j
  goes to rank j, and the received chunks concatenate along ``axis`` in
  source order (``jax.lax.all_to_all(..., tiled=True)``);
* ``ppermute(x, perm)`` — ``perm`` lists (source, destination) pairs; a
  rank that is no destination gets zeros.

Two implementations:

* :class:`StackedCollectives` — all ranks on one device: the leading
  axis holds every rank (``L = outer * p * inner``, laid out as
  (outer, p, inner) with the collective over the middle factor, so a
  data axis and a pod axis of one rank grid can both be expressed), and
  each primitive is an index operation over that axis;
* :class:`ProcessGroupCollectives` — one rank a process (``L = 1``) over
  ``torch.distributed``: gloo on the CPU, NCCL with one card a process.

Both hold their tensors on the card unless the caller passes
``device="cpu"`` (and raise without CUDA otherwise). Sums over ranks run
in rank order (rank 0 first) in both, so the two give the same bits, and
so do repeated runs. The JAX package's psum-only
emulation of these primitives (``native=False``) works around an XLA-CPU
partitioner fault that PyTorch does not have and is not ported.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def ordered_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in index order, ((x0 + x1) + x2) + ...: a fixed
    order on every device and for every shape of the other axes (a
    library reduction may split the axis into partial sums)."""
    parts = x.unbind(dim)
    acc = parts[0].clone()
    for t in parts[1:]:
        acc += t
    return acc


def once_if_shared(fn, *xs: torch.Tensor) -> torch.Tensor:
    """fn(*xs) for tensors with a leading rank axis. When every input is
    one tensor broadcast over that axis (stride 0, as
    :class:`StackedCollectives` returns the results every rank reads
    alike), fn runs once and its result is broadcast the same way: each
    rank would compute the same values, and no caller writes into them."""
    if all(x.dim() > 0 and x.shape[0] > 1 and x.stride(0) == 0 for x in xs):
        one = fn(*(x[:1] for x in xs))
        return one.expand((xs[0].shape[0],) + one.shape[1:])
    return fn(*xs)


class CollectiveContext:
    """How the ranks of one axis talk (the interface; see the module)."""

    p: int
    local_ranks: int
    device: torch.device

    def axis_rank(self) -> torch.Tensor:
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def psum_scatter(self, x: torch.Tensor, *, axis: int) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor, *, axis: int) -> torch.Tensor:
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor, *, axis: int) -> torch.Tensor:
        raise NotImplementedError

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        raise NotImplementedError


class StackedCollectives(CollectiveContext):
    """All ranks stacked on a leading axis of one device's tensors.

    ``outer`` and ``inner`` are the other factors of a rank grid: the
    leading axis is (outer, p, inner) flattened and the collective runs
    over p, independently for each (outer, inner) pair. A data axis of a
    (pod, data) grid is ``outer = p_pod``; its pod axis is
    ``inner = p_data``.

    Results every rank reads alike (psum, all_gather) are one tensor
    broadcast with ``expand`` over the rank axis, never copied. That is
    safe because no caller writes into a collective's result: the
    algorithms are functional, and PyTorch refuses an in-place write into
    a tensor whose elements share memory."""

    def __init__(self, p: int, device="cuda", *, outer: int = 1,
                 inner: int = 1):
        self.p, self.outer, self.inner = p, outer, inner
        self.device = resolve_device(device)
        self.local_ranks = outer * p * inner
        self._perms: dict = {}     # source map -> its index tensor, made once

    def _grid(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.local_ranks:
            raise ValueError(f"leading axis {x.shape[0]}, the context holds "
                             f"{self.local_ranks} ranks")
        return x.reshape((self.outer, self.p, self.inner) + x.shape[1:])

    def _flat(self, g: torch.Tensor) -> torch.Tensor:
        return g.reshape((self.local_ranks,) + g.shape[3:])

    def axis_rank(self) -> torch.Tensor:
        r = torch.arange(self.p, device=self.device)
        return r[None, :, None].expand(self.outer, self.p,
                                       self.inner).reshape(-1)

    def _broadcast(self, one: torch.Tensor) -> torch.Tensor:
        """(outer, inner, *s) -> (L, *s), the same for every rank of p."""
        g = one.unsqueeze(1).expand((self.outer, self.p) + one.shape[1:])
        return self._flat(g)     # a view (stride 0) when outer = inner = 1

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._broadcast(ordered_sum(self._grid(x), 1))

    def psum_scatter(self, x: torch.Tensor, *, axis: int) -> torch.Tensor:
        total = ordered_sum(self._grid(x), 1)    # (o, i, *s)
        a = axis + 2
        n = total.shape[a]
        if n % self.p:
            raise ValueError(f"psum_scatter: axis {axis} of {n} does not "
                             f"split into {self.p}")
        s = total.reshape(total.shape[:a] + (self.p, n // self.p)
                          + total.shape[a + 1:])
        # chunk j of the sum goes to rank j: the chunk axis becomes the
        # rank axis of the (o, p, i) grid
        return self._flat(s.movedim(a, 1).contiguous())

    def all_gather(self, x: torch.Tensor, *, axis: int) -> torch.Tensor:
        g = self._grid(x)                        # (o, p, i, *s)
        a = axis + 2                             # the axis in (o, i, *s)
        parts = g.unbind(1)                      # p x (o, i, *s)
        return self._broadcast(torch.cat(parts, dim=a))

    def all_to_all(self, x: torch.Tensor, *, axis: int) -> torch.Tensor:
        g = self._grid(x)                        # (o, src, i, *s)
        a = axis + 3
        n = g.shape[a]
        if n % self.p:
            raise ValueError(f"all_to_all: axis {axis} of {n} does not split "
                             f"into {self.p}")
        s = g.reshape(g.shape[:a] + (self.p, n // self.p) + g.shape[a + 1:])
        # element [o, src, i, ..., dst, c, ...] goes to rank dst, source slot
        # src: swap the two rank axes
        t = s.transpose(1, a).contiguous()      # (o, dst, i, ..., src, c, ..)
        return self._flat(t.reshape(g.shape))

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        src_of = [-1] * self.p
        for s, d in perm:
            src_of[d] = s
        g = self._grid(x)
        if all(s >= 0 for s in src_of):
            key = (tuple(src_of), x.device)
            if key not in self._perms:      # a host->device copy, made once
                self._perms[key] = torch.tensor(src_of, device=x.device)
            return self._flat(g.index_select(1, self._perms[key]))
        out = torch.zeros_like(g)
        for d, s in enumerate(src_of):
            if s >= 0:
                out[:, d] = g[:, s]
        return self._flat(out)


# Unsigned types the process-group backends do not carry: they travel as
# the signed type of the same width (a view, the bytes unchanged).
_WIRE_TYPES = {torch.uint16: torch.int16, torch.uint32: torch.int32,
               torch.uint64: torch.int64}


class ProcessGroupCollectives(CollectiveContext):
    """One rank a process over a ``torch.distributed`` group (``L = 1``).

    ``psum`` of an integer tensor is one ``all_reduce`` (exact in any
    order). A floating-point ``psum`` is a reduce-scatter through
    ``all_to_all_single`` with each owner summing its chunk in rank
    order, then an ``all_gather``: the bytes of a bandwidth-optimal
    allreduce, and the same bits as :class:`StackedCollectives`, where a
    library ``all_reduce`` would sum in an order of its own choosing."""

    local_ranks = 1

    def __init__(self, group=None, device="cuda"):
        self.group = group
        self.device = resolve_device(device)
        self.p = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _global(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def axis_rank(self) -> torch.Tensor:
        return torch.tensor([self.rank], device=self.device)

    def _one(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != 1:
            raise ValueError(f"leading axis {x.shape[0]}: a process holds one "
                             "rank")
        return x[0].contiguous()

    def all_gather(self, x: torch.Tensor, *, axis: int) -> torch.Tensor:
        if x.dtype in _WIRE_TYPES:
            return self.all_gather(x.view(_WIRE_TYPES[x.dtype]),
                                   axis=axis).view(x.dtype)
        y = self._one(x)
        parts = [torch.empty_like(y) for _ in range(self.p)]
        dist.all_gather(parts, y, group=self.group)
        return torch.cat(parts, dim=axis)[None]

    def all_to_all(self, x: torch.Tensor, *, axis: int) -> torch.Tensor:
        if x.dtype in _WIRE_TYPES:
            return self.all_to_all(x.view(_WIRE_TYPES[x.dtype]),
                                   axis=axis).view(x.dtype)
        y = self._one(x)
        if y.shape[axis] % self.p:
            raise ValueError(f"all_to_all: axis {axis} of {y.shape[axis]} "
                             f"does not split into {self.p}")
        front = y.movedim(axis, 0).contiguous()
        recv = torch.empty_like(front)
        dist.all_to_all_single(recv, front, group=self.group)
        return recv.movedim(0, axis)[None]

    def psum_scatter(self, x: torch.Tensor, *, axis: int) -> torch.Tensor:
        """The reduce-scatter half of :meth:`psum`: ``all_to_all_single``
        hands each owner every rank's copy of its chunk and the owner sums
        them in rank order. The bytes of a reduce-scatter, and the bits of
        :class:`StackedCollectives`, where ``reduce_scatter_tensor`` would
        sum in an order of the library's choosing (and gloo has none)."""
        y = self._one(x)
        n = y.shape[axis]
        if n % self.p:
            raise ValueError(f"psum_scatter: axis {axis} of {n} does not "
                             f"split into {self.p}")
        chunks = y.reshape(y.shape[:axis] + (self.p, n // self.p)
                           + y.shape[axis + 1:]).movedim(axis, 0).contiguous()
        recv = torch.empty_like(chunks)
        dist.all_to_all_single(recv, chunks, group=self.group)
        return ordered_sum(recv, 0)[None]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        y = self._one(x)
        if not y.is_floating_point():
            y = y.clone()
            dist.all_reduce(y, group=self.group)
            return y[None]
        flat = y.reshape(-1)
        n = flat.numel()
        c = -(-n // self.p)
        flat = torch.nn.functional.pad(flat, (0, c * self.p - n))
        recv = torch.empty_like(flat)
        dist.all_to_all_single(recv, flat, group=self.group)
        mine = ordered_sum(recv.reshape(self.p, c), 0)
        parts = [torch.empty_like(mine) for _ in range(self.p)]
        dist.all_gather(parts, mine, group=self.group)
        return torch.cat(parts)[:n].reshape(y.shape)[None]

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        if x.dtype in _WIRE_TYPES:
            return self.ppermute(x.view(_WIRE_TYPES[x.dtype]),
                                 perm).view(x.dtype)
        y = self._one(x)
        out = torch.zeros_like(y)
        ops = []
        for s, d in perm:
            if s == self.rank:
                ops.append(dist.P2POp(dist.isend, y, self._global(d),
                                      self.group))
            if d == self.rank:
                ops.append(dist.P2POp(dist.irecv, out, self._global(s),
                                      self.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return out[None]
