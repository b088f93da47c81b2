"""Sparse streams (paper §5.1) with fixed capacities.

A stream stores up to ``cap`` (index, value) pairs plus an explicit ``nnz``
count. Padding slots carry ``idx == SENTINEL`` (sorts after every valid
index) and ``val == 0`` (the neutral element of SUM, paper §5.2).

The paper's sparse->dense switch at delta = N*isize/(c+isize) is decided
from capacities, which are Python ints: they follow the same |H1|+|H2|
upper bound the paper uses at run time. ``nnz`` stays a tensor, so no
function here reads the device from the host.

Every function works on one stream (idx/val of shape (cap,), nnz 0-d) and
on a batch of streams with leading axes (idx/val (*lead, cap), nnz
(*lead,)), such as the ranks a process holds in the per-rank collectives.
:class:`RowStream` is the row-sparse form the serve-side activation
exchange ships: its entries are whole rows of a (T, d) buffer.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.comm.collectives import once_if_shared

# Largest int32; sorts after any valid index (valid indices < N < 2**31).
SENTINEL = 2**31 - 1

INDEX_BYTES = 4  # paper §8: an index is stored as a 32-bit unsigned int


class SparseStream(NamedTuple):
    """Fixed-capacity sparse vector: idx int32 (*lead, cap), val
    (*lead, cap), nnz int32 (*lead,)."""

    idx: torch.Tensor
    val: torch.Tensor
    nnz: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]


def empty(cap: int, dtype=torch.float32, device="cpu",
          lead: tuple = ()) -> SparseStream:
    return SparseStream(
        idx=torch.full(lead + (cap,), SENTINEL, dtype=torch.int32,
                       device=device),
        val=torch.zeros(lead + (cap,), dtype=dtype, device=device),
        nnz=torch.zeros(lead, dtype=torch.int32, device=device),
    )


def delta_threshold(n: int, isize: int = 4,
                    index_bytes: int = INDEX_BYTES) -> int:
    """Paper §5.1: sparse format wins while nnz <= delta = N*isize/(c+isize)."""
    return (n * isize) // (index_bytes + isize)


def _sort_by_index(idx: torch.Tensor, val: torch.Tensor):
    """Stable sort of (idx, val) pairs by idx along the last axis."""
    idx_s, order = torch.sort(idx, dim=-1, stable=True)
    return idx_s, torch.gather(val, -1, order)


def from_dense_topk(x: torch.Tensor, k: int) -> SparseStream:
    """Global (non-bucketed) top-|k| magnitude selection -> sorted stream.
    Ties go to the lower index (a stable descending sort)."""
    n = x.shape[-1]
    k = min(k, n)
    order = torch.sort(x.abs(), dim=-1, descending=True, stable=True).indices
    top = torch.sort(order[..., :k], dim=-1).values
    return SparseStream(
        idx=top.to(torch.int32),
        val=torch.gather(x, -1, top),
        nnz=torch.full(x.shape[:-1], k, dtype=torch.int32, device=x.device),
    )


def from_mask(x: torch.Tensor, mask: torch.Tensor, cap: int) -> SparseStream:
    """Compact masked entries of ``x`` into a sorted stream of capacity cap.

    Entries where mask is False are dropped. If popcount(mask) > cap the
    largest-index extras are dropped (callers size cap so this cannot occur).
    """
    n = x.shape[-1]
    ar = torch.arange(n, dtype=torch.int32, device=x.device)
    idx = torch.where(mask, ar, SENTINEL)
    val = torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))
    # Stable sort: padding (SENTINEL) moves to the back.
    idx_s, val_s = _sort_by_index(idx, val)
    nnz = torch.clamp(mask.sum(-1, dtype=torch.int32), max=cap)
    return SparseStream(idx_s[..., :cap], val_s[..., :cap], nnz)


def scatter_add_drop_(ext: torch.Tensor, idx: torch.Tensor,
                      val: torch.Tensor, n: int) -> torch.Tensor:
    """In place: ``ext[..., idx] += val`` along the last axis for indices
    in [0, n); the rest (SENTINEL padding, out of range) are dropped, as
    JAX's ``.at[].add(mode="drop")`` drops them. ``ext`` holds n columns
    and a spill area of at least idx.shape[-1] more: each dropped entry
    lands in a spill slot of its own, so no two adds meet there (a shared
    spill slot would serialize the device's atomic adds). Returns ext.

    Equal valid indices add in the device's order; every caller on the
    collective paths passes unique valid indices, where the result is the
    same on every device."""
    m = idx.shape[-1]
    if ext.shape[-1] < n + m:
        raise ValueError(f"spill area {ext.shape[-1] - n} < {m} entries")
    i = idx.to(torch.int64)
    spill = torch.arange(n, n + m, device=i.device)
    i = torch.where((i >= 0) & (i < n), i, spill)
    return ext.scatter_add_(-1, i, val.to(ext.dtype))


def scatter_add_drop(out: torch.Tensor, idx: torch.Tensor,
                     val: torch.Tensor) -> torch.Tensor:
    """``out[..., idx] += val`` with out-of-range indices dropped, as a new
    tensor (see :func:`scatter_add_drop_`)."""
    n = out.shape[-1]
    ext = torch.cat([out, out.new_zeros(out.shape[:-1] + (idx.shape[-1],))],
                    dim=-1)
    return scatter_add_drop_(ext, idx, val, n)[..., :n]


def densify(s: SparseStream, n: int) -> torch.Tensor:
    """Scatter-add the stream into a dense length-n vector (*lead, n).

    Padding (idx == SENTINEL) is out of bounds and dropped. A stream
    broadcast over its leading axis (stride 0, as the stacked collectives
    return the result of an all_gather) is densified once and the result
    broadcast the same way: every rank reads the same values, and none
    writes into them. The ``bucket_scatter`` kernel is the variant for
    bucket-uniform streams; this is the general path."""
    def scatter(idx, val):
        ext = torch.zeros(idx.shape[:-1] + (n + idx.shape[-1],),
                          dtype=val.dtype, device=val.device)
        return scatter_add_drop_(ext, idx, val, n)[..., :n]

    if s.idx.dim() > 1:
        return once_if_shared(scatter, s.idx, s.val)
    return scatter(s.idx, s.val)


def _flat_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last axis run as ONE scan over the
    flattened tensor, returned in x's shape: the running total carries
    over from row to row, so callers take differences within a row. On
    CUDA a scan of a 1-D tensor is a device-wide scan, where a scan along
    the last axis of a few long rows runs one thread block a row."""
    return torch.cumsum(x.reshape(-1), 0).view(x.shape)


def merge(a: SparseStream, b: SparseStream, cap_out: int,
          run_bound: int = 2) -> SparseStream:
    """Sum two streams ("efficient summation", paper §5.1).

    concat -> stable sort by index -> combine duplicate indices -> compact
    to cap_out. Each run of equal indices is summed left to right in the
    sorted order, starting from zero, as the reference's scatter-add does
    on the CPU: pass j adds the run's j-th entry to the sum of the ones
    before it, all runs at once, so the result is the same on every
    device. A run is at most ``run_bound`` long when the inputs' indices
    come from that many duplicate-free streams (2 for two such streams, P
    for the P sources of the split phase); the entries of a longer run
    past ``run_bound`` are added through a float64 prefix sum, in another
    order. Runs are found with one integer prefix sum and ``searchsorted``
    and compacted with gathers: no scatter, no scan along a long row.
    """
    idx = torch.cat([a.idx, b.idx], dim=-1)
    val = torch.cat([a.val, b.val], dim=-1)
    lead = idx.shape[:-1]
    m = idx.shape[-1]
    if m == 0:
        return empty(cap_out, val.dtype, val.device, lead)
    idx, val = _sort_by_index(idx, val)
    dev = idx.device
    edge = torch.full(lead + (1,), -1, dtype=idx.dtype, device=dev)
    head = idx != torch.cat([edge, idx[..., :-1]], dim=-1)
    cs = _flat_cumsum(head.to(torch.int64))
    pos = cs - cs[..., :1]                               # group id, sorted
    nq = max(m, cap_out) + 1
    groups = torch.arange(nq, device=dev).expand(lead + (nq,)).contiguous()
    first = torch.searchsorted(pos, groups)              # group starts
    start = torch.gather(first, -1, pos)                 # each entry's run
    ar = torch.arange(m, device=dev).expand(lead + (m,))
    offset = ar - start                                  # position in it
    acc = val + torch.zeros((), dtype=val.dtype, device=dev)  # 0 + v0
    for j in range(1, min(run_bound, m)):
        prev = torch.cat([acc[..., :1], acc[..., :-1]], dim=-1)
        acc = torch.where(offset == j, prev + val, acc)
    if run_bound < m:
        rest = _flat_cumsum(torch.where(offset >= run_bound,
                                        val.to(torch.float64), 0.0))
        within = torch.gather(acc, -1, torch.minimum(ar, start + run_bound - 1))
        acc = within + (rest - torch.gather(rest, -1, start)).to(val.dtype)
    nvalid = (head & (idx != SENTINEL)).sum(-1, keepdim=True)
    live = groups[..., :cap_out] < nvalid
    out_idx = torch.gather(idx, -1, first[..., :cap_out].clamp(max=m - 1))
    last = (first[..., 1:cap_out + 1] - 1).clamp(min=0, max=m - 1)
    out_val = torch.gather(acc, -1, last)
    zero = torch.zeros((), dtype=val.dtype, device=dev)
    return SparseStream(torch.where(live, out_idx, SENTINEL),
                        torch.where(live, out_val, zero),
                        torch.clamp(nvalid[..., 0], max=cap_out).to(
                            torch.int32))


def concat(streams: list, cap_out: int | None = None) -> SparseStream:
    """Concatenate streams with *disjoint* index ranges (paper §5.1: the sum
    of dimension-partitioned vectors is plain concatenation).

    A ``cap_out`` below the true union size keeps the cap_out smallest
    indices (the sort moves padding behind every valid entry) and the
    ``nnz`` count saturates at the capacity, the same overflow contract as
    :func:`merge`."""
    idx = torch.cat([s.idx for s in streams], dim=-1)
    val = torch.cat([s.val for s in streams], dim=-1)
    nnz = streams[0].nnz.to(torch.int32)
    for s in streams[1:]:
        nnz = nnz + s.nnz
    if cap_out is not None and cap_out != idx.shape[-1]:
        idx, val = _sort_by_index(idx, val)
        idx, val = idx[..., :cap_out], val[..., :cap_out]
        nnz = torch.clamp(nnz, max=cap_out)
    return SparseStream(idx, val, nnz.to(torch.int32))


def pad_to(s: SparseStream, cap: int) -> SparseStream:
    """Grow capacity (padding stays at the back because streams are sorted)."""
    if cap == s.capacity:
        return s
    if cap < s.capacity:
        raise ValueError(f"cannot shrink stream {s.capacity} -> {cap}")
    lead = s.idx.shape[:-1]
    extra = cap - s.capacity
    return SparseStream(
        idx=torch.cat([s.idx, torch.full(lead + (extra,), SENTINEL,
                                         dtype=torch.int32,
                                         device=s.idx.device)], dim=-1),
        val=torch.cat([s.val, s.val.new_zeros(lead + (extra,))], dim=-1),
        nnz=s.nnz,
    )


class RowStream(NamedTuple):
    """Fixed-capacity ROW-sparse matrix: up to ``cap`` (row index, row
    vector) pairs of a (T, d) buffer, idx int32 (*lead, cap), val
    (*lead, cap, d), nnz int32 (*lead,). The serve-side activation
    exchange (DESIGN.md §8) ships whole token rows, because MoE combine
    partials are row-sparse: a token row is nonzero only where the token
    routed to a local expert. Padding rows carry ``idx == SENTINEL`` and
    all-zero vectors."""

    idx: torch.Tensor
    val: torch.Tensor
    nnz: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]


def from_row_mask(x: torch.Tensor, mask: torch.Tensor, cap: int
                  ) -> RowStream:
    """Compact the masked ROWS of ``x`` (*lead, T, d) into a RowStream,
    index-ascending; ``mask`` is (*lead, T).

    Rows where mask is False are dropped, and so are the rows above the
    ``cap`` lowest masked ones (``nnz`` saturates at cap). Exactness
    contract: when popcount(mask) <= cap AND every unmasked row of ``x``
    is all-zero, ``densify_rows`` inverts this bit for bit (the serve
    engine's occupancy guard enforces the capacity side)."""
    t = x.shape[-2]
    ar = torch.arange(t, dtype=torch.int32, device=x.device)
    idx = torch.where(mask, ar, SENTINEL)
    idx_s, order = torch.sort(idx, dim=-1, stable=True)
    idx_s, order = idx_s[..., :cap], order[..., :cap]
    rows = torch.gather(x, -2, order[..., None].expand(
        order.shape + (x.shape[-1],)))
    val = torch.where((idx_s != SENTINEL)[..., None], rows,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    nnz = torch.clamp(mask.sum(-1, dtype=torch.int32), max=cap)
    return RowStream(idx_s, val, nnz)


def densify_rows(s: RowStream, t: int) -> torch.Tensor:
    """Scatter the row stream back into a dense (*lead, t, d) buffer.
    Padding rows (idx == SENTINEL) and any index outside [0, t) are
    dropped; valid row indices are unique within a stream, so the
    scatter-add is a set. A stream broadcast over its leading axis (as the
    stacked collectives' all_gather returns it) is densified once."""
    def scatter(idx, val):
        m, d = idx.shape[-1], val.shape[-1]
        i = idx.to(torch.int64)
        spill = torch.arange(t, t + m, device=i.device)
        i = torch.where((i >= 0) & (i < t), i, spill)
        ext = torch.zeros(idx.shape[:-1] + (t + m, d), dtype=val.dtype,
                          device=val.device)
        ext.scatter_add_(-2, i[..., None].expand(i.shape + (d,)), val)
        return ext[..., :t, :]

    if s.idx.dim() > 1:
        return once_if_shared(scatter, s.idx, s.val)
    return scatter(s.idx, s.val)


def round_up_pow2(x: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, x))))
