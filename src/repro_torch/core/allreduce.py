"""SparCML sparse allreduce algorithms (paper §5.3), written per rank.

Every ``*_inside`` function is the code one rank runs; it talks to the
other ranks only through a :class:`~repro_torch.comm.collectives.
CollectiveContext` (``coll``), and every tensor carries the leading axis
of the ranks the process holds (``L``: all p of them stacked on one
device, or one over ``torch.distributed``). The JAX package runs the same
functions inside ``shard_map`` over a named mesh axis.

Algorithms:

  ssar_recursive_double   log2(P) rounds of XOR-partner ppermute + sparse
                          merge; capacity doubles per round following the
                          paper's |H1|+|H2| bound; switches to a dense
                          tail when the bound crosses the delta threshold.
  ssar_split_allgather    all_to_all split by index range (sparse
                          reduce-scatter), local merge, sparse allgather
                          (concatenation: the ranges are disjoint).
  dsar_split_allgather    split phase as above, then DENSIFY the owned
                          range and sum its sources (bucket_scatter_sum
                          kernel) and run a dense allgather, optionally
                          QSGD-quantized (paper §6: qsgd_pack /
                          qsgd_unpack kernels).
  ssar_balanced_split     Ok-Top-k-style balanced split-and-gather: owner-
                          local re-top-k to (k/P)(1+eps) items, allgather
                          at that fixed capacity; the clamped-off mass
                          returns as an error-feedback fold.
  ssar_rearranged_rs      SparDL-style rearranged reduce-scatter: log2(P)
                          recursive-halving rounds in stream form and a
                          capacity-clamped allgather; every clamp drop
                          folds into the error-feedback residual.
  dense                   psum (the NCCL/MPI baseline).

The bucket-uniform streams (k entries per 512-bucket, paper §8.3) route
the split phase with pure reshapes: no sorting, exact slot sizes.
Capacities are Python ints, nnz counts stay on the device, and sums over
ranks run in rank order, so a run is reproducible bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.comm.collectives import CollectiveContext, once_if_shared
from repro_torch.core import sparse_stream as ss
from repro_torch.core.cost_model import (AUTO_NOT_CALIBRATED,
                                         balanced_shard_cap,
                                         rearranged_round_caps)
from repro_torch.core.qsgd import QSGDConfig, dequantize, quantize
from repro_torch.core.sparse_stream import SENTINEL, SparseStream
from repro_torch.core.topk import UniformStream
from repro_torch.kernels.bucket_scatter.ops import bucket_scatter_sum
from repro_torch.kernels.bucket_topk.ops import check_bucket_size
from repro_torch.kernels.qsgd_pack.ops import qsgd_pack
from repro_torch.kernels.qsgd_unpack.ref import UnpackSegment


@dataclass(frozen=True)
class ReduceOut:
    """Exactly one of (stream, dense) is set, decided by capacities."""

    stream: Optional[SparseStream] = None
    dense: Optional[torch.Tensor] = None

    def to_dense(self, n: int) -> torch.Tensor:
        if self.dense is not None:
            return self.dense
        return ss.densify(self.stream, n)


def _xor_perm(p: int, dist: int) -> list[tuple[int, int]]:
    return [(i, i ^ dist) for i in range(p)]


def _exchange(stream: SparseStream, coll: CollectiveContext,
              perm) -> SparseStream:
    return SparseStream(coll.ppermute(stream.idx, perm),
                        coll.ppermute(stream.val, perm),
                        coll.ppermute(stream.nnz, perm))


# --------------------------------------------------------------------------
# SSAR_Recursive_double (paper §5.3.1)
# --------------------------------------------------------------------------

def ssar_recursive_double_inside(
    stream: SparseStream,
    *,
    coll: CollectiveContext,
    n: int,
    delta: int | None = None,
    cap_max: int | None = None,
) -> ReduceOut:
    """Recursive doubling over an axis of size p (power of two).

    Capacity schedule: after round t the fill-in bound is k*2^(t+1)
    (paper §5.1 uses the same |H1|+|H2| bound at run time). When the bound
    crosses ``delta`` the representation switches to dense for the
    remaining rounds (pairwise dense exchange + add keeps the partial-group
    sums right).
    """
    p = coll.p
    assert p & (p - 1) == 0, "P must be a power of two (paper assumption 2)"
    if delta is None:
        delta = ss.delta_threshold(n, stream.val.element_size())
    if cap_max is None:
        cap_max = min(n, delta)
    dense: torch.Tensor | None = None
    for t in range(int(math.log2(p))):
        perm = _xor_perm(p, 1 << t)
        if dense is not None:
            dense = dense + coll.ppermute(dense, perm)
            continue
        cap_next = min(2 * stream.capacity, cap_max)
        if 2 * stream.capacity > delta:
            # Dynamic fill-in: switch to dense (paper §5.3.3) for the tail.
            dense = ss.densify(stream, n)
            dense = dense + coll.ppermute(dense, perm)
            stream = None
            continue
        stream = ss.merge(stream, _exchange(stream, coll, perm), cap_next)
    return ReduceOut(stream=stream, dense=dense)


# --------------------------------------------------------------------------
# Split phase (shared by SSAR/DSAR _Split_allgather), uniform fast path
# --------------------------------------------------------------------------

def _split_uniform(u: UniformStream, coll: CollectiveContext):
    """Route bucket rows to their owning range via pure reshape + a2a.

    Range r owns bucket rows [r*nb/p, (r+1)*nb/p). Returns (lidx, val) of
    shape (L, p, nb/p, k): the contribution of every source rank to MY
    rows."""
    p = coll.p
    lead, nb, k = u.lidx.shape[0], u.lidx.shape[-2], u.lidx.shape[-1]
    assert nb % p == 0, f"buckets ({nb}) must divide by P ({p})"
    lidx = coll.all_to_all(u.lidx.reshape(lead, p, nb // p, k), axis=0)
    val = coll.all_to_all(u.val.reshape(lead, p, nb // p, k), axis=0)
    return lidx, val


def _reduce_range_dense(lidx, val, bucket_size: int,
                        impl: str = "auto") -> torch.Tensor:
    """Densify the received (L, p, rows, k) contributions into my range
    and sum the p sources in rank order, in one bucket_scatter_sum:
    (L, rows*B)."""
    lead, p, rows, k = lidx.shape
    return bucket_scatter_sum(lidx.contiguous(), val.contiguous(),
                              bucket_size, impl=impl).reshape(
                                  lead, rows * bucket_size)


# --------------------------------------------------------------------------
# SSAR_Split_allgather (paper §5.3.2)
# --------------------------------------------------------------------------

def ssar_split_allgather_inside(
    u: UniformStream,
    *,
    coll: CollectiveContext,
    range_cap: int | None = None,
) -> SparseStream:
    """Sparse reduce-scatter (split) + sparse allgather (concatenation).

    Returns a global SparseStream of capacity p * range_cap. Merging within
    the owned range uses the sort + combine path (a run of one index holds
    at most one entry a source); ranges are disjoint, so the allgather is
    plain concatenation (paper §5.1).
    """
    p = coll.p
    nb, k = u.lidx.shape[-2:]
    b = u.bucket_size
    lidx, val = _split_uniform(u, coll)
    lead, rows = lidx.shape[0], nb // p
    # Indices within my range, relative to the range start.
    row_off = torch.arange(rows, dtype=torch.int32,
                           device=lidx.device)[:, None] * b
    rel = (lidx + row_off).reshape(lead, -1)
    vals = val.reshape(lead, -1)
    local = SparseStream(rel, vals, torch.full((lead,), rel.shape[-1],
                                               dtype=torch.int32,
                                               device=rel.device))
    if range_cap is None:
        range_cap = min(p * rows * k, rows * b)
    merged = ss.merge(local, ss.empty(0, vals.dtype, vals.device, (lead,)),
                      range_cap, run_bound=p)
    # Rebase to the global index space: my range starts at rank*rows*b;
    # SENTINEL padding stays SENTINEL.
    base = (coll.axis_rank() * (rows * b)).to(torch.int32)[:, None]
    gidx = torch.where(merged.idx == SENTINEL, SENTINEL, merged.idx + base)
    # Sparse allgather = concatenation of disjoint ranges.
    return SparseStream(coll.all_gather(gidx, axis=0),
                        coll.all_gather(merged.val, axis=0),
                        coll.psum(merged.nnz))


# --------------------------------------------------------------------------
# Capacity-clamped portfolio. Both return (dense sum, fold): ``fold`` is
# the pre-scale mass this rank clamped off the wire, to be added into its
# error-feedback residual by the executor (the SparDL "global residual"
# rule). Under non-binding caps (e.g. full index overlap) fold == 0 and the
# result equals the dense reference.
# --------------------------------------------------------------------------

def _top_cap_indices(mag: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the ``cap`` largest magnitudes along the last axis, ties
    toward the lower index: a stable descending sort (``torch.topk``
    promises no order among ties), so every rank picks alike."""
    return torch.sort(mag, dim=-1, descending=True, stable=True).indices[
        ..., :cap]


def _take_top_stream(s: SparseStream, mask: torch.Tensor, cap: int):
    """Top-``cap``-|value| masked entries of ``s``, plus the clamped rest.

    Returns (kept stream of capacity ``cap`` sorted by index, (drop_idx,
    drop_val) SENTINEL-padded arrays of the masked entries past the cap).
    Magnitude ties break toward the lower index (streams are index-sorted
    and both sorts are stable), so every rank decides alike."""
    cap = min(cap, s.capacity)
    inf = torch.full((), float("inf"), dtype=s.val.dtype, device=s.val.device)
    neg = torch.where(mask, -s.val.abs(), inf)
    order = torch.sort(neg, dim=-1, stable=True).indices  # masked, big first
    idx_o = torch.gather(s.idx, -1, order)
    val_o = torch.gather(s.val, -1, order)
    m_o = torch.gather(mask, -1, order)
    zero = torch.zeros((), dtype=s.val.dtype, device=s.val.device)
    sel_i = torch.where(m_o[..., :cap], idx_o[..., :cap], SENTINEL)
    sel_v = torch.where(m_o[..., :cap], val_o[..., :cap], zero)
    sel_i, perm = torch.sort(sel_i, dim=-1, stable=True)
    sel_v = torch.gather(sel_v, -1, perm)
    nnz = torch.clamp(mask.sum(-1, dtype=torch.int32), max=cap)
    drop_i = torch.where(m_o[..., cap:], idx_o[..., cap:], SENTINEL)
    drop_v = torch.where(m_o[..., cap:], val_o[..., cap:], zero)
    return SparseStream(sel_i, sel_v, nnz), (drop_i, drop_v)


def _place_range(shard: torch.Tensor, rank: torch.Tensor, p: int):
    """(L, n/p) range of each held rank -> (L, n), zero outside it."""
    lead, w = shard.shape
    out = shard.new_zeros((lead, p, w))
    out.scatter_(1, rank.view(lead, 1, 1).expand(lead, 1, w),
                 shard.unsqueeze(1))
    return out.reshape(lead, p * w)


def ssar_balanced_split_inside(
    u: UniformStream,
    *,
    coll: CollectiveContext,
    impl: str = "auto",
    scatter: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Balanced split-and-gather (Ok-Top-k style).

    Split phase: the bucket-uniform a2a route (exactly balanced by
    construction). Owner phase: scatter-add the received contributions
    into my range (bucket_scatter_sum), then re-top-k to the
    ``balanced_shard_cap`` capacity. Gather phase: allgather the clamped
    (idx, val) shards, (P-1) * cap items instead of split_allgather's
    O(kP) worst-case range union. Returns (dense (L, n), fold (L, n)):
    fold carries my range's clamped-off partial sums (zero when the cap
    does not bind).

    ``scatter`` stops at the owner shard: the gather phase is skipped and
    the return is (shard (L, n/p), fold (L, n))."""
    p = coll.p
    nb, k = u.lidx.shape[-2:]
    b = u.bucket_size
    n = nb * b
    lidx, val = _split_uniform(u, coll)
    shard = _reduce_range_dense(lidx, val, b, impl=impl)   # (L, n/p)
    range_n = shard.shape[-1]
    cap = min(balanced_shard_cap(nb * k, p, n), range_n)
    sel_idx = _top_cap_indices(shard.abs(), cap)
    sel_val = torch.gather(shard, -1, sel_idx)
    selected = torch.zeros_like(shard).scatter_(-1, sel_idx, sel_val)
    rank = coll.axis_rank()
    fold = _place_range(shard - selected, rank, p)
    if scatter:
        return selected, fold
    gidx = sel_idx.to(torch.int32) + (rank * range_n).to(torch.int32)[:, None]
    all_idx = coll.all_gather(gidx, axis=0)                 # (L, p*cap)
    all_val = coll.all_gather(sel_val, axis=0)
    dense = ss.densify(SparseStream(all_idx, all_val, None), n)
    return dense, fold


def ssar_rearranged_rs_inside(
    u: UniformStream,
    *,
    coll: CollectiveContext,
    scatter: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rearranged reduce-scatter + allgather (SparDL style).

    log2(P) recursive-halving rounds: each round partitions my current
    index range at its midpoint, ships the partner's half as a stream
    (ppermute), and merges the received half, in stream form end to end.
    Capacities follow ``rearranged_round_caps``; entries past a send/merge
    cap are the smallest-magnitude ones and are accumulated into ``fold``
    at their global coordinate (the global-residual rule) instead of being
    lost. Final phase: allgather of the disjoint owned shards. Returns
    (dense (L, n), fold (L, n)).

    ``scatter``: the MSB-first halving ends rank r holding exactly the
    owned range [r*n/p, (r+1)*n/p); the final allgather is skipped and the
    return is (shard (L, n/p), fold (L, n))."""
    p = coll.p
    assert p & (p - 1) == 0, "P must be a power of two (paper assumption 2)"
    nb, kpb = u.lidx.shape[-2:]
    n = u.n
    caps = rearranged_round_caps(nb * kpb, n, p)
    s = u.to_stream()
    lead = s.idx.shape[0]
    my_rank = coll.axis_rank()
    # the fold, with a spill area for the dropped arrays' padding: no drop
    # array is wider than a stream plus what it receives, 2 * nb * kpb
    fold = s.val.new_zeros((lead, n + 2 * nb * kpb))
    lo = torch.zeros((lead, 1), dtype=torch.int64, device=s.idx.device)
    length = n
    zero = torch.zeros((), dtype=s.val.dtype, device=s.val.device)
    for t, (send_cap, merged_cap) in enumerate(caps):
        dist = p >> (t + 1)
        half = length // 2
        mid = lo + half
        keep_lower = ((my_rank & dist) == 0)[:, None]   # MSB-first: rank r
        valid = s.idx != SENTINEL                        # ends owning
        in_lower = s.idx < mid                           # [r*n/p, (r+1)*n/p)
        send_mask = valid & (in_lower ^ keep_lower)
        keep_mask = valid & ~(in_lower ^ keep_lower)
        # The kept side stays at full capacity (no clamp, no drop): only
        # the wire and the merged result are capacity-bound.
        kept = SparseStream(torch.where(keep_mask, s.idx, SENTINEL),
                            torch.where(keep_mask, s.val, zero),
                            keep_mask.sum(-1, dtype=torch.int32))
        sent, (sd_i, sd_v) = _take_top_stream(s, send_mask, send_cap)
        ss.scatter_add_drop_(fold, sd_i, sd_v, n)
        recv = _exchange(sent, coll, _xor_perm(p, dist))
        merged = ss.merge(kept, recv, kept.capacity + recv.capacity)
        clamped, (md_i, md_v) = _take_top_stream(
            merged, merged.idx != SENTINEL, merged_cap)
        ss.scatter_add_drop_(fold, md_i, md_v, n)
        s = clamped
        lo = torch.where(keep_lower, lo, mid)
        length = half
    if scatter:
        # Owner-local densify at range-relative coordinates; SENTINEL
        # entries land far past n/p and drop. lo == my_rank * n/p here.
        shard = ss.scatter_add_drop(s.val.new_zeros((lead, n // p)),
                                    s.idx.to(torch.int64) - lo, s.val)
        return shard, fold[:, :n]
    # Owned ranges are disjoint: the allgather is plain concatenation and
    # the scatter-add places each shard at its global coordinates.
    all_idx = coll.all_gather(s.idx, axis=0)
    all_val = coll.all_gather(s.val, axis=0)
    return ss.densify(SparseStream(all_idx, all_val, None), n), fold[:, :n]


# --------------------------------------------------------------------------
# DSAR_Split_allgather (paper §5.3.3 + §6 low-precision second phase)
# --------------------------------------------------------------------------

def dsar_split_allgather_inside(
    u: UniformStream,
    *,
    coll: CollectiveContext,
    qsgd: QSGDConfig | None = None,
    rand: torch.Tensor | None = None,
    out_dtype=torch.float32,
    impl: str = "auto",
) -> torch.Tensor:
    """Split phase sparse, owned range densified, dense (optionally
    QSGD-quantized) allgather. Returns the dense global sum (L, n).
    ``rand``: each held rank's stochastic-rounding bits, (L, >= n/p) u32."""
    nb = u.lidx.shape[-2]
    b = u.bucket_size
    lidx, val = _split_uniform(u, coll)
    shard = _reduce_range_dense(lidx, val, b, impl=impl)  # (L, nb/p * b)
    if qsgd is None:
        return coll.all_gather(shard.to(out_dtype), axis=0)
    if rand is None:
        raise ValueError("QSGD second phase needs stochastic-rounding bits")
    lead, w = shard.shape
    packed, scale = quantize(shard, qsgd, rand.reshape(lead, -1)[:, :w],
                             impl=impl)
    packed_all = coll.all_gather(packed, axis=0)
    scale_all = coll.all_gather(scale, axis=0)
    return once_if_shared(lambda pk, sc: dequantize(pk, sc, qsgd, nb * b, out_dtype,
                                           impl=impl), packed_all, scale_all)


# --------------------------------------------------------------------------
# Batched DSAR: the leading canonical row axis rides through the data-axis
# collectives as a pure batch dim (the per-rank executor's rowed buckets).
# --------------------------------------------------------------------------

class PendingUnpack(NamedTuple):
    """A quantized DSAR gather whose dequantization the caller runs later,
    batched with the other buckets' into one ``qsgd_unpack_grouped``
    launch (``comm/executor.py``). ``segment`` holds the codes and scales
    as received: row-major, p_pod = 1, mean 1, its (rows, p*shard) output
    the (held, r, m*B) result of ``shape``. When the stacked ranks
    received one shared copy, held = 1 and :meth:`result` broadcasts it
    back to ``lead`` ranks."""

    segment: UnpackSegment
    shape: tuple
    lead: int

    def result(self, buf: torch.Tensor) -> torch.Tensor:
        out = buf.view(self.shape)
        if self.shape[0] == self.lead:
            return out
        return out.expand((self.lead,) + tuple(self.shape[1:]))


def dsar_split_allgather_batched_inside(
    u,  # BatchedStream: lidx/val (L, r, m, k)
    *,
    coll: CollectiveContext,
    qsgd: QSGDConfig | None = None,
    rand: torch.Tensor | None = None,
    impl: str = "auto",
    scatter: bool = False,
):
    """DSAR over the data axis with a batched row dim. Returns the (L, r,
    m*B) f32 sum, or, QSGD-quantized, the received codes as a
    :class:`PendingUnpack` that the caller dequantizes.

    ONE collective a phase:
      split: a single fused all_to_all on the bucket axis carrying
             [val | lidx-as-f32] (lidx < B <= 2^24 is exact in f32);
      densify my bucket range and sum the p sources (bucket_scatter_sum);
      gather: a single all_gather of [packed-as-f32 | scale] when
             QSGD-quantized (qsgd_pack), of the f32 shard otherwise.
    rand: each held rank's bits for its shard, (L, >= r*m*B/p) u32.

    ``scatter`` stops at the owner shard: the gather never runs, and the
    result is my (L, r, m*B/p) columns. QSGD-quantized, my shard still
    makes the round trip (pack with my bits, then the deferred unpack of
    my own codes), so it is bit-equal to the replicated result's own
    columns."""
    p = coll.p
    lead, r, m, k = u.lidx.shape
    b = u.bucket_size
    assert m % p == 0, f"buckets-per-row {m} % p {p}"
    mp = m // p
    shard_cols = mp * b
    assert b <= 1 << 24, "lidx-as-f32 wire format needs exact f32 ints"
    payload = torch.cat([u.val.to(torch.float32), u.lidx.to(torch.float32)],
                        dim=-1)
    payload = coll.all_to_all(payload, axis=1)               # ONE a2a
    # received (L, r, p, m/p, 2k): as (L*r, p, m/p) every source's rows of
    # my range, sources in rank order, for one densify + sum
    payload = payload.reshape(lead * r, p, mp, 2 * k)
    val = payload[..., :k].contiguous()          # the kernels take
    lidx = payload[..., k:].to(torch.int32).contiguous()   # contiguous ones
    shard = bucket_scatter_sum(lidx, val, b, impl=impl).reshape(
        lead, r, shard_cols)
    if qsgd is None:
        shard = shard.to(torch.float32)
        return shard if scatter else coll.all_gather(shard, axis=1)
    if rand is None:
        raise ValueError("QSGD second phase needs stochastic-rounding bits")
    bq = qsgd.bucket_size
    nbq = shard_cols // bq
    packed, scale = qsgd_pack(
        shard.reshape(-1, bq),
        rand.reshape(lead, -1)[:, :r * nbq * bq].reshape(-1, bq).contiguous(),
        qsgd.bits, qsgd.scale_mode, impl=impl)
    if scatter:
        # my codes, row-major (held, r, shard): unpacked in place
        seg = UnpackSegment(packed, scale, 1, 1, lead * r, shard_cols, bq,
                            1.0, row_major=True)
        return PendingUnpack(seg, (lead, r, shard_cols), lead)
    w = packed.shape[-1]
    # ONE gather: [packed u32 bitcast to f32 | scale f32] along the rows'
    # columns
    wire = torch.cat([packed.view(torch.float32).reshape(lead, r, nbq * w),
                      scale.reshape(lead, r, nbq)], dim=2)
    wire = coll.all_gather(wire, axis=1).reshape(lead, r, p, nbq * w + nbq)
    if lead > 1 and wire.stride(0) == 0:
        wire = wire[:1]          # the stacked ranks share one copy
    held = wire.shape[0]
    # received order is (held, r, p, shard): the (r, m*B) layout as it is
    packed_all = wire[..., :nbq * w].contiguous().view(torch.uint32)
    scale_all = wire[..., nbq * w:].contiguous()
    seg = UnpackSegment(packed_all.reshape(-1, w), scale_all.reshape(-1, 1),
                        1, p, held * r, shard_cols, bq, 1.0, row_major=True)
    return PendingUnpack(seg, (held, r, m * b), lead)


# --------------------------------------------------------------------------
# Dispatcher + dense baseline
# --------------------------------------------------------------------------

def dense_allreduce_inside(x: torch.Tensor, *,
                           coll: CollectiveContext) -> torch.Tensor:
    return coll.psum(x)


def sparse_allreduce_inside(
    u: UniformStream,
    *,
    coll: CollectiveContext,
    algorithm: str,
    qsgd: QSGDConfig | None = None,
    rand: torch.Tensor | None = None,
    out_dtype=torch.float32,
    impl: str = "auto",
) -> ReduceOut:
    """Reduce a bucket-uniform stream over the axis with the named
    algorithm. ``algorithm='auto'`` needs network parameters measured on
    the port's interconnect and raises (ROADMAP Queue 1 item 9)."""
    n = u.n
    if algorithm == "auto":
        raise NotImplementedError(AUTO_NOT_CALIBRATED)
    if algorithm == "dense":
        return ReduceOut(dense=dense_allreduce_inside(u.densify(impl=impl),
                                                      coll=coll))
    if algorithm == "ssar_recursive_double":
        return ssar_recursive_double_inside(u.to_stream(), coll=coll, n=n)
    if algorithm == "ssar_split_allgather":
        return ReduceOut(stream=ssar_split_allgather_inside(u, coll=coll))
    if algorithm == "ssar_balanced_split":
        # Standalone: no error-feedback residual to fold the clamp drops
        # into (the plan executor keeps them); under slack caps fold == 0.
        dense, _fold = ssar_balanced_split_inside(u, coll=coll, impl=impl)
        return ReduceOut(dense=dense)
    if algorithm == "ssar_rearranged_rs":
        dense, _fold = ssar_rearranged_rs_inside(u, coll=coll)
        return ReduceOut(dense=dense)
    if algorithm == "dsar_split_allgather":
        return ReduceOut(dense=dsar_split_allgather_inside(
            u, coll=coll, qsgd=qsgd, rand=rand, out_dtype=out_dtype,
            impl=impl))
    raise ValueError(f"unknown algorithm {algorithm!r}")


# --------------------------------------------------------------------------
# Standalone entry point (the Fig. 3 measurement, the classification loop)
# --------------------------------------------------------------------------

def make_sparse_allreduce(
    coll: CollectiveContext,
    n: int,
    k_per_bucket: int,
    bucket_size: int = 512,
    algorithm: str = "dsar_split_allgather",
    qsgd: QSGDConfig | None = None,
    impl: str = "auto",
):
    """Returns f(x (L, n), rand (L, nbq*bq) u32 | None) -> (L, n): each held
    rank's vector TopK-compressed (k of every ``bucket_size``) and summed
    over the axis with ``algorithm``; every rank gets the sum.
    ``algorithm='auto'`` raises (ROADMAP Queue 1 item 9), and so does, on
    a card, a ``bucket_size`` that bucket_topk's kernel does not take."""
    if algorithm == "auto":
        raise NotImplementedError(AUTO_NOT_CALIBRATED)
    check_bucket_size(bucket_size, coll.device, impl)
    from repro_torch.core.topk import compress

    def f(x: torch.Tensor, rand: torch.Tensor | None = None) -> torch.Tensor:
        if x.shape != (coll.local_ranks, n):
            raise ValueError(f"x {tuple(x.shape)}: the context holds "
                             f"{coll.local_ranks} ranks of {n}")
        u, _res = compress(x, k_per_bucket, bucket_size, impl=impl)
        out = sparse_allreduce_inside(u, coll=coll, algorithm=algorithm,
                                      qsgd=qsgd, rand=rand, out_dtype=x.dtype,
                                      impl=impl)
        return out.to_dense(u.n)[..., :n]

    return f
