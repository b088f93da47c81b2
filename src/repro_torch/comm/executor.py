"""Plan executor: one TopK-compress + reduction per fusion bucket.

Two forms. The per-rank form (:func:`reduce_buckets`,
:func:`execute_plan`, the JAX package's manual lowering) is the code each
rank runs, talking to the others through a ``CollectiveContext``: each
bucket runs its planned algorithm of ``core/allreduce.py`` on the wire,
with the clamp folds of the capacity-bound ones, over stacked ranks on
one device or over ``torch.distributed``. The stacked-replica form
(:func:`reduce_buckets_spmd`, :func:`execute_plan_spmd`) is described
next.

On one device the R ranks of the JAX package's auto-SPMD formulation
(``repro.comm.executor.reduce_buckets_spmd``) are a leading axis of every
tensor, and a sum over that axis is the allreduce. Per-rank top-k and
error feedback stay exact. For each group the leaves are fused into one
canonical (R, rows, cols) buffer, then per fusion bucket:

    acc       =  residual + bucket slice      (error feedback, Alg. 2 line 1)
    stream, residual' = bucket_topk(acc)      (Alg. 2 line 2)
    dense     =  bucket_scatter(stream)       (each rank's densified stream)
    reduced   =  sum over ranks               (Alg. 2 line 3)
    [DSAR + QSGD: every range owner quantizes its shard of the sum
     (qsgd_pack); after the last bucket one grouped qsgd_unpack
     dequantizes the shards of all such buckets, sums the pods, applies
     the mean and writes each bucket's (rows, cols) buffer]

Raw-dense buckets (below ``min_sparse_size``) are a plain sum. SSAR
algorithms reduce exactly, so in this form they fold into the same sum.

The QSGD rounding bits of bucket ``i`` come from ``rand_fn(i, n)``, which
returns n uint32 words laid out (p_pod, p_data, rows * shard) as the
reference's ``_qsgd_rand_all``. The train step draws them from a seeded
``torch.Generator`` (Philox on a CUDA device); tests pass the reference's
own bits instead. ``bucket_idx`` counts every bucket, dense ones too.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.comm.buckets import pack_group, unpack_group
from repro_torch.comm.collectives import CollectiveContext
from repro_torch.comm.plan import SyncPlan
from repro_torch.core import allreduce as ar
from repro_torch.core import sparse_stream as ss
from repro_torch.core.topk import UniformStream, compress2d
from repro_torch.kernels.qsgd_pack.ops import qsgd_pack
from repro_torch.kernels.qsgd_unpack.ops import qsgd_unpack_grouped
from repro_torch.kernels.qsgd_unpack.ref import UnpackSegment

RandFn = Callable[[int, int], torch.Tensor]


def reduce_buckets_spmd(
    plan: SyncPlan,
    leaves_r: Sequence[torch.Tensor],
    residuals: dict,
    *,
    p_data: int,
    p_pod: int = 1,
    rand_fn: Optional[RandFn] = None,
):
    """The REDUCE half in the stacked-replica form.

    leaves_r: per-rank grads stacked as (R, *leaf_shape), R = p_pod*p_data.
    residuals: bucket-keyed (R, rows, cols) error-feedback tensors.
    Returns (reduced {bucket name -> (rows, cols) f32 buffer}, new
    bucket-keyed residuals)."""
    cfg = plan.cfg
    replicas = p_data * p_pod
    if leaves_r and leaves_r[0].shape[0] != replicas:
        raise ValueError(f"leaves carry {leaves_r[0].shape[0]} ranks, the "
                         f"plan is for {replicas}")
    scale = 1.0 / replicas if cfg.mean else 1.0
    qsgd = cfg.qsgd()

    reduced: dict = {}
    new_residuals: dict = {}
    quantized: dict = {}            # bucket name -> UnpackSegment
    bucket_idx = 0
    for group in plan.groups:
        buf = pack_group(group, leaves_r, cfg.bucket_size, batch_dims=1)
        for b in group.buckets:
            seg = buf[:, :, b.col_start:b.col_start + b.cols]
            if not b.sparse:
                reduced[b.name] = seg.sum(dim=0) * scale
                bucket_idx += 1
                continue
            res = residuals[b.name]                          # (R, rows, cols)
            acc = res.to(torch.float32) + seg
            u, residual = compress2d(acc, cfg.k_per_bucket, cfg.bucket_size,
                                     impl=cfg.impl)
            dens = u.densify(impl=cfg.impl)                  # (R, rows, m*B)
            rows, mb = dens.shape[1], dens.shape[2]
            dpod = dens.reshape(p_pod, p_data, rows, mb).sum(dim=1)
            del acc, u, dens                 # freed before the pack allocates
            new_residuals[b.name] = residual.to(res.dtype)
            if qsgd is not None and b.algorithm == "dsar_split_allgather":
                if rand_fn is None:
                    raise ValueError("QSGD needs stochastic-rounding bits: "
                                     "pass rand_fn")
                shard = mb // p_data
                bq = qsgd.bucket_size
                x = dpod.reshape(p_pod, rows, p_data, shard).permute(0, 2, 1, 3)
                rand = rand_fn(bucket_idx, p_pod * p_data * rows * shard)
                packed, sc = qsgd_pack(x.reshape(-1, bq), rand.reshape(-1, bq),
                                       qsgd.bits, qsgd.scale_mode,
                                       impl=cfg.impl)
                quantized[b.name] = UnpackSegment(packed, sc, p_pod, p_data,
                                                  rows, shard, bq, scale)
                del x, rand
            else:
                reduced[b.name] = dpod.sum(dim=0) * scale
            del dpod            # only the packed codes wait for the unpack
            bucket_idx += 1
    if quantized:
        outs = qsgd_unpack_grouped(list(quantized.values()), qsgd.bits,
                                   impl=cfg.impl)
        reduced.update(zip(quantized, outs))
    return reduced, new_residuals


def apply_buckets(plan: SyncPlan, reduced: dict,
                  leaves: Sequence[torch.Tensor]) -> list:
    """The APPLY half: reassemble each group buffer from its reduced
    buckets and unpack back to the original leaf layouts (``leaves`` are
    shape/dtype references). Leaves the plan does not cover come back as
    None."""
    for group in plan.groups:
        for b in group.buckets:
            if tuple(reduced[b.name].shape) != (group.rows, b.cols):
                raise ValueError(
                    f"apply_buckets expects replicated (rows, cols) buffers; "
                    f"got {tuple(reduced[b.name].shape)} for {b.name}")
    new_leaves: list = [None] * plan.num_leaves
    for group in plan.groups:
        parts = [reduced[b.name] for b in group.buckets]
        out_buf = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        for leaf_id, arr in unpack_group(group, out_buf, leaves):
            new_leaves[leaf_id] = arr
    return new_leaves


def apply_buckets_spmd(plan: SyncPlan, reduced: dict,
                       leaves_r: Sequence[torch.Tensor]) -> list:
    """APPLY half of the stacked form: rank-0 slices stand in as the
    shape/dtype references for the unpack."""
    return apply_buckets(plan, reduced, [l[0] for l in leaves_r])


def execute_plan_spmd(
    plan: SyncPlan,
    leaves_r: Sequence[torch.Tensor],
    residuals: dict,
    *,
    p_data: int,
    p_pod: int = 1,
    rand_fn: Optional[RandFn] = None,
):
    """Synchronous stacked-replica sync: :func:`reduce_buckets_spmd`
    composed with :func:`apply_buckets_spmd`. Returns (synced leaves in
    their original layout, new residuals)."""
    reduced, new_residuals = reduce_buckets_spmd(
        plan, leaves_r, residuals, p_data=p_data, p_pod=p_pod,
        rand_fn=rand_fn)
    return apply_buckets_spmd(plan, reduced, leaves_r), new_residuals


# --------------------------------------------------------------------------
# Per-rank form (the reference's manual lowering, replicated output mode)
# --------------------------------------------------------------------------

def _pod_sparse_exchange(out: torch.Tensor, pod_coll: CollectiveContext,
                         cap: int) -> torch.Tensor:
    """Cross-pod phase as a sparse stream exchange: the within-pod reduced
    (L, 1, n) buffer is re-sparsified (its nnz is bounded by p_data * k,
    so ``cap`` loses nothing), every pod's (idx, val) stream is
    all-gathered, and the union scatter-adds back to dense, one pod's
    stream after the other in pod order. Exact: the same sum as the dense
    psum, at p_pod * cap items on the wire instead of the full n-vector."""
    flat = out[:, 0]
    stream = ss.from_mask(flat, flat != 0, cap)
    idx_all = pod_coll.all_gather(stream.idx, axis=0)    # (L, p_pod*cap)
    val_all = pod_coll.all_gather(stream.val, axis=0)
    dense = torch.zeros_like(flat)
    for a in range(pod_coll.p):            # each pod's indices are unique
        sl = slice(a * cap, (a + 1) * cap)
        dense = ss.scatter_add_drop(dense, idx_all[:, sl], val_all[:, sl])
    return dense[:, None]


def _reduce_flat_sparse(u_flat: UniformStream, algorithm: str, *,
                        coll: CollectiveContext, impl: str = "auto"):
    """SSAR variants for flat (rows == 1) buckets; returns (dense (L, n),
    fold). ``fold`` is the capacity-clamped pre-scale mass of the
    portfolio algorithms, which the caller adds into the bucket's
    error-feedback residual (the global-residual rule), and None for the
    unclamped classics."""
    n = u_flat.n
    if algorithm == "ssar_recursive_double":
        out = ar.ssar_recursive_double_inside(u_flat.to_stream(), coll=coll,
                                              n=n)
        return out.to_dense(n), None
    if algorithm == "ssar_split_allgather":
        stream = ar.ssar_split_allgather_inside(u_flat, coll=coll)
        return ss.densify(stream, n), None
    if algorithm == "ssar_balanced_split":
        return ar.ssar_balanced_split_inside(u_flat, coll=coll, impl=impl)
    if algorithm == "ssar_rearranged_rs":
        return ar.ssar_rearranged_rs_inside(u_flat, coll=coll)
    raise ValueError(f"not a flat sparse algorithm: {algorithm!r}")


def reduce_buckets(
    plan: SyncPlan,
    leaves: Sequence[torch.Tensor],
    residuals: dict,
    *,
    coll: CollectiveContext,
    pod_coll: Optional[CollectiveContext] = None,
    rand_fn: Optional[RandFn] = None,
    telemetry: bool = False,
):
    """The REDUCE half, per rank: pack -> EF add -> TopK -> the bucket's
    collective.

    leaves: the held ranks' grads, (L, *leaf_shape) in tree_flatten order.
    residuals: bucket-keyed (L, rows, cols) error-feedback tensors.
    ``coll`` is the data axis; ``pod_coll`` the pod axis of a (pod, data)
    rank grid (a dense psum, or a sparse stream exchange for buckets the
    plan marks ``pod_sparse``). The QSGD bits of bucket ``i`` come from
    ``rand_fn(i, n)``: n u32 words laid out (L, rows * shard), each held
    rank's own bits for its shard (the reference's ``_qsgd_rand``).
    Returns (reduced {name -> (L, rows, cols) f32, every rank's
    replicated sum}, new residuals). Telemetry is not ported yet."""
    if telemetry:
        raise NotImplementedError(
            "per-bucket telemetry needs ROADMAP Queue 1 item 4's "
            "_bucket_telemetry; pass telemetry=False")
    cfg = plan.cfg
    p_data = coll.p
    p_pod = pod_coll.p if pod_coll is not None else 1
    lead = coll.local_ranks
    if leaves and leaves[0].shape[0] != lead:
        raise ValueError(f"leaves carry {leaves[0].shape[0]} ranks, the "
                         f"context holds {lead}")
    if p_data * p_pod != plan.dp_total:
        raise ValueError(f"the plan is for {plan.dp_total} ranks, the "
                         f"contexts span {p_data} x {p_pod}")
    scale = 1.0 / plan.dp_total if cfg.mean else 1.0

    reduced: dict = {}
    new_residuals: dict = {}
    bucket_idx = 0
    for group in plan.groups:
        buf = pack_group(group, leaves, cfg.bucket_size, batch_dims=1)
        for b in group.buckets:
            seg = buf[:, :, b.col_start:b.col_start + b.cols]
            if not b.sparse:
                out = coll.psum(seg)
                if pod_coll is not None:
                    out = pod_coll.psum(out)
                reduced[b.name] = out * scale
                bucket_idx += 1
                continue
            res = residuals[b.name]                          # (L, rows, cols)
            acc = res.to(torch.float32) + seg                # Alg. 2 line 1
            u, residual = compress2d(acc, cfg.k_per_bucket, cfg.bucket_size,
                                     impl=cfg.impl)          # Alg. 2 line 2
            del acc
            algorithm = b.algorithm
            fold = None
            if algorithm == "dense":
                # compress + EF, then allreduce the densified stream
                out = coll.psum(u.densify(impl=cfg.impl))
            elif algorithm == "dsar_split_allgather":     # Alg. 2 line 3
                qsgd = cfg.qsgd()
                rand = None
                if qsgd is not None:
                    if rand_fn is None:
                        raise ValueError("QSGD needs stochastic-rounding "
                                         "bits: pass rand_fn")
                    rand = rand_fn(bucket_idx,
                                   lead * group.rows * b.cols // p_data)
                out = ar.dsar_split_allgather_batched_inside(
                    u, coll=coll, qsgd=qsgd, rand=rand, impl=cfg.impl)
            else:
                # SSAR keeps a sparse end-representation; flat rows only.
                assert group.rows == 1, (b.name, algorithm)
                flat = UniformStream(u.lidx[:, 0], u.val[:, 0],
                                     cfg.bucket_size)
                out, fold = _reduce_flat_sparse(flat, algorithm, coll=coll,
                                                impl=cfg.impl)
                out = out[:, None, :]
            if pod_coll is not None:
                if b.pod_sparse and group.rows == 1:
                    cap = min(b.n, p_data * plan.bucket_k(group, b))
                    out = _pod_sparse_exchange(out, pod_coll, cap)
                else:
                    out = pod_coll.psum(out)                 # hierarchical
            reduced[b.name] = out * scale
            if fold is not None:
                # Global-residual rule: mass clamped off the wire re-enters
                # THIS rank's residual at pre-scale magnitude, so it is
                # contributed exactly once on a later step.
                residual = residual + fold[:, None, :]
            new_residuals[b.name] = residual.to(res.dtype)
            bucket_idx += 1
    return reduced, new_residuals


def execute_plan(
    plan: SyncPlan,
    leaves: Sequence[torch.Tensor],
    residuals: dict,
    *,
    coll: CollectiveContext,
    pod_coll: Optional[CollectiveContext] = None,
    rand_fn: Optional[RandFn] = None,
):
    """Synchronous per-rank sync: :func:`reduce_buckets` composed with
    :func:`apply_buckets`. Returns (synced leaves in their original
    layout, new residuals (L, rows, cols)). Every held rank holds the same
    replicated buffers after the collectives (they hand every rank the
    same bytes), so the apply half runs once, on the first held rank's."""
    reduced, new_residuals = reduce_buckets(
        plan, leaves, residuals, coll=coll, pod_coll=pod_coll,
        rand_fn=rand_fn)
    first = {name: v[0] for name, v in reduced.items()}
    return apply_buckets(plan, first, [l[0] for l in leaves]), new_residuals
