"""Plan executor, stacked-replica form: one TopK-compress + reduction per
fusion bucket, with the R data-parallel ranks on a leading tensor axis.

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
from repro_torch.comm.plan import SyncPlan
from repro_torch.core.topk import compress2d
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
