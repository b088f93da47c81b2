"""Gradient synchronization: the user-facing knob set and the per-leaf
library surface (the JAX package's ``repro.core.compressor``).

The fused train path (``train/train_step.py``) drives
``comm.build_sync_plan`` and the plan executors directly. This module
keeps:

* :class:`SyncConfig`, the knob set;
* the PER-LEAF entry points (``sync_grads_inside``, ``residual_*``) as
  thin wrappers over a one-leaf-per-bucket plan
  (``comm.plan.build_per_leaf_plan``) and the per-rank executor: leaves
  below ``min_sparse_size`` (or that do not split over the ranks) are
  summed densely, and residual state is keyed by leaf;
* :func:`wire_bytes_per_step`, the analytic wire report (paper §8.4).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.comm.buckets import canonical_shape, model_axis
from repro_torch.comm.executor import execute_plan
from repro_torch.comm.plan import build_per_leaf_plan, leaf_sparse_ok
from repro_torch.core.qsgd import QSGDConfig
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class SyncConfig:
    """How gradients are synchronized across data-parallel replicas."""

    mode: str = "dense"              # 'dense' | 'sparcml'
    k_per_bucket: int = 4            # paper §8.3: 4/512 for ASR, 8..16/512 CIFAR
    bucket_size: int = 512
    algorithm: str = "auto"          # ssar_recursive_double|ssar_split_allgather|
                                     # dsar_split_allgather|dense|auto
    qsgd_bits: Optional[int] = None  # quantize DSAR dense phase (2/4/8)
    qsgd_bucket: int = 1024
    qsgd_scale: str = "l2"
    min_sparse_size: int = 65536     # buckets/leaves below this use dense psum
    mean: bool = True
    # Kernel choice. The JAX package defaults to "ref" because its Pallas
    # kernels could not be lowered inside auto-SPMD regions; the port has
    # no such regions, so "auto" runs the CUDA kernels on CUDA tensors and
    # their plain versions on CPU tensors.
    impl: str = "auto"
    ef_dtype: Any = torch.float32
    fusion_bucket_bytes: int = 4 << 20  # fused-plan bucket size
    # ZeRO-sharded exchange: 'replicated' re-densifies the full reduction
    # on every rank; 'scattered' stops at the owner shard (rank r keeps
    # bucket columns [r*w, (r+1)*w), w = cols/dp) and the optimizer update
    # runs there, followed by a dense param allgather (needs zero1).
    output_mode: str = "replicated"  # 'replicated' | 'scattered'

    @property
    def density(self) -> float:
        return self.k_per_bucket / self.bucket_size

    def qsgd(self) -> QSGDConfig | None:
        if self.qsgd_bits is None:
            return None
        return QSGDConfig(self.qsgd_bits, self.qsgd_bucket, self.qsgd_scale)


# --------------------------------------------------------------------------
# Per-leaf routing and residual (error-feedback) state
# --------------------------------------------------------------------------

def sparse_path_ok(shape, spec, cfg: SyncConfig, dp_total: int) -> bool:
    """The leaf qualifies for the per-leaf sparse path (see
    :func:`repro_torch.comm.plan.leaf_sparse_ok`)."""
    return leaf_sparse_ok(shape, spec, cfg, dp_total)


def residual_shapes(param_shapes, param_specs, cfg: SyncConfig,
                    dp_total: int):
    """Tree of PER-LEAF EF residual shapes, as meta tensors (dp_total,
    rows, cols) in the EF dtype; None for a leaf the dense path takes."""
    def one(leaf, spec):
        shape = tuple(leaf.shape)
        if not sparse_path_ok(shape, spec, cfg, dp_total):
            return None
        rows, cols = canonical_shape(shape, spec, cfg.bucket_size)
        return torch.empty((dp_total, rows, cols), dtype=cfg.ef_dtype,
                           device="meta")

    return tree_map(one, param_shapes, param_specs)


def init_residuals(param_shapes, param_specs, cfg: SyncConfig, dp_total: int,
                   device="cpu"):
    return tree_map(lambda s: None if s is None else torch.zeros(
        s.shape, dtype=s.dtype, device=device),
        residual_shapes(param_shapes, param_specs, cfg, dp_total))


def residual_specs(param_shapes, param_specs, cfg: SyncConfig, dp_total: int,
                   dp_axes=("pod", "data")):
    """Spec tuples of the per-leaf residuals: the leading axis over the dp
    axes, canonical rows over 'model' when the leaf was model-sharded;
    None for a leaf the dense path takes."""
    def one(leaf, spec):
        if not sparse_path_ok(tuple(leaf.shape), spec, cfg, dp_total):
            return None
        return (dp_axes, "model" if model_axis(spec) is not None else None,
                None)

    return tree_map(one, param_shapes, param_specs)


# --------------------------------------------------------------------------
# The per-leaf sync step (a thin wrapper over a one-leaf-per-bucket plan)
# --------------------------------------------------------------------------

def sync_grads_inside(grads, residuals, cfg: SyncConfig, param_specs, *,
                      coll, pod_coll=None, rand_fn=None):
    """Compress + allreduce a grad tree, per rank. Returns (synced grads,
    new residuals).

    grads: the held ranks' (unreduced) gradients, (L, *leaf) leaves.
    residuals: the same tree of per-leaf (L, rows, cols) EF state or None
    per leaf (or None for all). ``coll`` / ``pod_coll`` and ``rand_fn``
    are :func:`repro_torch.comm.executor.reduce_buckets`'s, the bucket
    index counting the covered leaves. The synced leaves come back in
    their own shape, the sum every rank holds alike; uncovered leaves are
    summed densely, their residuals passed through."""
    p_pod = pod_coll.p if pod_coll is not None else 1
    replicas = coll.p * p_pod
    scale = 1.0 / replicas if cfg.mean else 1.0
    leaves_g, paths = tree_flatten(grads)
    leaves_r = (tree_flatten(residuals)[0] if residuals is not None
                else [None] * len(leaves_g))
    leaves_s = tree_flatten(param_specs)[0]

    shapes = tree_unflatten(paths, [torch.empty(g.shape[1:], device="meta")
                                    for g in leaves_g])
    plan = build_per_leaf_plan(shapes, tree_unflatten(paths, leaves_s), cfg,
                               replicas)
    covered = {g.slots[0].leaf_id for g in plan.groups
               if leaves_r[g.slots[0].leaf_id] is not None}
    plan = dataclasses.replace(plan, groups=tuple(
        g for g in plan.groups if g.slots[0].leaf_id in covered))
    bucket_of_leaf = {g.slots[0].leaf_id: g.buckets[0].name
                      for g in plan.groups}
    synced, new_res = execute_plan(
        plan, leaves_g, {bucket_of_leaf[i]: leaves_r[i] for i in covered},
        coll=coll, pod_coll=pod_coll, rand_fn=rand_fn)

    new_g, new_r = [], []
    for i, (g, r) in enumerate(zip(leaves_g, leaves_r)):
        if i in covered:
            new_g.append(synced[i])
            new_r.append(new_res[bucket_of_leaf[i]])
            continue
        out = coll.psum(g)
        if pod_coll is not None:
            out = pod_coll.psum(out)
        new_g.append((out * scale)[0])
        new_r.append(r)
    return tree_unflatten(paths, new_g), tree_unflatten(paths, new_r)


# --------------------------------------------------------------------------
# Analytic wire traffic
# --------------------------------------------------------------------------

def wire_bytes_per_step(param_shapes, cfg: SyncConfig, p: int,
                        param_specs=None, plan=None) -> dict:
    """Analytic bytes on the wire a rank a step (paper §8.4's "80 MB ->
    <0.5 MB"), per leaf, or per bucket when a fused ``plan`` is given. A
    leaf that the sparse path does not take is charged the dense
    Rabenseifner cost, 2 (P-1)/P N isize; so is every leaf in dense mode."""
    leaves = tree_flatten(param_shapes)[0]
    specs = ([None] * len(leaves) if param_specs is None
             else tree_flatten(param_specs)[0])
    total_n = sum(math.prod(s.shape) for s in leaves)
    dense = 2 * (p - 1) / p * total_n * 4
    if cfg.mode != "sparcml":
        return {"dense_bytes": dense, "sparcml_bytes": dense, "ratio": 1.0,
                "sparse_frac": 0.0}

    if plan is not None:
        covered = plan.covered_leaf_ids()
        sparse = plan.wire_bytes(p)
        # the sparse fraction by bucket: only the canonical range in
        # sparse buckets rides the compressed path
        sparse_n = (total_n * sum(b.n for b in plan.buckets if b.sparse)
                    / max(1, sum(b.n for b in plan.buckets)))
        for i, s in enumerate(leaves):       # uncovered leaves ride psum
            if i not in covered:
                sparse += 2 * (p - 1) / p * math.prod(s.shape) * 4
    else:
        q = cfg.qsgd()
        sparse = 0.0
        sparse_n = 0
        for s, spec in zip(leaves, specs):
            n_leaf = math.prod(s.shape)
            if not sparse_path_ok(tuple(s.shape), spec, cfg, p):
                sparse += 2 * (p - 1) / p * n_leaf * 4
                continue
            sparse_n += n_leaf
            k_items = n_leaf * cfg.density
            sparse += (p - 1) / p * k_items * 8              # idx+val split
            if q is not None:
                sparse += (p - 1) / p * (n_leaf * q.bits / 8
                                         + n_leaf / q.bucket_size * 4)
            else:
                sparse += (p - 1) / p * n_leaf * 4           # fp32 gather
    return {"dense_bytes": dense, "sparcml_bytes": sparse,
            "ratio": dense / sparse, "sparse_frac": sparse_n / total_n}
