"""Sync planning: leaves -> fusion buckets.

A :class:`SyncPlan` is built once per train-step configuration from the
parameter shapes, their specs, the ``SyncConfig`` and the data-parallel
world size. It decides:

* which *group* each leaf belongs to (leaves with the same canonical row
  count fuse together; model-sharded leaves keep their row axis,
  everything else lands in the single flat row-1 group);
* how each group's fused column space is chopped into fixed-size
  *fusion buckets* (quantum = bucket_size x dp_total columns so the split
  phase always divides, x the QSGD bucket when quantizing);
* which algorithm each bucket runs (the configured one, DSAR for rowed
  buckets, plain sum below ``min_sparse_size``). ``algorithm='auto'``
  selects each bucket's by the cost model on the network parameters
  ``net`` passed to ``build_sync_plan`` (the reference resolves against
  its TPU constants; the port has none, so "auto" without ``net``
  raises).

Error-feedback residual state is keyed by bucket: a bucket is the unit
of compression, so it is the unit of feedback. So are the non-blocking
runtime's in-flight reduced buffers (``inflight_shapes``).

Plans are versioned and re-derivable: ``SyncPlan.replan`` produces a
successor with the same geometry (groups, buckets, leaf slots, residual
and in-flight layout) and re-selected bucket algorithms, from measured
densities and network parameters the caller passes (the adaptive loop,
``runtime/adapt.py``), or from an explicit algorithm map (a checkpoint's).
Whether a bucket carries EF state is pinned at build time
(``BucketSpec.ef``), so a bucket a replan demotes to ``dense`` keeps its
residual and every checkpoint's layout.

The plan also accounts for its wire: ``wire_bytes`` charges every bucket
through ``cost_model.bucket_wire_bytes``, the same entry the executors'
per-bucket telemetry charges. ``build_per_leaf_plan`` is the legacy
routing (one bucket per qualifying leaf) behind ``core/compressor.py``'s
per-leaf wrappers.

The ZeRO-sharded exchange (``output_mode="scattered"``) stops every
bucket's reduction at the owner shard: rank r keeps columns [r*w,
(r+1)*w) of each bucket, w = cols / dp_total (``owned_cols``), as a
(ranks, rows, w) chunk (``scattered_shapes``: the reduced and in-flight
buffers and the sharded optimizer moments). The gather phase drops out of
``wire_bytes``; the dense parameter allgather that replaces it is
``param_allgather_bytes``. A scattered plan's signature carries an
``out=scattered|`` prefix, and ``replan`` keeps the mode: a mode change
alters the state layout, so it raises.

The serve side has its own plan: :class:`ServePlan` (``build_serve_plan``)
picks the wire of one decode step's activation exchange, dense or a row
stream of a capacity, and duck-types the surface of SyncPlan the adaptive
controller reads.

The geometry is the JAX package's ``repro.comm.plan`` field for field;
the tests hold the two plans, and their replans, equal.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.comm.buckets import canonical_shape, model_axis
from repro_torch.core.cost_model import (AUTO_NEEDS_NET, bucket_wire_bytes,
                                         select_bucket_algorithm,
                                         stream_wire_bytes)
from repro_torch.core.sparse_stream import round_up_pow2
from repro_torch.utils.tree import tree_flatten

SPARSE_ALGORITHMS = ("ssar_recursive_double", "ssar_split_allgather",
                     "dsar_split_allgather", "ssar_balanced_split",
                     "ssar_rearranged_rs")
# The batched (rows > 1) pipeline keeps the model-sharded row axis as a
# pure batch dim; only DSAR (and dense) are implemented batched.
BATCHED_ALGORITHMS = ("dsar_split_allgather", "dense")


@dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside its group's fused canonical buffer."""

    leaf_id: int                  # index in tree_flatten order
    shape: tuple[int, ...]        # original leaf shape
    spec: Any                     # tuple of axis names
    rows: int                     # canonical rows
    cols: int                     # canonical padded cols (bucket multiple)
    offset: int                   # column offset inside the group buffer


@dataclass(frozen=True)
class BucketSpec:
    """One fusion bucket: a contiguous column range of a group buffer."""

    name: str                     # residual-state key, stable across runs
    col_start: int
    cols: int
    rows: int
    algorithm: str                # resolved: a sparse algorithm | 'dense'
    # Whether the bucket carries error-feedback state, pinned at build
    # time (None = follow ``sparse``): a replan that demotes the bucket's
    # wire representation to 'dense' keeps its residual, so the state
    # layout and every checkpoint stay the same under every replan.
    ef: Optional[bool] = None
    # Route the cross-pod phase as a sparse (idx, val) stream exchange
    # instead of the dense psum (flat buckets only). Set by re-planning;
    # wire path only, the sum is exact.
    pod_sparse: bool = False

    @property
    def sparse(self) -> bool:
        return self.algorithm != "dense"

    @property
    def has_residual(self) -> bool:
        """Carries EF state: compress, then reduce, whatever the current
        wire representation ('dense' here is the compressed stream's dense
        end-representation, paper §5.3.3, not an uncompressed sum)."""
        return self.sparse if self.ef is None else self.ef

    @property
    def n(self) -> int:
        return self.rows * self.cols


@dataclass(frozen=True)
class GroupSpec:
    """All leaves sharing one canonical row count, fused along columns."""

    gid: int
    rows: int
    model_sharded: bool           # row axis carries the 'model' sharding
    cols: int                     # total padded cols (sum of bucket cols)
    slots: tuple[LeafSlot, ...]
    buckets: tuple[BucketSpec, ...]


@dataclass(frozen=True)
class SyncPlan:
    """The full fusion plan for one (param tree, SyncConfig, dp) triple.
    Versioned: ``replan`` produces a successor with the same geometry and
    re-selected bucket algorithms, the unit the adaptive runtime swaps at
    drain barriers."""

    cfg: Any                      # SyncConfig
    dp_total: int
    num_leaves: int
    groups: tuple[GroupSpec, ...]
    version: int = 0              # bumped by every replan()
    # 'replicated': every rank holds the full reduction; 'scattered': the
    # exchange stops at the owner shard (single pod only).
    output_mode: str = "replicated"

    @property
    def scattered(self) -> bool:
        return self.output_mode == "scattered"

    def owned_cols(self, b: BucketSpec) -> int:
        """Column width of one rank's owned range of a bucket: whole,
        since the column quantum is bucket_size x dp_total."""
        if b.cols % self.dp_total:
            raise ValueError(f"{b.name}: {b.cols} columns do not split over "
                             f"{self.dp_total} ranks")
        return b.cols // self.dp_total

    @property
    def buckets(self) -> tuple[BucketSpec, ...]:
        return tuple(b for g in self.groups for b in g.buckets)

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def num_sparse_buckets(self) -> int:
        return sum(1 for b in self.buckets if b.sparse)

    def covered_leaf_ids(self) -> set[int]:
        return {s.leaf_id for g in self.groups for s in g.slots}

    def algorithms(self) -> dict[str, str]:
        """Bucket name -> resolved algorithm."""
        return {b.name: b.algorithm for b in self.buckets}

    def pod_sparse_flags(self) -> dict[str, bool]:
        return {b.name: b.pod_sparse for b in self.buckets}

    def signature(self) -> str:
        """Per-bucket algorithm (with a ``+ps`` marker for a sparse pod
        phase) in geometry order, prefixed ``out=scattered|`` for a
        scattered plan (the mode changes the step's state layout): the
        reference's key."""
        algos = ",".join(
            f"{b.name}={b.algorithm}{'+ps' if b.pod_sparse else ''}"
            for b in self.buckets)
        return f"out=scattered|{algos}" if self.scattered else algos

    def wire_bytes(self, p: Optional[int] = None, *,
                   aggregate: bool = False) -> float:
        """Gradient-exchange bytes on the wire a rank a step under this
        plan (``aggregate=True``: times ``p``, the whole data axis). Each
        bucket is charged by ``cost_model.bucket_wire_bytes``, the entry
        the executors' telemetry charges, at its worst-case nnz. The
        scattered mode charges each algorithm without its gather phase."""
        total = sum(self.wire_bytes_by_bucket(p).values())
        return total * ((p or self.dp_total) if aggregate else 1)

    def wire_bytes_by_bucket(self, p: Optional[int] = None) -> dict:
        """Bucket name -> its share of ``wire_bytes(p)``."""
        p = p or self.dp_total
        vb = self.cfg.qsgd_bits if self.cfg.qsgd_bits is not None else 32
        return {b.name: bucket_wire_bytes(b.algorithm, p,
                                          self.bucket_k(g, b), b.n,
                                          value_bits=vb,
                                          scattered=self.scattered)
                for g in self.groups for b in g.buckets}

    def param_allgather_bytes(self, p: Optional[int] = None, *,
                              aggregate: bool = False) -> float:
        """Bytes a rank a step of the dense parameter allgather that the
        scattered mode pays instead of the gradient-side gather: every
        bucket ships its (p-1)/p foreign f32 columns. 0 in the replicated
        mode (parameters never leave the rank)."""
        if not self.scattered:
            return 0.0
        p = p or self.dp_total
        total = sum((p - 1) / p * b.n * 4 for b in self.buckets)
        return total * (p if aggregate else 1)

    def bucket_k(self, group: GroupSpec, b: BucketSpec) -> int:
        """TOTAL selected items of one bucket per rank per step."""
        return group.rows * (b.cols // self.cfg.bucket_size) * \
            self.cfg.k_per_bucket

    def replan(self, densities: Optional[dict] = None, net=None, *,
               algorithms: Optional[dict] = None,
               pod_sparse: Optional[dict] = None,
               allow: Optional[tuple] = None,
               output_mode: Optional[str] = None) -> "SyncPlan":
        """A successor plan with re-selected bucket algorithms.

        Either re-run the cost model with MEASURED post-reduction nnz per
        bucket (``densities``: name -> nnz, from the telemetry window) on
        the network parameters ``net`` (required: the port carries no
        default), or apply explicit ``algorithms`` overrides (a
        checkpoint's; then ``net`` is not read). ``allow`` narrows the
        candidate set further. Structural invariants:

        * buckets without EF state (raw-dense at build) stay raw-dense:
          they have no compression stats and no residual to carry;
        * EF-bearing buckets keep their residual whatever the new wire
          representation (``ef`` pinned), so the state layout and the
          checkpoints are the same under every replan;
        * batched (rows > 1) buckets stay within BATCHED_ALGORITHMS.

        ``output_mode``: None or the plan's own mode, which the successor
        inherits. Another mode raises: it changes the reduced, in-flight
        and optimizer state layout, which no plan swap migrates (build
        the other mode's plan from its config instead)."""
        if output_mode not in (None, "replicated", "scattered"):
            raise ValueError(f"unknown output_mode {output_mode!r}")
        if output_mode not in (None, self.output_mode):
            raise ValueError(
                f"replan keeps the output_mode ({self.output_mode!r}): "
                f"{output_mode!r} changes the state layout")
        if algorithms is None and net is None:
            raise ValueError(
                "replan by the cost model needs network parameters: pass "
                "net (utils/calibrate.py fits them), or explicit algorithms")
        cfg = self.cfg
        vb = cfg.qsgd_bits if cfg.qsgd_bits is not None else 32
        new_groups = []
        for g in self.groups:
            new_buckets = []
            for b in g.buckets:
                if not b.has_residual:
                    new_buckets.append(b)        # permanently raw-dense
                    continue
                allowed = (SPARSE_ALGORITHMS + ("dense",) if g.rows == 1
                           else BATCHED_ALGORITHMS)
                if allow is not None:
                    narrowed = tuple(a for a in allowed if a in allow)
                    allowed = narrowed or allowed
                if algorithms is not None:
                    algo = algorithms.get(b.name, b.algorithm)
                else:
                    nnz = None if densities is None else densities.get(b.name)
                    algo = select_bucket_algorithm(
                        self.dp_total, self.bucket_k(g, b), b.n, net,
                        value_bits=vb, allow=allowed, reduced_nnz=nnz)
                if algo not in allowed:
                    algo = "dsar_split_allgather"
                ps = b.pod_sparse if pod_sparse is None else \
                    bool(pod_sparse.get(b.name, b.pod_sparse))
                new_buckets.append(BucketSpec(
                    b.name, b.col_start, b.cols, b.rows, algo,
                    ef=b.has_residual, pod_sparse=ps and g.rows == 1))
            new_groups.append(GroupSpec(g.gid, g.rows, g.model_sharded,
                                        g.cols, g.slots, tuple(new_buckets)))
        return dataclasses.replace(self, groups=tuple(new_groups),
                                   version=self.version + 1)

    def residual_shapes(self) -> dict[str, tuple[int, int, int]]:
        """Bucket name -> (dp_total, rows, cols) of its EF residual, for
        every bucket that carries one (``has_residual``): raw-dense buckets
        carry none, a replan-demoted bucket keeps its own."""
        return {b.name: (self.dp_total, g.rows, b.cols)
                for g in self.groups for b in g.buckets if b.has_residual}

    def init_residuals(self, device="cpu", ranks: Optional[int] = None
                       ) -> dict[str, torch.Tensor]:
        """Zero error-feedback state, keyed by bucket name: (ranks, rows,
        cols) for every bucket of ``residual_shapes``. ``ranks``: the ranks
        this process holds, all ``dp_total`` by default (one over
        ``torch.distributed``)."""
        ranks = self.dp_total if ranks is None else ranks
        return {name: torch.zeros((ranks,) + shape[1:],
                                  dtype=self.cfg.ef_dtype, device=device)
                for name, shape in self.residual_shapes().items()}

    def scattered_shapes(self) -> dict[str, tuple[int, int, int]]:
        """Bucket name -> (dp_total, rows, cols/dp_total), the owner-chunk
        layout: chunk r is rank r's owned column range. The layout of the
        scattered reduced and in-flight buffers and of the sharded
        optimizer moments built on them (every bucket, raw-dense ones
        too: they own their parameters' update)."""
        return {b.name: (self.dp_total, g.rows, self.owned_cols(b))
                for g in self.groups for b in g.buckets}

    def inflight_shapes(self) -> dict[str, tuple]:
        """Bucket name -> shape of the REDUCED f32 buffer held between one
        step's reduce and the next step's apply (non-blocking runtime).
        Every bucket has one, dense buckets too; only sparse buckets carry
        residuals. Replicated output mode: the full (rows, cols) buffer;
        scattered: the (dp_total, rows, cols/dp_total) owner chunks."""
        if self.scattered:
            return self.scattered_shapes()
        return {b.name: (g.rows, b.cols)
                for g in self.groups for b in g.buckets}

    def init_inflight(self, device="cpu", ranks: Optional[int] = None
                      ) -> dict[str, torch.Tensor]:
        """Zero in-flight buffers; a scattered plan's chunks for the
        ``ranks`` this process holds (all ``dp_total`` by default)."""
        shapes = self.inflight_shapes()
        if self.scattered and ranks is not None:
            shapes = {k: (ranks,) + s[1:] for k, s in shapes.items()}
        return {k: torch.zeros(s, dtype=torch.float32, device=device)
                for k, s in shapes.items()}

    def describe(self) -> str:
        lines = [f"SyncPlan: {self.num_leaves} leaves -> "
                 f"{self.num_buckets} buckets ({self.num_sparse_buckets} sparse)"
                 + (" [scattered]" if self.scattered else "")]
        for g in self.groups:
            lines.append(f"  group {g.gid}: rows={g.rows} cols={g.cols} "
                         f"leaves={len(g.slots)} "
                         f"model_sharded={g.model_sharded}")
            for b in g.buckets:
                lines.append(f"    {b.name}: cols={b.cols} algo={b.algorithm}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Plan construction
# --------------------------------------------------------------------------

def _col_quantum(cfg, dp_total: int) -> int:
    """Bucket columns must divide into dp_total equal whole-TopK-bucket
    shards (split phase), and into whole QSGD buckets per shard."""
    q = cfg.bucket_size
    if cfg.qsgd_bits is not None:
        q = math.lcm(cfg.bucket_size, cfg.qsgd_bucket)
    return q * dp_total


def _bucket_capacity_cols(cfg, dp_total: int, rows: int) -> int:
    q = _col_quantum(cfg, dp_total)
    budget_elems = max(1, cfg.fusion_bucket_bytes // 4)
    return max(q, budget_elems // rows // q * q)


def _resolve_algorithm(cfg, dp_total: int, rows: int, cols: int,
                       net=None) -> str:
    n = rows * cols
    if n < cfg.min_sparse_size:
        return "dense"
    if cfg.algorithm != "auto":
        algo = cfg.algorithm
        if rows > 1 and algo not in BATCHED_ALGORITHMS:
            algo = "dsar_split_allgather"   # batched pipeline: DSAR only
        return algo
    if net is None:
        raise ValueError(AUTO_NEEDS_NET)
    nnz = rows * (cols // cfg.bucket_size) * cfg.k_per_bucket
    allow = SPARSE_ALGORITHMS + ("dense",) if rows == 1 else BATCHED_ALGORITHMS
    return select_bucket_algorithm(
        dp_total, nnz, n, net,
        value_bits=(cfg.qsgd_bits if cfg.qsgd_bits is not None else 32),
        allow=allow)


def _chop(group_cols: int, cap: int, q: int) -> list[int]:
    out, remaining = [], group_cols
    while remaining > 0:
        take = min(cap, remaining)
        out.append(take)
        remaining -= take
    if any(c % q for c in out):
        raise ValueError(f"bucket widths {out} are not multiples of {q}")
    return out


def build_sync_plan(param_shapes, param_specs, cfg, dp_total: int,
                    net=None) -> SyncPlan:
    """The fused plan: every leaf rides a fusion bucket.

    param_shapes: a dict tree whose leaves have ``.shape`` (tensors, meta
    tensors included); param_specs: the same tree of spec tuples; ``net``:
    the ``NetworkParams`` that ``cfg.algorithm == "auto"`` selects on (not
    read otherwise). A bucket "auto" resolves to ``dense`` carries no EF
    state, as in the reference."""
    leaves, _ = tree_flatten(param_shapes)
    specs, _ = tree_flatten(param_specs)
    q = _col_quantum(cfg, dp_total)

    by_rows: dict[int, list[tuple[int, tuple, Any, int, int]]] = {}
    for i, (leaf, spec) in enumerate(zip(leaves, specs)):
        shape = tuple(leaf.shape)
        rows, cols = canonical_shape(shape, spec, cfg.bucket_size)
        by_rows.setdefault(rows, []).append((i, shape, spec, rows, cols))

    groups = []
    # flat group (rows == 1) first, then rowed groups by ascending rows
    for gid, rows in enumerate(sorted(by_rows, key=lambda r: (r != 1, r))):
        entries = by_rows[rows]
        slots, off = [], 0
        for i, shape, spec, r, cols in entries:
            slots.append(LeafSlot(i, shape, spec, r, cols, off))
            off += cols
        group_cols = -(-off // q) * q
        cap = _bucket_capacity_cols(cfg, dp_total, rows)
        buckets, start = [], 0
        for bi, bcols in enumerate(_chop(group_cols, cap, q)):
            algo = _resolve_algorithm(cfg, dp_total, rows, bcols, net)
            buckets.append(BucketSpec(f"g{gid}b{bi}", start, bcols, rows, algo))
            start += bcols
        model_sharded = rows > 1 and any(
            model_axis(spec) is not None for _, _, spec, _, _ in entries)
        groups.append(GroupSpec(gid, rows, model_sharded, group_cols,
                                tuple(slots), tuple(buckets)))
    mode = getattr(cfg, "output_mode", "replicated")
    if mode not in ("replicated", "scattered"):
        raise ValueError(f"unknown output_mode {mode!r}")
    return SyncPlan(cfg, dp_total, len(leaves), tuple(groups),
                    output_mode=mode)


# --------------------------------------------------------------------------
# Legacy per-leaf routing (behind core/compressor.py's per-leaf wrappers)
# --------------------------------------------------------------------------

def leaf_sparse_ok(shape, spec, cfg, dp_total: int) -> bool:
    """The per-leaf qualification rule of the pre-fusion pipeline: big
    enough (paper §8: N > 65k) and the per-row bucket count divides the
    split phase's group size (and, quantized, each shard whole QSGD
    buckets)."""
    if cfg.mode != "sparcml" or math.prod(shape) < cfg.min_sparse_size:
        return False
    _, cols = canonical_shape(tuple(shape), spec, cfg.bucket_size)
    if cfg.qsgd_bits is not None and (cols // dp_total) % cfg.qsgd_bucket:
        return False
    return (cols // cfg.bucket_size) % dp_total == 0


def build_per_leaf_plan(param_shapes, param_specs, cfg, dp_total: int,
                        net=None) -> SyncPlan:
    """One group and one bucket per qualifying leaf (legacy routing);
    leaves that fail :func:`leaf_sparse_ok` are not covered, and callers
    sum them densely. ``net``: as :func:`build_sync_plan`'s."""
    leaves, _ = tree_flatten(param_shapes)
    specs, _ = tree_flatten(param_specs)
    groups = []
    for i, (leaf, spec) in enumerate(zip(leaves, specs)):
        shape = tuple(leaf.shape)
        if not leaf_sparse_ok(shape, spec, cfg, dp_total):
            continue
        rows, cols = canonical_shape(shape, spec, cfg.bucket_size)
        gid = len(groups)
        algo = _resolve_algorithm(cfg, dp_total, rows, cols, net)
        bucket = BucketSpec(f"g{gid}b0", 0, cols, rows, algo)
        groups.append(GroupSpec(
            gid, rows, rows > 1 and model_axis(spec) is not None, cols,
            (LeafSlot(i, shape, spec, rows, cols, 0),), (bucket,)))
    return SyncPlan(cfg, dp_total, len(leaves), tuple(groups))


# --------------------------------------------------------------------------
# Serve-time activation plan (DESIGN.md §8)
# --------------------------------------------------------------------------
#
# The serving engine reuses the SyncPlan machinery for a different wire:
# instead of gradient fusion buckets reduced over the data axes, the unit
# is an ACTIVATION bucket — the (T, d) MoE combine buffer one decode step
# exchanges over the expert/model axis. The plan decides the bucket's
# wire representation per compiled decode step:
#
#   'dense'              the reference psum of the full (T, d) buffer;
#   'stream_gather@C'    a row-stream all-gather at fixed row capacity C
#                        (each rank ships its <=C active-token rows as
#                        (row idx, d-vector) items) — exact as long as
#                        the occupancy stays under C, which the engine's
#                        admission guard enforces.
#
# ServePlan duck-types the SyncPlan surface the adaptive runtime consumes
# (groups/buckets, algorithms, signature, replan, versioning), so the
# SAME AdaptiveController + signature-keyed compiled-step cache drive
# serve-side sparse<->dense dispatch swaps.

SERVE_STREAM = "stream_gather"


@dataclass(frozen=True)
class ServeSyncConfig:
    """Duck-typed stand-in for SyncConfig on the serve side (the adaptive
    controller only reads ``qsgd_bits`` — activation exchange ships
    unquantized rows)."""

    qsgd_bits: Optional[int] = None


@dataclass(frozen=True)
class ActivationBucketSpec:
    """One serve-time activation bucket: a (tokens, d) exchange buffer."""

    name: str
    tokens: int                   # decode slot count T
    d: int                        # model width (row length on the wire)
    algorithm: str                # 'dense' | 'stream_gather@<cap_rows>'
    # SyncPlan-bucket duck-typing for the adaptive controller: activation
    # buckets never ride a cross-pod phase.
    pod_sparse: bool = False

    @property
    def sparse(self) -> bool:
        return self.algorithm != "dense"

    @property
    def cap(self) -> Optional[int]:
        """Row capacity of the stream representation (None when dense)."""
        if not self.sparse:
            return None
        return int(self.algorithm.split("@", 1)[1])

    @property
    def n(self) -> int:
        return self.tokens * self.d

    @property
    def has_residual(self) -> bool:
        """No EF residual: the activation exchange is exact, not lossy."""
        return False

    @property
    def rows(self) -> int:
        return self.tokens


@dataclass(frozen=True)
class ServeGroupSpec:
    gid: int
    buckets: tuple

    @property
    def rows(self) -> int:
        """GroupSpec duck-typing for the adaptive controller (its
        cross-pod rules ask for flat groups; activation buckets always
        qualify — and carry no residual, so those rules skip them)."""
        return 1


@dataclass(frozen=True)
class ServePlan:
    """Wire plan for one decode-step configuration (T slots, width d)
    exchanged over the expert/model axis of size ``dp_total``.

    Versioned and re-derivable exactly like SyncPlan: ``replan`` with the
    telemetry window's mean active-token count re-selects the wire
    representation (and the stream capacity, which is PART of the
    algorithm tag and therefore of the signature — each capacity is its
    own compiled decode step)."""

    cfg: Any                      # ServeSyncConfig (duck-typed)
    dp_total: int                 # exchange-axis world size (p_model)
    tokens: int
    d: int
    groups: tuple
    min_cap: int = 4              # smallest stream capacity ever planned
    headroom: float = 2.0         # cap >= headroom * measured occupancy
    version: int = 0
    # every shard gets the whole sum (the SyncPlan's default mode; a serve
    # plan has no other)
    output_mode = "replicated"

    @property
    def buckets(self) -> tuple:
        return tuple(b for g in self.groups for b in g.buckets)

    def algorithms(self) -> dict[str, str]:
        return {b.name: b.algorithm for b in self.buckets}

    def pod_sparse_flags(self) -> dict[str, bool]:
        return {b.name: False for b in self.buckets}

    def signature(self) -> str:
        return ",".join(f"{b.name}={b.algorithm}" for b in self.buckets)

    def bucket_k(self, group, b) -> int:
        """The controller's per-bucket ``k`` — for activation buckets the
        ROW width d (``stream_gather`` costing is capacity x row)."""
        return b.d

    # -- selection ---------------------------------------------------------
    def _select(self, nnz_rows: float, net) -> str:
        """Wire representation at a measured occupancy: the smallest
        power-of-2 capacity with ``headroom`` over the measurement, if
        the stream bytes beat the dense allreduce bytes; dense otherwise.
        The ONE byte accounting shared with the executor's telemetry
        (cost_model.stream_wire_bytes)."""
        cap = max(self.min_cap,
                  round_up_pow2(int(math.ceil(nnz_rows * self.headroom))))
        if cap >= self.tokens:
            return "dense"
        sparse_bytes = stream_wire_bytes(self.dp_total, cap, self.d)
        dense_bytes = bucket_wire_bytes("dense", self.dp_total, self.d,
                                        self.tokens * self.d)
        return (f"{SERVE_STREAM}@{cap}" if sparse_bytes < dense_bytes
                else "dense")

    def replan(self, densities: Optional[dict] = None, net=None, *,
               algorithms: Optional[dict] = None,
               pod_sparse: Optional[dict] = None) -> "ServePlan":
        """Successor plan with re-selected wire representations.

        ``densities``: bucket name -> mean measured active-token count
        (the serve telemetry window). ``algorithms`` overrides win, as in
        SyncPlan.replan; ``pod_sparse`` is accepted for controller
        signature-compatibility and ignored (no cross-pod phase)."""
        new_groups = []
        for g in self.groups:
            new_buckets = []
            for b in g.buckets:
                if algorithms is not None:
                    algo = algorithms.get(b.name, b.algorithm)
                else:
                    nnz = None if densities is None else densities.get(b.name)
                    algo = b.algorithm if nnz is None else \
                        self._select(float(nnz), net)
                new_buckets.append(ActivationBucketSpec(
                    b.name, b.tokens, b.d, algo))
            new_groups.append(ServeGroupSpec(g.gid, tuple(new_buckets)))
        return dataclasses.replace(self, groups=tuple(new_groups),
                                   version=self.version + 1)

    def switch_forced(self, name: str, old: str, new: str,
                      nnz: Optional[float]) -> bool:
        """Correctness rule, never vetoed by hysteresis (the serve
        analogue of the delta switchover): once the measured occupancy
        reaches the CURRENT stream capacity, that representation can
        drop rows — it must move, whatever the modeled win."""
        if not old.startswith(SERVE_STREAM) or nnz is None:
            return False
        return nnz >= int(old.split("@", 1)[1])

    # -- analytic wire traffic (per rank per decode step) ------------------
    def wire_bytes(self) -> float:
        return sum(bucket_wire_bytes(b.algorithm, self.dp_total, b.d, b.n)
                   for b in self.buckets)

    def describe(self) -> str:
        head = (f"ServePlan v{self.version}: T={self.tokens} d={self.d} "
                f"p={self.dp_total}")
        return "\n".join([head] + [
            f"  {b.name}: algo={b.algorithm} wire={self.wire_bytes():.0f}B"
            for b in self.buckets])


def build_serve_plan(p_model: int, tokens: int, d: int, *,
                     algorithm: str = "dense", min_cap: int = 4,
                     headroom: float = 2.0) -> ServePlan:
    """The serve-time activation plan: ONE bucket (the per-step MoE
    combine buffer — every layer shares the geometry, so one wire
    decision covers the step). Starts dense unless told otherwise: dense
    is exact at every occupancy, and the adaptive controller demotes to
    a stream as soon as the measured occupancy says it pays."""
    bucket = ActivationBucketSpec("act0", tokens, d, algorithm)
    return ServePlan(ServeSyncConfig(), p_model, tokens, d,
                     (ServeGroupSpec(0, (bucket,)),),
                     min_cap=min_cap, headroom=headroom)
