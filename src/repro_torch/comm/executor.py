"""Plan executor: one TopK-compress + reduction per fusion bucket.

Both forms pack each group's leaves into one canonical (L, rows, cols)
buffer (L the ranks the caller holds), then per fusion bucket

    acc       =  residual + bucket slice      (error feedback, Alg. 2 line 1)
    stream, residual' = bucket_topk(acc)      (Alg. 2 line 2)

and each form runs only its own reduction (Alg. 2 line 3):

* the per-rank form (:func:`reduce_buckets`, :func:`execute_plan`, the
  JAX package's manual lowering) is the code each rank runs, talking to
  the others through a ``CollectiveContext``: its bucket loop
  (:func:`_buckets`) compresses one bucket at a time, and each bucket runs
  its planned algorithm of ``core/allreduce.py`` on the wire, with the
  clamp folds of the capacity-bound ones, over stacked ranks on one device
  or over ``torch.distributed``;
* the stacked-replica form (:func:`reduce_buckets_spmd`,
  :func:`execute_plan_spmd`, the reference's auto-SPMD formulation) holds
  all R ranks on a leading axis of one device's tensors, where a sum over
  that axis is the allreduce:

    reduced   =  sum over ranks of densify(stream)
                 (bucket_scatter_sum: one fused launch for every EF bucket
                 of a step, each pod's ranks summed in rank order)

  It dispatches a fusion group at a time, not a bucket: per group one
  pack and ONE grouped call (``bucket_topk_ef_grouped``) that adds the
  residual to the bucket's slice of the packed buffer inside the TopK
  kernel (the accumulator is never stored) for every EF bucket of the
  group, writing their streams into two step buffers (val, lidx) and
  their new residuals. Everything the plan fixes of the step (offsets,
  sizes, shapes, the checks and the kernels' descriptor arrays) is a
  :class:`_StepTable`, built once per plan; a step patches only pointers.
  SSAR algorithms reduce exactly, so in this form they fold into the same
  sum.

Raw-dense buckets (below ``min_sparse_size``) carry no residual and are
a plain sum. A bucket that carries a residual
(``BucketSpec.has_residual``) and whose algorithm a replan set to
``dense`` still compresses and feeds back: its TopK stream is densified
and summed over the ranks with no QSGD (the stacked form keeps it in the
grouped ``bucket_scatter_sum`` launch, the per-rank form sums the
densified stream). DSAR + QSGD buckets quantize every range owner's
shard of the sum (qsgd_pack: one grouped launch a step in the stacked
form, which reads the sums where they lie; one a bucket in the per-rank
form); their dequantization waits for the end of the loop, where ONE
grouped qsgd_unpack launch a step writes every such bucket's buffer, in
both forms. The stacked form's unpack also sums the pods and applies the
mean; the per-rank form's reads the codes as its allgather received them
and runs the pod phase and the mean after it, in the reference's order.

Telemetry (``telemetry=True``, the reference's default) adds, for every
EF bucket, a row of 4 f32 on the device: [post-reduction nnz, the wire
bytes ``cost_model.bucket_wire_bytes`` charges at that nnz, the mass
coverage ||topk||^2 / ||g + r||^2, the EF residual's norm ||r'||]. The
per-rank form sums the mass terms over the ranks with one extra psum a
bucket, as the reference does; the stacked form recomputes g + r for
each bucket's row (the fused kernel does not store it): the same f32 add,
so the same bits. No telemetry op runs when it is off, and none reads the
device from the host.

A scattered plan (``plan.scattered``, single pod) stops every bucket at
the owner shard: each reduced value is the (ranks, rows, cols/p) chunk
stack of ``plan.scattered_shapes`` instead of the replicated (rows, cols)
buffer. The per-rank form skips the gather phase (DSAR's allgather, the
portfolio algorithms' final gather; a QSGD shard still makes its round
trip, its unpack in the grouped launch), runs raw-dense and dense-EF
buckets as a column reduce-scatter (``psum_scatter``), and slices its own
columns off the classics' replicated results; each rank keeps only its
own chunk. The stacked form reshapes its sums into chunks: a view, and
for quantized buckets the grouped unpack writes the chunk layout itself
(one launch, no transpose after it). Residuals and clamp folds are full
width in both modes, so error feedback is the same.
:func:`unchunk_buckets_spmd` turns a chunk stack back into the buffer.

The QSGD rounding bits of bucket ``i`` come from ``rand_fn(i, n)``, which
returns n uint32 words laid out (p_pod, p_data, rows * shard) as the
reference's ``_qsgd_rand_all`` (the per-rank form: each held rank's own,
see :func:`reduce_buckets`). Both forms call it once for every quantized
bucket, in plan order. The train step draws them from a seeded
``torch.Generator`` (Philox on a CUDA device); tests pass the reference's
own bits instead. ``bucket_idx`` counts every bucket, dense ones too.

The serve side's executor is here too: :func:`exchange_activation` (per
rank, over a collectives context) and :func:`exchange_activation_spmd`
(stacked) sum a decode step's row-sparse (T, d) partials, dense or as row
streams of the ServePlan's capacity.
"""
from __future__ import annotations

import contextlib
import contextvars
import weakref
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch.comm.buckets import pack_group, unpack_group
from repro_torch.comm.collectives import (CollectiveContext, once_if_shared,
                                          ordered_sum)
from repro_torch.comm.plan import SyncPlan
from repro_torch.core import allreduce as ar
from repro_torch.core import sparse_stream as ss
from repro_torch.core.cost_model import (bucket_wire_bytes, parse_stream_cap,
                                         pod_wire_bytes)
from repro_torch.core.topk import UniformStream, compress2d
from repro_torch.kernels.bucket_scatter.kernel import ScatterSumTable
from repro_torch.kernels.bucket_scatter.ops import bucket_scatter_sum_table
from repro_torch.kernels.bucket_topk.kernel import EfTopkTable
from repro_torch.kernels.bucket_topk.ops import bucket_topk_ef_grouped
from repro_torch.kernels.qsgd_pack.kernel import PackTable
from repro_torch.kernels.qsgd_pack.ops import qsgd_pack_table
from repro_torch.kernels.qsgd_unpack.kernel import UnpackTable
from repro_torch.kernels.qsgd_unpack.ops import (qsgd_unpack_grouped,
                                                 qsgd_unpack_table)
from repro_torch.obs.trace import _NULL_SPAN

RandFn = Callable[[int, int], torch.Tensor]


class _EF:
    """One EF bucket in the loop: the accumulator, its TopK stream and the
    residual. A form drops ``acc`` and ``u`` when it is done with them, and
    may add a clamp fold into ``residual`` before it stores it."""

    __slots__ = ("acc", "u", "residual")


def _buckets(plan: SyncPlan, leaves: Sequence[torch.Tensor], residuals: dict):
    """The loop both forms run, in plan order. Yields (bucket_idx, group,
    bucket, seg, ef): ``seg`` the bucket's (L, rows, cols) slice of its
    packed group; ``ef`` None for a raw-dense bucket, else an :class:`_EF`
    with the EF add and the TopK compression done. The caller stores the
    residual (after any clamp fold) with :func:`_store_residual`."""
    cfg = plan.cfg
    bucket_idx = 0
    for group in plan.groups:
        buf = pack_group(group, leaves, cfg.bucket_size, batch_dims=1)
        for b in group.buckets:
            seg = buf[:, :, b.col_start:b.col_start + b.cols]
            if not b.has_residual:
                yield bucket_idx, group, b, seg, None
            else:
                res = residuals[b.name]                      # (L, rows, cols)
                ef = _EF()
                ef.acc = res.to(torch.float32) + seg         # Alg. 2 line 1
                ef.u, ef.residual = compress2d(              # Alg. 2 line 2
                    ef.acc, cfg.k_per_bucket, cfg.bucket_size, impl=cfg.impl)
                yield bucket_idx, group, b, seg, ef
            bucket_idx += 1


# the observability handle whose ``sparcml.reduce.buckets`` span wraps a
# form's bucket loop; None (no span) outside :func:`loop_spans`
_LOOP_OBS = contextvars.ContextVar("loop_obs", default=None)


@contextlib.contextmanager
def loop_spans(obs):
    """Within it, both forms' bucket loops record ``obs``'s
    ``sparcml.reduce.buckets`` span (the sparcml train step's reduce
    half; no other caller's loop records one)."""
    token = _LOOP_OBS.set(obs)
    try:
        yield
    finally:
        _LOOP_OBS.reset(token)


def _loop_span():
    obs = _LOOP_OBS.get()
    return _NULL_SPAN if obs is None else obs.span("sparcml.reduce.buckets")


def _store_residual(new_residuals: dict, residuals: dict, b, ef: _EF) -> None:
    """The bucket's new EF residual, in the dtype of its old one."""
    new_residuals[b.name] = ef.residual.to(residuals[b.name].dtype)


def _plan_order(plan: SyncPlan, d: dict) -> dict:
    return {b.name: d[b.name] for b in plan.buckets if b.name in d}


def _local_mass(ef: _EF, lead: Optional[int] = None) -> torch.Tensor:
    """[sum topk^2, sum (g+r)^2, sum r'^2] in f32 of a bucket of the loop,
    see :func:`_mass`."""
    return _mass(ef.u.val, ef.acc, ef.residual, lead)


def _mass(val: torch.Tensor, acc: torch.Tensor, residual: torch.Tensor,
          lead: Optional[int] = None) -> torch.Tensor:
    """[sum topk^2, sum (g+r)^2, sum r'^2] in f32, the summands of the
    coverage and EF-norm telemetry: (3,) over every axis, or (lead, 3),
    each held rank's own. Summed by ``torch.sum``, whose CPU reduction is
    pairwise (the CPU's 2-norm reduction is not, and drifts by 1e-5 to
    1e-3 over a bucket)."""
    def sq(x):
        x = x.to(torch.float32).square()
        return x.sum() if lead is None else x.reshape(lead, -1).sum(dim=1)
    return torch.stack([sq(val), sq(acc), sq(residual)], dim=-1)


def _bucket_telemetry(out: torch.Tensor, plan: SyncPlan, group, b,
                      p_data: int, p_pod: int, mass: torch.Tensor,
                      per_rank: bool = False,
                      coll: Optional[CollectiveContext] = None
                      ) -> torch.Tensor:
    """The (4,) f32 row of one EF bucket (see the module), or (L, 4) for
    the per-rank form's (L, rows, cols) ``out``, from the reduced sum
    ``out`` and the globally summed ``mass``. A scattered per-rank
    ``out`` is each rank's own chunk: its nnz is summed over ``coll``'s
    disjoint chunks. An all-zero accumulator counts as full coverage."""
    cfg = plan.cfg
    if per_rank:
        nnz = once_if_shared(lambda o: torch.count_nonzero(o, dim=(1, 2)),
                             out).to(torch.float32)
        if plan.scattered:
            nnz = coll.psum(nnz)
    else:
        nnz = torch.count_nonzero(out).to(torch.float32)
    k = plan.bucket_k(group, b)
    vb = cfg.qsgd_bits if cfg.qsgd_bits is not None else 32
    wire = bucket_wire_bytes(b.algorithm, p_data, k, b.n, nnz=nnz,
                             value_bits=vb, scattered=plan.scattered)
    if p_pod > 1:
        sparse_pod = b.pod_sparse and group.rows == 1
        wire = wire + pod_wire_bytes(p_pod, b.n, min(b.n, p_data * k),
                                     pod_sparse=sparse_pod)
    if not torch.is_tensor(wire):
        wire = torch.full_like(nnz, wire)
    covered, total, ef_sq = mass.unbind(-1)
    coverage = torch.where(total > 0, covered / total.clamp_min(1e-30),
                           torch.ones_like(total))
    return torch.stack([nnz, wire.to(torch.float32), coverage, ef_sq.sqrt()],
                       dim=-1)


class _Quantized(NamedTuple):
    """A DSAR + QSGD bucket's rounding bits: ``rand_fn(bucket_idx, n)``."""
    bucket_idx: int
    n: int


class _GroupStep(NamedTuple):
    """One fusion group of a step: its raw-dense buckets, its EF buckets'
    names and grouped EF-add + TopK table (None without EF buckets), and
    its quantized buckets' bits, all in plan order."""
    group: object
    dense: tuple
    ef_names: tuple
    topk: Optional[EfTopkTable]
    quantized: tuple


class _Reduced(NamedTuple):
    """Where an EF bucket's reduced buffer lies in a flat step buffer."""
    name: str
    group: object
    bucket: object
    off: int
    size: int
    shape: tuple


class _StepTable:
    """What ``plan`` fixes of the stacked reduce half over p_pod x p_data
    ranks, built once (:func:`_step_table`): per group the EF buckets'
    grouped EF-add + TopK table and the quantized buckets' bits, the
    step's stream buffers' size (EF buckets one after the other in plan
    order, each (R, rows, cols/B, k)), and the tables of the grouped
    densify + sum (every EF bucket), pack and unpack (the quantized ones),
    each reading the one before it where it wrote. ``plain``: the EF
    buckets summed without QSGD, their (p_pod, rows, cols) pod sums in the
    flat sums; ``outputs``: the quantized ones' reduced buffers in the
    flat unpack output."""

    def __init__(self, plan: SyncPlan, p_data: int, p_pod: int):
        cfg = plan.cfg
        qsgd = cfg.qsgd()
        bsz, k = cfg.bucket_size, cfg.k_per_bucket
        replicas = p_data * p_pod
        scale = 1.0 / replicas if cfg.mean else 1.0
        self.groups, ef = [], []
        bucket_idx = stream = 0
        for group in plan.groups:
            dense, names, spans, quantized = [], [], [], []
            for b in group.buckets:
                if not b.has_residual:
                    dense.append(b)
                else:
                    names.append(b.name)
                    spans.append((b.col_start, b.cols))
                    q = qsgd is not None and b.algorithm == \
                        "dsar_split_allgather"
                    ef.append((group, b, q))
                    if q:
                        quantized.append(_Quantized(
                            bucket_idx, p_pod * group.rows * b.cols))
                bucket_idx += 1
            topk = None
            if spans:
                topk = EfTopkTable(replicas, group.rows, group.cols, spans,
                                   bsz, k, stream_start=stream)
                stream = topk.stream_end
            self.groups.append(_GroupStep(group, tuple(dense), tuple(names),
                                          topk, tuple(quantized)))
        self.stream_total = stream
        self.quantized = [q for gs in self.groups for q in gs.quantized]
        self.scatter = ScatterSumTable(
            [(p_pod, p_data, g.rows * b.cols // bsz, k, bsz)
             for g, b, _ in ef])
        sums = list(zip(ef, self.scatter.out_off, self.scatter.out_sizes))
        self.plain = [_Reduced(b.name, g, b, off, size, (p_pod, g.rows, b.cols))
                      for (g, b, q), off, size in sums if not q]
        quant = [(g, b, off) for (g, b, q), off, _ in sums if q]
        self.pack = self.unpack = None
        self.outputs = []
        if quant:
            self.pack = PackTable(
                [(p_pod, p_data, g.rows, b.cols // p_data, qsgd.bucket_size)
                 for g, b, _ in quant], qsgd.bits,
                x_off=[off for _, _, off in quant])
            if plan.scattered:
                # the codes lie (rank, row, j): as p_data = 1 with p_data *
                # rows rows, the unpack writes the (p_data, rows, shard)
                # chunks
                geoms = [(1, 1, p_data * g.rows, b.cols // p_data,
                          qsgd.bucket_size, scale, False) for g, b, _ in quant]
            else:
                geoms = [(p_pod, p_data, g.rows, b.cols // p_data,
                          qsgd.bucket_size, scale, False) for g, b, _ in quant]
            self.unpack = UnpackTable(geoms, qsgd.bits,
                                      packed_off=self.pack.packed_off,
                                      scale_off=self.pack.scale_off)
            self.outputs = [
                _Reduced(b.name, g, b, off, size,
                         (p_data, g.rows, b.cols // p_data) if plan.scattered
                         else (g.rows, b.cols))
                for (g, b, _), off, size in zip(quant, self.unpack.out_off,
                                                self.unpack.out_sizes)]

    @property
    def topk_launches(self) -> int:
        """The bucket_topk kernels a step launches on the card."""
        return sum(gs.topk.launches for gs in self.groups if gs.topk)


# (id(plan), p_data, p_pod) -> (a weak reference to the plan, its table):
# a plan is immutable, so its table is built on its first step only
_TABLES: dict = {}


def _step_table(plan: SyncPlan, p_data: int, p_pod: int) -> _StepTable:
    key = (id(plan), p_data, p_pod)
    hit = _TABLES.get(key)
    if hit is not None and hit[0]() is plan:
        return hit[1]
    table = _StepTable(plan, p_data, p_pod)

    def forget(ref, key=key):
        if _TABLES.get(key, (None,))[0] is ref:
            del _TABLES[key]
    _TABLES[key] = (weakref.ref(plan, forget), table)
    return table


def topk_launches_spmd(plan: SyncPlan, p_data: int, p_pod: int = 1) -> int:
    """The bucket_topk kernels one step of :func:`reduce_buckets_spmd`
    launches on the card under ``plan``: one for every
    ``MAX_EF_SEGS`` EF buckets of each fusion group."""
    return _step_table(plan, p_data, p_pod).topk_launches


def reduce_buckets_spmd(
    plan: SyncPlan,
    leaves_r: Sequence[torch.Tensor],
    residuals: dict,
    *,
    p_data: int,
    p_pod: int = 1,
    rand_fn: Optional[RandFn] = None,
    telemetry: bool = True,
):
    """The REDUCE half in the stacked-replica form.

    leaves_r: per-rank grads stacked as (R, *leaf_shape), R = p_pod*p_data.
    residuals: bucket-keyed (R, rows, cols) error-feedback tensors.
    Returns (reduced {bucket name -> (rows, cols) f32 buffer, or a
    scattered plan's (p_data, rows, cols/p_data) owner chunks}, new
    bucket-keyed residuals, telemetry {EF bucket name -> (4,) f32}; the
    last is empty when ``telemetry`` is off). The mass sums need no
    collective here: the (R, ...) stacks hold every rank. A quantized
    bucket's nnz is counted on its buffer after the mean (the grouped
    unpack fuses it), which is the count of the sum but for products below
    the smallest denormal.

    A fusion group at a time (the ``sparcml.reduce.buckets`` span): pack
    it, ONE grouped EF-add + TopK call for all its EF buckets (their
    streams into the step's two stream buffers), the bits of its quantized
    buckets, and the packed buffer is freed before the next group's pack.
    After the groups, ONE grouped bucket_scatter_sum launch writes every
    EF bucket's pod sums (each pod's p_data ranks densified and added in
    rank order) into one step buffer, ONE grouped qsgd_pack reads the
    quantized buckets' sums where they lie, and ONE grouped qsgd_unpack
    writes their reduced buffers. The pod sums are added in pod order,
    and raw-dense buckets sum each pod's ranks and then the pods the same
    way: every sum over ranks runs in the per-rank form's order (its
    data-axis psum, then its pod psum), so the two forms give the same
    bits."""
    cfg = plan.cfg
    replicas = p_data * p_pod
    if leaves_r and leaves_r[0].shape[0] != replicas:
        raise ValueError(f"leaves carry {leaves_r[0].shape[0]} ranks, the "
                         f"plan is for {replicas}")
    scattered = plan.scattered
    if scattered and p_pod > 1:
        raise ValueError("the scattered output mode is single-pod only "
                         "(p_pod == 1)")
    tab = _step_table(plan, p_data, p_pod)
    if tab.quantized and rand_fn is None:
        raise ValueError("QSGD needs stochastic-rounding bits: pass rand_fn")
    scale = 1.0 / replicas if cfg.mean else 1.0
    qsgd = cfg.qsgd()
    own = _chunked if scattered else (lambda out, p: out)

    reduced: dict = {}
    new_residuals: dict = {}
    telem: dict = {}
    mass: dict = {}
    rands = []
    with _loop_span():
        val = lidx = None
        if tab.stream_total:
            dev = leaves_r[0].device
            val = torch.empty(tab.stream_total, dtype=torch.float32,
                              device=dev)
            lidx = torch.empty(tab.stream_total, dtype=torch.int32,
                               device=dev)
        for gs in tab.groups:
            buf = pack_group(gs.group, leaves_r, cfg.bucket_size,
                             batch_dims=1).contiguous()
            for b in gs.dense:       # over each pod's ranks, then the pods
                seg = buf[:, :, b.col_start:b.col_start + b.cols]
                by_pod = seg.reshape((p_pod, p_data) + tuple(seg.shape[1:]))
                reduced[b.name] = own(
                    ordered_sum(ordered_sum(by_pod, 1), 0) * scale, p_data)
            if gs.topk is not None:
                old = [residuals[name] for name in gs.ef_names]
                res = [r if r.dtype == torch.float32 else r.to(torch.float32)
                       for r in old]
                new = bucket_topk_ef_grouped(gs.topk, res, buf, val, lidx,
                                             impl=cfg.impl)
                for name, r_old, r in zip(gs.ef_names, old, new):
                    new_residuals[name] = (r if r.dtype == r_old.dtype
                                           else r.to(r_old.dtype))
                if telemetry:               # Alg. 2 line 1 again, for the row
                    for name, r0, r, (cs, cols), off, n in zip(
                            gs.ef_names, res, new, gs.topk.spans,
                            gs.topk.stream_off, gs.topk.stream_sizes):
                        mass[name] = _mass(val[off:off + n],
                                           r0 + buf[:, :, cs:cs + cols], r)
            for q in gs.quantized:
                rands.append(rand_fn(q.bucket_idx, q.n))
            del buf
    if not tab.stream_total:
        return _plan_order(plan, reduced), new_residuals, {}

    sums = bucket_scatter_sum_table(tab.scatter, lidx, val, impl=cfg.impl)
    del val, lidx
    for r in tab.plain:
        out = ordered_sum(sums[r.off:r.off + r.size].view(r.shape), 0)
        reduced[r.name] = own(out * scale, p_data)
        if telemetry:
            telem[r.name] = _bucket_telemetry(out, plan, r.group, r.bucket,
                                              p_data, p_pod, mass[r.name])
    if tab.pack is not None:
        packed, sc = qsgd_pack_table(tab.pack, sums, rands, qsgd.scale_mode,
                                     impl=cfg.impl)
        del sums, rands                 # only the codes wait for the unpack
        outs = qsgd_unpack_table(tab.unpack, packed, sc, impl=cfg.impl)
        del packed, sc
        for r in tab.outputs:
            out = outs[r.off:r.off + r.size].view(r.shape)
            reduced[r.name] = out
            if telemetry:
                telem[r.name] = _bucket_telemetry(out, plan, r.group,
                                                  r.bucket, p_data, p_pod,
                                                  mass[r.name])
    return (_plan_order(plan, reduced), new_residuals,
            _plan_order(plan, telem))


def _chunked(out: torch.Tensor, p: int) -> torch.Tensor:
    """(rows, cols) sum -> its (p, rows, cols/p) owner chunks: a view."""
    rows, cols = out.shape
    return out.view(rows, p, cols // p).permute(1, 0, 2)


def unchunk_buckets_spmd(plan: SyncPlan, reduced: dict) -> dict:
    """Scattered (p, rows, w) owner-chunk stacks -> the replicated (rows,
    cols) buffers (other keys pass through): the inverse of the stacked
    form's chunking, a view where the chunks are one, else a copy."""
    out = dict(reduced)
    for b in plan.buckets:
        ch = reduced[b.name]
        p, rows, w = ch.shape
        out[b.name] = ch.permute(1, 0, 2).reshape(rows, p * w)
    return out


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
                    f"got {tuple(reduced[b.name].shape)} for {b.name} "
                    "(scattered chunks feed the shard update, or "
                    "unchunk_buckets_spmd)")
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
    reduced, new_residuals, _ = reduce_buckets_spmd(
        plan, leaves_r, residuals, p_data=p_data, p_pod=p_pod,
        rand_fn=rand_fn, telemetry=False)
    return apply_buckets_spmd(plan, reduced, leaves_r), new_residuals


# --------------------------------------------------------------------------
# Per-rank form (the reference's manual lowering)
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


def _own_cols(dense: torch.Tensor, coll: CollectiveContext) -> torch.Tensor:
    """Each held rank's own (L, n/p) range of a replicated (L, n) result."""
    lead, n = dense.shape
    w = n // coll.p
    rank = coll.axis_rank().view(lead, 1, 1).expand(lead, 1, w)
    return torch.gather(dense.view(lead, coll.p, w), 1, rank)[:, 0]


def _reduce_flat_sparse(u_flat: UniformStream, algorithm: str, *,
                        coll: CollectiveContext, impl: str = "auto",
                        scatter: bool = False):
    """SSAR variants for flat (rows == 1) buckets; returns (dense (L, n),
    fold). ``fold`` is the capacity-clamped pre-scale mass of the
    portfolio algorithms, which the caller adds into the bucket's
    error-feedback residual (the global-residual rule), and None for the
    unclamped classics. ``scatter`` returns each rank's own (L, n/p)
    shard instead: the portfolio algorithms stop there (their final
    gather never runs); the classics have no reduce-scatter form, so they
    reduce replicated and slice (no wire saving)."""
    n = u_flat.n
    if algorithm == "ssar_recursive_double":
        out = ar.ssar_recursive_double_inside(u_flat.to_stream(), coll=coll,
                                              n=n).to_dense(n)
        return (_own_cols(out, coll) if scatter else out), None
    if algorithm == "ssar_split_allgather":
        out = ss.densify(ar.ssar_split_allgather_inside(u_flat, coll=coll), n)
        return (_own_cols(out, coll) if scatter else out), None
    if algorithm == "ssar_balanced_split":
        return ar.ssar_balanced_split_inside(u_flat, coll=coll, impl=impl,
                                             scatter=scatter)
    if algorithm == "ssar_rearranged_rs":
        return ar.ssar_rearranged_rs_inside(u_flat, coll=coll,
                                            scatter=scatter)
    raise ValueError(f"not a flat sparse algorithm: {algorithm!r}")


def reduce_buckets(
    plan: SyncPlan,
    leaves: Sequence[torch.Tensor],
    residuals: dict,
    *,
    coll: CollectiveContext,
    pod_coll: Optional[CollectiveContext] = None,
    rand_fn: Optional[RandFn] = None,
    telemetry: bool = True,
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
    replicated sum, broadcast (stride 0) where the stacked ranks share
    one; a scattered plan's (L, rows, cols/p) own chunks}, new residuals,
    telemetry {EF bucket name -> (L, 4) f32, the same row on every rank};
    empty when ``telemetry`` is off)."""
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
    scattered = plan.scattered
    if scattered and pod_coll is not None:
        raise ValueError("the scattered output mode is single-pod only: the "
                         "owner shard of the cross-pod sum is local to no pod")
    scale = 1.0 / plan.dp_total if cfg.mean else 1.0
    qsgd = cfg.qsgd()

    reduced: dict = {}
    new_residuals: dict = {}
    telem: dict = {}
    mass: dict = {}
    pending: dict = {}              # bucket name -> (group, bucket, gather)

    def finish(group, b, out):
        """The pod phase, the mean and the telemetry row of one EF
        bucket's sum over the data axis."""
        if pod_coll is not None:
            if b.pod_sparse and group.rows == 1:
                cap = min(b.n, p_data * plan.bucket_k(group, b))
                out = _pod_sparse_exchange(out, pod_coll, cap)
            else:
                out = pod_coll.psum(out)                     # hierarchical
        reduced[b.name] = once_if_shared(lambda o: o * scale, out)
        if telemetry:
            telem[b.name] = _bucket_telemetry(out, plan, group, b, p_data,
                                              p_pod, mass[b.name],
                                              per_rank=True, coll=coll)

    def dense_sum(x):
        """Over the data axis: every rank the sum, or its own columns."""
        return coll.psum_scatter(x, axis=1) if scattered else coll.psum(x)

    with _loop_span():
        for bucket_idx, group, b, seg, ef in _buckets(plan, leaves, residuals):
            if ef is None:
                out = dense_sum(seg)
                if pod_coll is not None:
                    out = pod_coll.psum(out)
                reduced[b.name] = once_if_shared(lambda o: o * scale, out)
                continue
            fold = None
            if b.algorithm == "dense":
                # a dense end-representation of the compressed stream (paper
                # §5.3.3): the densified TopK summed over the axis, no QSGD
                out = dense_sum(ef.u.densify(impl=cfg.impl))
            elif b.algorithm == "dsar_split_allgather":     # Alg. 2 line 3
                rand = None
                if qsgd is not None:
                    if rand_fn is None:
                        raise ValueError("QSGD needs stochastic-rounding "
                                         "bits: pass rand_fn")
                    rand = rand_fn(bucket_idx,
                                   lead * group.rows * b.cols // p_data)
                out = ar.dsar_split_allgather_batched_inside(
                    ef.u, coll=coll, qsgd=qsgd, rand=rand, impl=cfg.impl,
                    scatter=scattered)
            else:
                # SSAR keeps a sparse end-representation; flat rows only.
                assert group.rows == 1, (b.name, b.algorithm)
                flat = UniformStream(ef.u.lidx[:, 0], ef.u.val[:, 0],
                                     cfg.bucket_size)
                out, fold = _reduce_flat_sparse(
                    flat, b.algorithm, coll=coll, impl=cfg.impl,
                    scatter=scattered)
                out = out[:, None, :]
            if fold is not None:
                # Global-residual rule: mass clamped off the wire re-enters
                # THIS rank's residual at pre-scale magnitude, so it is
                # contributed exactly once on a later step (and the EF norm
                # below covers it).
                ef.residual = ef.residual + fold[:, None, :]
            _store_residual(new_residuals, residuals, b, ef)
            if telemetry:
                m = coll.psum(_local_mass(ef, lead))
                mass[b.name] = pod_coll.psum(m) if pod_coll is not None else m
            ef.acc = ef.u = None
            if isinstance(out, ar.PendingUnpack):
                pending[b.name] = (group, b, out)
            else:
                finish(group, b, out)
    if pending:
        bufs = qsgd_unpack_grouped([pu.segment for _, _, pu in
                                    pending.values()], qsgd.bits,
                                   impl=cfg.impl)
        for (group, b, pu), buf in zip(pending.values(), bufs):
            finish(group, b, pu.result(buf))
    return (_plan_order(plan, reduced), new_residuals,
            _plan_order(plan, telem))


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
    reduced, new_residuals, _ = reduce_buckets(
        plan, leaves, residuals, coll=coll, pod_coll=pod_coll,
        rand_fn=rand_fn, telemetry=False)
    first = {name: v[0] for name, v in reduced.items()}
    return apply_buckets(plan, first, [l[0] for l in leaves]), new_residuals


# --------------------------------------------------------------------------
# Serve-time activation exchange (DESIGN.md §8)
# --------------------------------------------------------------------------
#
# The decode-time MoE combine is an allreduce of a (T, d) buffer over the
# expert/model axis whose per-shard partial is ROW-sparse: token row t is
# nonzero only when token t is active AND routed one of its experts to
# this shard. The ServePlan (comm/plan.py) picks the wire representation
# per decode step; these two functions are its executor.
#
# Exactness contract: the stream path computes THE SAME SUM as the dense
# path, bit for bit, as long as every shard's nonzero row count stays
# under the stream capacity, because its summands are the partials
# themselves and both sum them in rank order.


def _row_stream_roundtrip(partial: torch.Tensor, cap: int) -> torch.Tensor:
    """(*lead, T, d) partials -> row streams at capacity ``cap`` -> dense
    again: the identity, bit for bit, while each has at most cap nonzero
    rows, so a capacity overflow shows as a parity break, not silence."""
    mask = torch.any(partial != 0, dim=-1)
    return ss.densify_rows(ss.from_row_mask(partial, mask, cap),
                           partial.shape[-2])


def exchange_activation(partial: torch.Tensor, algorithm: str, *,
                        coll: CollectiveContext) -> torch.Tensor:
    """Each held rank's (T, d) combine partial, (L, T, d) -> the sum over
    the ranks of ``coll``'s axis, (L, T, d).

    'dense': ``coll.psum``. 'stream_gather@C': the planned (idx, val)
    row-stream exchange: every rank all-gathers the others' streams of
    capacity C, densifies each and sums them in rank order, as ``psum``
    sums the partials. The JAX package's psum-only emulation of this
    exchange (``native=False``) is not ported, as for every collective."""
    if algorithm == "dense":
        return coll.psum(partial)
    cap = parse_stream_cap(algorithm)
    t = partial.shape[-2]
    stream = ss.from_row_mask(partial, torch.any(partial != 0, dim=-1), cap)
    idx_all = coll.all_gather(stream.idx[:, None], axis=0)   # (L, p, cap)
    val_all = coll.all_gather(stream.val[:, None], axis=0)   # (L, p, cap, d)
    dense_all = ss.densify_rows(
        ss.RowStream(idx_all, val_all, stream.nnz), t)       # (L, p, T, d)
    return once_if_shared(lambda x: ordered_sum(x, 1), dense_all)


def exchange_activation_spmd(partials: torch.Tensor,
                             algorithm: str) -> torch.Tensor:
    """The stacked form of :func:`exchange_activation`: the shard axis is
    a leading axis (p, T, d), shard s's partial its s-th slice, and the
    sum over it (in shard order) the exchange. The stream path round-trips
    each shard's partial through its row stream first: the same summands
    as the dense path while under capacity, so sparse == dense exactly."""
    if algorithm != "dense":
        partials = _row_stream_roundtrip(partials,
                                         parse_stream_cap(algorithm))
    return ordered_sum(partials, 0)
