"""train_step builder: dense and sparcml (paper Alg. 2) gradient sync with
microbatch accumulation.

sparcml mode: the global batch splits into R = dp_total rank slices,
every rank's gradients are computed on its slice against the same params
by ``torch.func.vmap`` over the rank axis (the reference's ``jax.vmap``),
stacked on a leading (R,) axis, and the plan executor syncs them in one
of two lowerings:

* ``"spmd"`` (the JAX package's auto-SPMD path): ``execute_plan_spmd``
  runs bucketed top-k with per-rank error feedback, the sum over ranks
  (the allreduce) and the optional QSGD round trip;
* ``"manual"`` (its shard_map path): the per-rank ``execute_plan`` over a
  ``CollectiveContext``, so every bucket runs its planned algorithm's wire
  protocol (all_to_all split, owner densify, allgather, QSGD on the
  wire): a ``StackedCollectives`` of the R ranks on one device, or a
  ``ProcessGroupCollectives`` over ``torch.distributed`` with one rank a
  process. There each process takes its slice of the global batch, the
  loss is the mean over ranks, each rank draws its own QSGD bits (seeded
  by its rank: its slice of what the stacked ranks draw, see
  :class:`StepBits`), and the params start identical from the seed, so
  the run gives the stacked run's bits.

Then the synced gradients are clipped and the optimizer updates the
single params copy, its moments in one of three layouts
(``checkpoint.opt_layout_of``):

* "full": param-shaped moments (dense mode, or ``zero1=False``);
* "zero1_leaf" (ZeRO-1, the default in sparcml mode): each leaf's moments
  as (ranks, rows, cols/dp) chunks of its canonical layout; rank r updates
  its column range of the parameter, and one ``all_gather`` a leaf
  rebuilds it on the per-rank path. The stacked ranks update every chunk
  at once on views of the leaves (a chunk of an unpadded canonical leaf
  is a view of its memory), with AdamW's ops in ``adamw``'s order, so the
  values are those of the full layout bit for bit where the second clip
  of ``opt_update`` changes nothing (the reference clips once here too);
* "zero_scattered" (``output_mode="scattered"``, needs ``zero1``): the
  reduce stops at each rank's owned chunk of every bucket, the moments
  are (ranks, rows, cols/dp) chunks a bucket, and the update runs on the
  chunk. Per rank the grad norm comes from the chunks (one psum of
  per-shard sums) and one param ``all_gather`` a bucket rebuilds the
  parameters; the stacked ranks rebuild the synced leaves, clip them as
  the replicated step does, and update in the reference's delta form.

dense mode: with ``lowering="spmd"`` and no context, the gradients of
the global batch, clipped, optimizer update (the reference's jit). Under
the manual lowering each held rank takes its part of every microbatch
(:func:`microbatch_rows`: the reference's global microbatch split in
rank order; a MoE layer keeps the reference's tokens through
``moe.shared_capacity``) and its accumulated f32 grads
(``rank_grads``), the grads are summed over
the ranks in rank order (the context's ``psum``: an all_to_all, an owner
sum and an all_gather) and divided by p, then clipped and applied: over
``StackedCollectives(p)`` on one device, or one rank a process over a
``ProcessGroupCollectives``, bit-equal. ``TrainConfig.fsdp`` (ZeRO-3)
always runs that per-rank form (the stacked ranks unless a context is
given): params and moments live as each held rank's shards
(``models.specs.fsdp_layout``), one ``all_gather`` a leaf rebuilds the
params before the forward (:func:`gather_params`), the grads are
reduce-scattered in rank order (``psum_scatter``) so each rank gets its
shard of the sum, the global norm is the rank-order sum of the shards'
squared norms (plus the whole leaves'), and AdamW updates each shard
(:func:`fsdp_update`).

The chaos harness's injection (``inject_nonfinite_leaves``) is a select on
the raw grads before the reduce half: an all-zero fault vector gives the
uninjected bits.

The model's backward is PyTorch autograd over plain tensor code, as the
JAX package leaves it to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch.comm.buckets import (from_canonical, pack_group,
                                      to_canonical, unpack_group)
from repro_torch.comm.collectives import (CollectiveContext,
                                          StackedCollectives)
from repro_torch.comm.executor import (RandFn, apply_buckets_spmd,
                                       reduce_buckets, reduce_buckets_spmd,
                                       unchunk_buckets_spmd)
from repro_torch.comm.plan import SyncPlan, build_sync_plan
from repro_torch.core.qsgd import random_bits
from repro_torch.device import resolve_device
from repro_torch.kernels.bucket_topk.ops import check_bucket_size
from repro_torch.models.model import Model, init_params
from repro_torch.models.moe import shared_capacity
from repro_torch.models.specs import FsdpLeaf, fsdp_layout, param_specs
from repro_torch.optim.optimizers import (_bias_corrections,
                                          clip_by_global_norm, init_opt_state,
                                          opt_update)
from repro_torch.optim.schedule import make_schedule
from repro_torch.train.checkpoint import one_rank_a_process, opt_layout_of
from repro_torch.train.state import TrainConfig, TrainState
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


def check_layout(tcfg: TrainConfig) -> None:
    """The reference's rules: the scattered output mode needs the sparcml
    plan and is the sharded-optimizer layout, so it needs zero1."""
    if tcfg.sync.output_mode == "scattered":
        if tcfg.sync.mode != "sparcml":
            raise ValueError("output_mode='scattered' requires "
                             "sync.mode='sparcml' (dense mode has no plan to "
                             "scatter)")
        if not tcfg.zero1:
            raise ValueError("output_mode='scattered' is the sharded-"
                             "optimizer layout: it requires zero1=True")


def resolves_auto(tcfg: TrainConfig) -> bool:
    """Whether the config's plan selects its algorithms by the cost model
    (sparcml with ``algorithm="auto"``): its plan needs network
    parameters."""
    return tcfg.sync.mode == "sparcml" and tcfg.sync.algorithm == "auto"


def build_plan(model: Model, tcfg: TrainConfig, dp_total: int,
               net=None) -> Optional[SyncPlan]:
    """The sync plan of a sparcml config (None in dense mode), built from
    shapes only; ``net``: the ``NetworkParams`` "auto" selects on."""
    check_layout(tcfg)
    if tcfg.sync.mode != "sparcml":
        return None
    pshapes = init_params(model.cfg, device="meta")
    return build_sync_plan(pshapes, param_specs(pshapes, model.cfg),
                           tcfg.sync, dp_total, net)


def check_replan(plan: SyncPlan, base: SyncPlan) -> None:
    """Raises unless ``plan`` keeps ``base``'s residual and in-flight
    layout, as every ``base.replan()`` does."""
    if (plan.residual_shapes() != base.residual_shapes()
            or plan.inflight_shapes() != base.inflight_shapes()):
        # full name -> shape maps: a plan of another configuration can
        # reuse the g<i>b<j> names with other shapes
        raise ValueError(
            "the plan changes the residual or in-flight layout: a "
            "replanned plan must come from SyncPlan.replan() of this "
            "configuration's base plan")


def _slots(plan: SyncPlan) -> list:
    """The plan's leaf slots, indexed by leaf id."""
    out = [None] * plan.num_leaves
    for g in plan.groups:
        for slot in g.slots:
            out[slot.leaf_id] = slot
    return out


def opt_shapes(tcfg: TrainConfig, plan: SyncPlan, paths,
               layout: str) -> dict:
    """A ZeRO layout's moment shapes, {"mu": ..., ["nu": ...]}: the param
    tree (``paths``, as ``tree_flatten`` gives them) of per-leaf (dp,
    rows, cols/dp) canonical chunks ("zero1_leaf", the reference's
    ``zero1_state_shapes``), or bucket name -> (dp, rows, cols/dp) owned
    chunks ("zero_scattered", its ``zero_scattered_state_shapes``)."""
    p = plan.dp_total
    if layout == "zero1_leaf":
        slots = _slots(plan)
        for s in slots:
            if s.cols % p:
                raise ValueError(f"leaf {s.leaf_id}: {s.cols} canonical "
                                 f"columns do not split over {p} ranks")
        moments = lambda: tree_unflatten(paths, [(p, s.rows, s.cols // p)
                                                 for s in slots])
    elif layout == "zero_scattered":
        moments = lambda: dict(plan.scattered_shapes())
    else:
        raise ValueError(f"unknown opt layout {layout!r}")
    out = {"mu": moments()}
    if tcfg.optimizer.kind == "adamw":
        out["nu"] = moments()
    return out


def init_opt(params, tcfg: TrainConfig, plan: Optional[SyncPlan], device,
             ranks: Optional[int] = None, layout: Optional[str] = None
             ) -> dict:
    """Zero optimizer state in ``layout`` (the config's by default); the
    ZeRO chunks for the ``ranks`` the process holds (all by default)."""
    layout = layout or opt_layout_of(tcfg)
    if layout == "full":
        return init_opt_state(params, tcfg.optimizer)
    shapes = opt_shapes(tcfg, plan, tree_flatten(params)[1], layout)
    dtype = tcfg.optimizer.state_dtype

    def zeros(shape):
        if ranks is not None:
            shape = (ranks,) + tuple(shape[1:])
        return torch.zeros(shape, dtype=dtype, device=device)

    out = {k: (tree_map(zeros, v) if layout == "zero1_leaf"
               else {n: zeros(sh) for n, sh in v.items()})
           for k, v in shapes.items()}
    out["count"] = torch.zeros((), dtype=torch.int32, device=device)
    return out


def init_state(model: Model, tcfg: TrainConfig, plan: Optional[SyncPlan],
               device="cuda", params=None,
               coll: Optional[CollectiveContext] = None,
               dp_total: Optional[int] = None) -> TrainState:
    """Fresh state: params from a generator seeded with ``tcfg.seed`` (or
    the given whole ``params``), zero optimizer moments in the config's
    layout and zero EF residuals, for the ranks the process holds (all of
    them unless ``coll`` says otherwise). Under fsdp the params become the
    held ranks' shards over ``coll.p`` ranks (``dp_total`` without a
    context) and the moments take the shards' shapes."""
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
        params = model.init(gen, dev)
    if tcfg.fsdp:
        p = coll.p if coll is not None else dp_total
        if p is None:
            raise ValueError("fsdp shards over the ranks: pass coll or "
                             "dp_total")
        params = shard_params(params, fsdp_layout_of(model, p),
                              held_ranks(coll, p))
    ranks = coll.local_ranks if coll is not None else None
    res = plan.init_residuals(dev, ranks) if plan is not None else None
    return TrainState(params, init_opt(params, tcfg, plan, dev, ranks), res,
                      0)


# --------------------------------------------------------------------------
# fsdp (ZeRO-3): params and moments as each held rank's shards
# --------------------------------------------------------------------------

def fsdp_layout_of(model: Model, p: int) -> dict:
    """The fsdp shard layout of the model's params over p ranks (from
    shapes only)."""
    return fsdp_layout(init_params(model.cfg, device="meta"), model.cfg, p)


def held_ranks(coll: Optional[CollectiveContext], p: int) -> list:
    """The ranks whose shards this process holds: all p (stacked), or its
    own (one rank a process)."""
    return [coll.rank] if one_rank_a_process(coll) else list(range(p))


def shard_params(params: dict, layout: dict, ranks) -> dict:
    """Whole params -> the ``ranks``' fsdp shards, (len(ranks), *shard) a
    sharded leaf, whole where the layout replicates (each shard a copy:
    the whole leaf can be freed)."""
    return tree_map(lambda x, lay: lay.cut(x, ranks), params, layout)


def gather_leaf(x: torch.Tensor, lay: FsdpLeaf, coll: CollectiveContext,
                lead: int = 0) -> torch.Tensor:
    """One leaf whole from the held ranks' shards ``x`` (L, *shard): one
    ``all_gather`` over its sharded dim, the padding cut off. ``lead``:
    stack axes already indexed away (one layer of a stacked leaf). A
    replicated leaf comes back as given."""
    if lay.dim is None:
        return x
    lay = lay._replace(dim=lay.dim - lead)
    return lay.unpad(coll.all_gather(x, axis=lay.dim)[0])


def gather_params(shards: dict, layout: dict,
                  coll: CollectiveContext) -> dict:
    """The whole params from the held ranks' fsdp shards: one
    ``all_gather`` a sharded leaf, the padding cut off."""
    return tree_map(lambda x, lay: gather_leaf(x, lay, coll), shards,
                    layout)


def _subtree(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


class FsdpParams:
    """fsdp serving's params: the held ranks' shards (``shard_params``),
    read by the model's prefill and decode step as a params dict whose
    sharded parts are gathered on access. ``params["blocks"]`` is a
    :class:`_GatheredLayers` view: the model takes the stacked layers one
    at a time from it (``models.model._layers``), and each layer is
    gathered when the model first reads it. One gathered copy is held at
    a time (a layer, the shared block, the head): the previous one is
    dropped before the next is gathered, so a rank holds its shards plus
    one gathered layer. Leaves the layout replicates (norms, the
    embedding) are read as held, with no collective."""

    def __init__(self, shards: dict, layout: dict, coll: CollectiveContext):
        self._shards, self._layout, self._coll = shards, layout, coll
        self._key, self._held = None, None

    def __getitem__(self, key):
        if key == "blocks":
            return _GatheredLayers(self, ("blocks",), ())
        return self.gathered((key,), ())

    def gathered(self, path: tuple, index: tuple):
        """The subtree at ``path``, layer ``index`` of its stacked leaves,
        whole."""
        lays = _subtree(self._layout, path)
        sub = _subtree(self._shards, path)
        pick = lambda x, lay: x[index] if lay.dim is None \
            else x[(slice(None),) + index]  # noqa: E731
        # a leaf (the head) or a subtree (a layer)
        each = (lambda fn: tree_map(fn, sub, lays)) if isinstance(sub, dict) \
            else (lambda fn: fn(sub, lays))  # noqa: E731
        if all(lay.dim is None for lay in tree_flatten(lays)[0]):
            return each(pick)
        if self._key != (path, index):
            self._key, self._held = None, None   # free it before the next
            self._held = each(lambda x, lay: gather_leaf(
                pick(x, lay), lay, self._coll, len(index)))
            self._key = (path, index)
        return self._held


class _GatheredLayers:
    """A stack of layers under ``path`` of an :class:`FsdpParams`, at the
    stack index ``index`` so far: ``layers(n)`` gives its n layers (or
    sub-stacks, for a two-axis stack), and indexing a layer reads its
    gathered params."""

    def __init__(self, src: FsdpParams, path: tuple, index: tuple):
        self._src, self._path, self._index = src, path, index

    def layers(self, n: int) -> list:
        return [_GatheredLayers(self._src, self._path, self._index + (i,))
                for i in range(n)]

    def __getitem__(self, key):
        if not self._index:          # a named stack (the vlm's "selfs")
            return _GatheredLayers(self._src, self._path + (key,), ())
        return self._src.gathered(self._path, self._index)[key]


def dense_sum(leaves: list, coll: CollectiveContext) -> list:
    """The held ranks' grads (L, *leaf) -> their mean over the p ranks,
    one whole f32 leaf each: the sum in rank order (``psum``) divided by
    p. Leaf by leaf, each rank-stacked leaf freed once summed."""
    scale = 1.0 / coll.p
    out = []
    for i in range(len(leaves)):
        g, leaves[i] = leaves[i].to(torch.float32), None
        out.append(coll.psum(g)[0] * scale)
    return out


# elements a slice of fsdp's update: its f32 temporaries stay a few of
# these, not a few of the largest leaf (dbrx's expert leaf is 1.06 G)
_UPDATE_SLICE = 1 << 26


def fsdp_update(state: TrainState, leaves: list, lr, tcfg: TrainConfig,
                layout: dict, coll: CollectiveContext):
    """fsdp's half of the step: the held ranks' grads (L, *leaf, freed
    leaf by leaf) reduce-scattered in rank order over the layout's dim
    (``psum_scatter``) and divided by p, so each held rank gets its shard
    of the mean grad (a whole leaf where the layout replicates:
    ``psum``); the global norm from the shards' squared norms summed over
    the ranks in rank order plus the whole leaves'; the clip; AdamW (or
    SGD+momentum) on each shard with ``_moment_step``, a slice of
    ``_UPDATE_SLICE`` elements at a time (elementwise ops: the bits of
    one pass). Returns (new shards, new opt, grad norm)."""
    ocfg = tcfg.optimizer
    lays, paths = tree_flatten(layout)
    held, scale = coll.local_ranks, 1.0 / coll.p
    grads = []
    for i, lay in enumerate(lays):
        g, leaves[i] = leaves[i].to(torch.float32), None
        if lay.dim is None:
            grads.append(coll.psum(g)[0] * scale)
        else:
            grads.append(coll.psum_scatter(lay.pad(g, lead=1),
                                           axis=lay.dim) * scale)
        del g
    # per held rank, its shards' sum of squares in leaf order (one rank's
    # shards at a time: the same reduction whether 1 or p ranks are held)
    zero = torch.zeros((), dtype=torch.float32, device=coll.device)
    whole, sq = zero, [zero] * held
    for g, lay in zip(grads, lays):
        if lay.dim is None:
            whole = whole + g.square().sum()
            continue
        for r in range(held):
            sq[r] = sq[r] + g[r].square().sum()
    gnorm = torch.sqrt(coll.psum(torch.stack(sq))[0] + whole)
    factor = (torch.clamp(ocfg.grad_clip / (gnorm + 1e-9), max=1.0)
              if ocfg.grad_clip else torch.ones_like(gnorm))
    count = state.opt["count"] + 1
    c1, c2 = _bias_corrections(count, ocfg)
    leaves_p = tree_flatten(state.params)[0]
    leaves_m = tree_flatten(state.opt["mu"])[0]
    leaves_v = (tree_flatten(state.opt["nu"])[0] if "nu" in state.opt
                else [None] * len(lays))
    new_p, new_m, new_v = [], [], []
    for i, (pl, m, v) in enumerate(zip(leaves_p, leaves_m, leaves_v)):
        g, grads[i] = grads[i], None
        out = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
               for t in (pl, m, v) if t is not None]
        flat = [t.reshape(-1) for t in (pl, g, m, v) if t is not None]
        for a in range(0, pl.numel(), _UPDATE_SLICE):
            b = min(pl.numel(), a + _UPDATE_SLICE)
            fp, fg, fm = (t[a:b] for t in flat[:3])
            fv = flat[3][a:b] if v is not None else None
            m2, v2, _, upd = _moment_step(ocfg, fp, fg * factor, fm, fv, c1,
                                          c2, lr)
            for o, x in zip(out, (upd, m2, v2)):
                o.view(-1)[a:b] = x            # the dtype's rounding
        new_p.append(out[0])
        new_m.append(out[1])
        new_v.append(out[2] if v is not None else None)
        del g, flat
    return (tree_unflatten(paths, new_p),
            _new_opt(state.opt, tree_unflatten(paths, new_m),
                     tree_unflatten(paths, new_v), count), gnorm)


def _accumulated_grads(model: Model, params, batch, n_micro: int):
    """Mean loss + mean f32 grads (a flat list in tree_flatten order) over
    n_micro microbatches of consecutive rows. Functional
    (``torch.func``), so the sparcml step can ``vmap`` it over ranks."""
    leaves, paths = tree_flatten(params)
    grad_and_loss = grad_and_value(
        lambda lv, b: model.loss(tree_unflatten(paths, lv), b))
    rows = next(iter(batch.values())).shape[0]
    if rows % n_micro:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{n_micro} microbatches")
    mb = rows // n_micro
    acc_loss, acc_g = None, None
    for i in range(n_micro):
        grads, loss = grad_and_loss(
            leaves, {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
        if n_micro == 1:
            return loss, list(grads)
        if acc_g is None:
            acc_loss, acc_g = loss, [g.to(torch.float32) for g in grads]
        else:
            # in place, in f32 (add_ promotes a bf16 g as .to(f32) would):
            # one f32 copy of the grads lives, not two
            acc_loss = acc_loss + loss
            for a, g in zip(acc_g, grads):
                a.add_(g)
        del grads           # free this microbatch's grads before the next
    inv = 1.0 / n_micro
    return acc_loss * inv, [g.mul_(inv) for g in acc_g]


def batch_to_device(batch, dev: torch.device) -> dict:
    """Batch values (numpy arrays or tensors) on ``dev``. A host array
    bound for the card is copied through pinned memory without blocking,
    so the host never waits for the card here."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if dev.type == "cuda" and not t.is_cuda:
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t.to(dev)
    return out


def rank_grads(model: Model, params, batch, dp_total: int, n_micro: int):
    """Mean loss and every rank's grads on its slice of the global batch,
    stacked (R, *leaf) in tree_flatten order: the reference's jax.vmap
    over ranks."""
    rows = next(iter(batch.values())).shape[0]
    if rows % dp_total:
        raise ValueError(f"global batch {rows} does not split into "
                         f"{dp_total} ranks")
    batch_r = {k: v.reshape((dp_total, rows // dp_total) + v.shape[1:])
               for k, v in batch.items()}
    loss_r, leaves_r = vmap(lambda b: _accumulated_grads(
        model, params, b, n_micro))(batch_r)
    return loss_r.mean(), leaves_r


def update(state: TrainState, synced: list, lr, tcfg: TrainConfig):
    """Clip the synced grads (flat, tree_flatten order) and run the
    optimizer at ``lr`` on param-shaped moments: (new params, new opt,
    grad norm)."""
    _, paths = tree_flatten(state.params)
    grads, gnorm = clip_by_global_norm(tree_unflatten(paths, synced),
                                       tcfg.optimizer.grad_clip)
    new_p, new_opt = opt_update(state.params, grads, state.opt, lr,
                                tcfg.optimizer)
    return new_p, new_opt, gnorm


# --------------------------------------------------------------------------
# ZeRO updates: the optimizer on canonical column chunks
# --------------------------------------------------------------------------

def _moment_step(ocfg, p, g, m, v, c1, c2, lr):
    """One chunk's AdamW / SGD+momentum step in ``adamw`` /
    ``sgd_momentum``'s op order (no fused op in one layout and not the
    other): (new moments m, v, the f32 update direction without lr, the
    f32 param after the step). ``p`` None skips the param (the delta form
    of the scattered update applies it per leaf)."""
    gf = g.to(torch.float32)
    if ocfg.kind == "adamw":
        b1, b2 = ocfg.beta1, ocfg.beta2
        m2 = b1 * m.to(torch.float32) + (1 - b1) * gf
        v2 = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        delta = (m2 / c1) / (torch.sqrt(v2 / c2) + ocfg.eps)
    elif ocfg.kind == "sgdm":
        m2, v2 = ocfg.momentum * m.to(torch.float32) + gf, None
        delta = m2
    else:
        raise ValueError(ocfg.kind)
    if p is None:
        return m2, v2, delta, None
    pf = p.to(torch.float32)
    step = delta
    if ocfg.kind == "adamw":
        step = step + ocfg.weight_decay * pf
    return m2, v2, delta, pf - lr * step


def _chunks(x: torch.Tensor, spec, bucket_size: int, p: int) -> torch.Tensor:
    """A leaf's canonical (rows, cols) layout as its (p, rows, cols/p)
    column chunks: a view of the leaf's memory where the canonical layout
    is one (no padding), else of a copy."""
    c = to_canonical(x, spec, bucket_size)
    rows, cols = c.shape
    return c.view(rows, p, cols // p).permute(1, 0, 2)


def _held(chunks: torch.Tensor, coll: Optional[CollectiveContext]):
    """The chunks of the ranks this process holds: all of them (stacked),
    or its own (one rank a process)."""
    if not one_rank_a_process(coll):
        return chunks
    return chunks[coll.rank:coll.rank + 1]


def _like(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` in ``old``'s dtype and memory layout: the forward then runs
    the same kernels whatever layout the update ran in."""
    new = new.to(old.dtype)
    if new.stride() != old.stride():
        new = torch.empty_like(old).copy_(new)
    return new


def _new_opt(opt, mu, nu, count):
    out = {"mu": mu, "count": count}
    if "nu" in opt:
        out["nu"] = nu
    return out


def zero1_update(state: TrainState, synced: list, lr, tcfg: TrainConfig,
                 plan: SyncPlan, coll: Optional[CollectiveContext] = None):
    """ZeRO-1: clip the synced grads (flat, tree_flatten order) as the
    replicated step does, then update each leaf's column chunks from its
    moment chunks (the reference's ``_zero1_update_spmd`` over the stacked
    ranks; with ``coll`` its per-rank ``_zero1_update``: each held rank
    updates its chunk and one ``all_gather`` a leaf rebuilds the param).
    Returns (new params, new opt, grad norm)."""
    ocfg = tcfg.optimizer
    leaves_p, paths = tree_flatten(state.params)
    grads, gnorm = clip_by_global_norm(tree_unflatten(paths, synced),
                                       ocfg.grad_clip)
    leaves_g = tree_flatten(grads)[0]
    leaves_m = tree_flatten(state.opt["mu"])[0]
    leaves_v = (tree_flatten(state.opt["nu"])[0] if "nu" in state.opt
                else [None] * len(leaves_p))
    count = state.opt["count"] + 1
    c1, c2 = _bias_corrections(count, ocfg)
    p, bsz = plan.dp_total, tcfg.sync.bucket_size
    new_p, new_m, new_v = [], [], []
    for slot, pl, gl, m, v in zip(_slots(plan), leaves_p, leaves_g,
                                  leaves_m, leaves_v):
        my_p = _chunks(pl, slot.spec, bsz, p)
        my_g = _chunks(gl, slot.spec, bsz, p)
        if coll is not None:
            my_p, my_g = _held(my_p, coll), _held(my_g, coll)
        m2, v2, _, upd = _moment_step(ocfg, my_p, my_g, m, v, c1, c2, lr)
        new_m.append(m2.to(m.dtype))
        new_v.append(None if v2 is None else v2.to(v.dtype))
        if coll is not None:
            full = coll.all_gather(upd, axis=1)[0]       # (rows, cols)
        else:
            full = upd.permute(1, 0, 2).reshape(slot.rows, slot.cols)
        new_p.append(_like(from_canonical(full, pl.shape, slot.spec), pl))
    return (tree_unflatten(paths, new_p),
            _new_opt(state.opt, tree_unflatten(paths, new_m),
                     tree_unflatten(paths, new_v), count), gnorm)


def zero_scattered_update_spmd(state: TrainState, chunks: dict, leaves_r,
                               lr, tcfg: TrainConfig, plan: SyncPlan):
    """The scattered update over the stacked ranks (the reference's
    ``_zero_scattered_update_spmd``): the owner chunks become the synced
    leaves again, clipped as the replicated step clips them (so the
    factor, and every value, is the replicated one), the moments update
    on each bucket's (p, rows, w) chunks, and only the update direction
    goes back through the bucket layout: the parameter step p - lr *
    (delta + wd * p) runs per leaf in ``adamw``'s ops. ``leaves_r`` are
    the rank-stacked grads (shape references). Returns (new params, new
    opt, grad norm)."""
    ocfg = tcfg.optimizer
    p, bsz = plan.dp_total, tcfg.sync.bucket_size
    leaves_p, paths = tree_flatten(state.params)
    applied = apply_buckets_spmd(plan, unchunk_buckets_spmd(plan, chunks),
                                 leaves_r)
    grads, gnorm = clip_by_global_norm(tree_unflatten(paths, applied),
                                       ocfg.grad_clip)
    leaves_g = tree_flatten(grads)[0]
    count = state.opt["count"] + 1
    c1, c2 = _bias_corrections(count, ocfg)
    new_leaves: list = [None] * plan.num_leaves
    new_m, new_v = {}, {}
    for group in plan.groups:
        gbuf = pack_group(group, leaves_g, bsz)
        dparts = []
        for b in group.buckets:
            w = plan.owned_cols(b)
            g = gbuf[:, b.col_start:b.col_start + b.cols].view(
                group.rows, p, w).permute(1, 0, 2)
            m, v = state.opt["mu"][b.name], state.opt.get("nu", {}).get(b.name)
            m2, v2, delta, _ = _moment_step(ocfg, None, g, m, v, c1, c2, lr)
            new_m[b.name] = m2.to(m.dtype)
            if v2 is not None:
                new_v[b.name] = v2.to(v.dtype)
            dparts.append(delta.permute(1, 0, 2).reshape(group.rows, b.cols))
        dbuf = dparts[0] if len(dparts) == 1 else torch.cat(dparts, dim=1)
        for slot in group.slots:
            pl = leaves_p[slot.leaf_id]
            delta = from_canonical(dbuf[:, slot.offset:slot.offset + slot.cols],
                                   slot.shape, slot.spec)
            pf = pl.to(torch.float32)
            step = delta
            if ocfg.kind == "adamw":
                step = step + ocfg.weight_decay * pf
            new_leaves[slot.leaf_id] = (pf - lr * step).to(pl.dtype)
    return (tree_unflatten(paths, new_leaves),
            _new_opt(state.opt, new_m, new_v, count), gnorm)


def zero_scattered_update(state: TrainState, chunks: dict, lr,
                          tcfg: TrainConfig, plan: SyncPlan,
                          coll: CollectiveContext):
    """The scattered update per rank (the reference's
    ``_zero_scattered_update``): the owner grad chunks come straight off
    the reduce (no grad-side gather ever ran), each held rank updates its
    param and moment chunks, and ONE dense param ``all_gather`` a bucket
    rebuilds the parameters. The grad norm is exact from the chunks (the
    owned ranges are disjoint and cover the buffers; padding adds zero):
    one psum of the per-shard sums of squares, a different summation
    order from the replicated step's (allclose, not bitwise). Returns
    (new params, new opt, grad norm)."""
    ocfg = tcfg.optimizer
    p, bsz = plan.dp_total, tcfg.sync.bucket_size
    lead = coll.local_ranks
    total = None
    for b in plan.buckets:
        sq = chunks[b.name].to(torch.float32).square().reshape(lead, -1).sum(1)
        total = sq if total is None else total + sq
    gnorm = torch.sqrt(coll.psum(total))                     # (L,)
    factor = (torch.clamp(ocfg.grad_clip / (gnorm + 1e-9), max=1.0)
              if ocfg.grad_clip else torch.ones_like(gnorm))
    count = state.opt["count"] + 1
    c1, c2 = _bias_corrections(count, ocfg)
    leaves_p, paths = tree_flatten(state.params)
    new_leaves: list = [None] * plan.num_leaves
    new_m, new_v = {}, {}
    for group in plan.groups:
        pbuf = pack_group(group, leaves_p, bsz)                # (rows, cols)
        parts = []
        for b in group.buckets:
            w = plan.owned_cols(b)
            my_p = _held(pbuf[:, b.col_start:b.col_start + b.cols].view(
                group.rows, p, w).permute(1, 0, 2), coll)
            g = chunks[b.name].to(torch.float32) * factor[:, None, None]
            m, v = state.opt["mu"][b.name], state.opt.get("nu", {}).get(b.name)
            m2, v2, _, upd = _moment_step(ocfg, my_p, g, m, v, c1, c2, lr)
            new_m[b.name] = m2.to(m.dtype)
            if v2 is not None:
                new_v[b.name] = v2.to(v.dtype)
            parts.append(coll.all_gather(upd, axis=1)[0])   # (rows, b.cols)
        out_buf = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        for leaf_id, arr in unpack_group(group, out_buf, leaves_p):
            new_leaves[leaf_id] = _like(arr, leaves_p[leaf_id])
    return (tree_unflatten(paths, new_leaves),
            _new_opt(state.opt, new_m, new_v, count), gnorm[0])


# --------------------------------------------------------------------------
# The two halves of a sparcml step, in every layout
# --------------------------------------------------------------------------

def reduce_half(plan: SyncPlan, leaves, residuals: dict,
                coll: Optional[CollectiveContext], rand_fn: RandFn,
                telemetry: bool = False):
    """The executor of the lowering: (reduced, new residuals, telemetry
    rows {name -> (4,)}). ``reduced`` is what :func:`optimizer_half`
    takes: one rank's replicated (rows, cols) buffers (every held rank
    holds the same), or a scattered plan's owner chunks of the held ranks
    ((p, rows, w) stacked, (1, rows, w) one rank a process)."""
    if coll is None:
        return reduce_buckets_spmd(plan, leaves, residuals,
                                   p_data=plan.dp_total, rand_fn=rand_fn,
                                   telemetry=telemetry)
    reduced, new_res, telem = reduce_buckets(
        plan, leaves, residuals, coll=coll,
        rand_fn=rank_rand_fn(rand_fn, coll), telemetry=telemetry)
    if not plan.scattered:
        reduced = {n: v[0] for n, v in reduced.items()}
    return reduced, new_res, {n: v[0] for n, v in telem.items()}


def optimizer_half(state: TrainState, reduced: dict, leaves, lr,
                   tcfg: TrainConfig, plan: SyncPlan,
                   coll: Optional[CollectiveContext]):
    """Apply ``reduced`` (as :func:`reduce_half` returns it) to the
    state's layout: clip and optimizer update. ``leaves`` are the step's
    rank-stacked grads (shape references). Returns (new params, new opt,
    grad norm)."""
    if plan.scattered:
        if coll is None:
            return zero_scattered_update_spmd(state, reduced, leaves, lr,
                                              tcfg, plan)
        return zero_scattered_update(state, reduced, lr, tcfg, plan, coll)
    synced = apply_buckets_spmd(plan, reduced, leaves)
    if opt_layout_of(tcfg) == "zero1_leaf":
        return zero1_update(state, synced, lr, tcfg, plan, coll)
    return update(state, synced, lr, tcfg)


# --------------------------------------------------------------------------
# One rank a process: what differs from the stacked ranks
# --------------------------------------------------------------------------

def manual_context(lowering: str, coll: Optional[CollectiveContext],
                   dp_total: int, device) -> Optional[CollectiveContext]:
    """The per-rank executor's context: ``coll``, or the dp_total ranks
    stacked on ``device``; None for the stacked-replica lowering."""
    if lowering != "manual":
        if coll is not None:
            raise ValueError("a collective context needs lowering='manual'")
        return None
    if coll is None:
        return StackedCollectives(dp_total, device)
    if coll.p != dp_total:
        raise ValueError(f"the context spans {coll.p} ranks, dp_total is "
                         f"{dp_total}")
    return coll


def local_batch(batch, coll: Optional[CollectiveContext]) -> dict:
    """The rows of the global batch this process computes: all of them,
    or, one rank a process, rank r's contiguous slice (the one the
    stacked ranks give rank r)."""
    if not one_rank_a_process(coll):
        return batch
    rows = len(next(iter(batch.values())))
    if rows % coll.p:
        raise ValueError(f"global batch {rows} does not split into "
                         f"{coll.p} ranks")
    n = rows // coll.p
    return {k: v[coll.rank * n:(coll.rank + 1) * n] for k, v in batch.items()}


def microbatch_rows(batch, coll: CollectiveContext, n_micro: int) -> dict:
    """The rows of the global batch the held ranks compute in the
    per-rank dense step, rank by rank: rank r's rows of microbatch i are
    the r-th of p equal parts of the reference's global microbatch i
    (n_micro consecutive row ranges of the global batch), its
    microbatches consecutive. So the ranks of one microbatch together
    hold the reference's, in rank order, as a MoE layer's shared
    capacity needs (``moe.shared_capacity``)."""
    rows = len(next(iter(batch.values())))
    p = coll.p
    if rows % (p * n_micro):
        raise ValueError(f"global batch {rows} does not split into {p} "
                         f"ranks x {n_micro} microbatches")
    lo = coll.rank if one_rank_a_process(coll) else 0
    hi = lo + coll.local_ranks
    out = {}
    for k, v in batch.items():
        g = v.reshape((n_micro, p, rows // (p * n_micro)) + v.shape[1:])
        mine = g[:, lo:hi].swapaxes(0, 1)
        out[k] = mine.reshape((-1,) + tuple(v.shape[1:]))
    return out


def global_loss(loss, coll: Optional[CollectiveContext]):
    """The mean loss over ranks: one rank a process gathers every rank's
    and takes the mean the stacked ranks take."""
    if not one_rank_a_process(coll):
        return loss
    return coll.all_gather(loss.reshape(1, 1), axis=0).mean()


def ranks_all_finite(leaves, coll: Optional[CollectiveContext]):
    """The guard verdict over every rank's raw grads: the AND over ranks
    (the reference's pmin) when a process holds one."""
    fin = all_finite_leaves(leaves)
    if not one_rank_a_process(coll):
        return fin
    return coll.all_gather(fin.reshape(1, 1), axis=0).amin()


def rank_rand_fn(rand_fn: RandFn, coll: Optional[CollectiveContext]
                 ) -> RandFn:
    """The per-rank executor asks for its held ranks' bits. One rank a
    process draws only its own from a :class:`StepBits` (n words); from
    any other ``rand_fn`` (a caller's bits for every rank, as the tests
    pass the reference's) it takes its slice of the ranks' draw."""
    if not one_rank_a_process(coll):
        return rand_fn
    if isinstance(rand_fn, StepBits):
        return rand_fn.rank_fn(coll.rank)
    p, r = coll.p, coll.rank
    return lambda bucket_idx, n: rand_fn(bucket_idx, n * p).reshape(p, n)[r]


# --------------------------------------------------------------------------
# Guarded-step helpers: the all-finite check over the raw gradient leaves
# and the select that rolls state back on a trip (the JAX package's
# ``all_finite_leaves`` / ``guard_select``). Both are tensor ops on the
# device: the verdict is never read on the host inside a step.
# --------------------------------------------------------------------------

def inject_nonfinite_leaves(leaves, fault_vec: torch.Tensor) -> list:
    """The chaos harness's injection: grad leaf i becomes NaN (flag 1) or
    Inf (flag 2) where the (n_leaves,) f32 ``fault_vec`` says so. A pure
    select (``torch.where``), never arithmetic (``g + flag * nan`` is NaN
    at flag 0 too), so an all-zero vector gives every leaf's bits back;
    the flags stay on the device (no host read)."""
    inf = torch.full((), float("inf"), device=fault_vec.device)
    nan = torch.full((), float("nan"), device=fault_vec.device)
    out = []
    for i, g in enumerate(leaves):
        flag = fault_vec[i]
        bad = torch.where(flag > 1.5, inf, nan).to(g.dtype)
        out.append(torch.where(flag > 0.5, bad, g))
    return out


def all_finite_leaves(leaves) -> torch.Tensor:
    """f32 scalar: 1.0 iff every element of every leaf is finite. Checked
    on the RAW grads, before the reduce half: in a staleness-1 pipeline a
    NaN entering the reduce poisons the residuals that same step, while
    the norm of the applied (stale, clean) buffers stays finite."""
    fin = None
    for g in leaves:
        ok = torch.isfinite(g).all().to(torch.float32)
        fin = ok if fin is None else fin * ok
    return fin


def guard_select(fin, new_tree, old_tree):
    """Leafwise select on the guard verdict: ``fin`` 1.0 keeps
    ``new_tree`` bit for bit, 0.0 rolls every leaf back to ``old_tree``.
    A select (``torch.where``), never arithmetic, so the NaNs of the
    branch not taken never propagate."""
    if fin is None:
        return new_tree
    pred = fin > 0.5
    return tree_map(lambda a, b: torch.where(pred, a, b), new_tree, old_tree)


class StepBits:
    """Default QSGD bits of one step over ``ranks`` data-parallel ranks
    (a ``RandFn``): rank r's bits of bucket ``bucket_idx`` come from a
    generator (Philox on CUDA) seeded from (seed, step, bucket_idx, r),
    so a replayed step draws the same bits, a bucket a replan demotes to
    dense (which draws none) does not shift the bits of later buckets,
    and one rank a process draws only its own (:meth:`rank_fn`, the
    reference's fold of the rank into the key). Called for n words, it
    returns every rank's draw of n / ranks words in rank order, the
    layout both executors read (the reference's ``_qsgd_rand_all`` of
    its ``_qsgd_rand``)."""

    def __init__(self, seed: int, step: int, device, ranks: int):
        self.base = (seed * 1_000_003 + int(step)) * 1_000_033
        self.device = device
        self.ranks = ranks

    def _draw(self, bucket_idx: int, rank: int, n: int, out=None):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((self.base + bucket_idx) * 1_000_037 + rank)
                        % (2**63))
        return random_bits(n, gen, self.device, out=out)

    def rank_fn(self, rank: int) -> RandFn:
        """Rank ``rank``'s own bits: n words for n asked."""
        return lambda bucket_idx, n: self._draw(bucket_idx, rank, n)

    def __call__(self, bucket_idx: int, n: int) -> torch.Tensor:
        if n % self.ranks:
            raise ValueError(f"{n} words do not split over {self.ranks} "
                             "ranks")
        m = n // self.ranks
        out = torch.empty(n, dtype=torch.int32, device=self.device)
        for r in range(self.ranks):
            self._draw(bucket_idx, r, m, out=out[r * m:(r + 1) * m])
        return out.view(torch.uint32)


LOWERINGS = ("spmd", "manual")


def build_train_step(model: Model, tcfg: TrainConfig, dp_total: int = 1,
                     device="cuda", lowering: str = "spmd",
                     coll: Optional[CollectiveContext] = None, net=None,
                     plan: Optional[SyncPlan] = None):
    """Returns (step_fn, plan). ``step_fn(state, batch, rand_fn=None) ->
    (new_state, metrics)``; batch values (the global batch) may be numpy
    or tensors. ``rand_fn(bucket_idx, n)`` overrides the QSGD rounding bits
    (see ``comm/executor.py``; both lowerings lay them out alike, so the
    same function drives either). ``lowering`` picks the executor:
    "spmd" (the stacked sum; in dense mode the global batch's grads) or
    "manual" (per rank over a context; fsdp always); ``coll`` is the
    manual lowering's context (``StackedCollectives`` of the dp_total
    ranks if None; a ``ProcessGroupCollectives`` runs one rank a
    process). ``net``: the ``NetworkParams`` a sparcml config's
    ``algorithm="auto"`` selects on; ``plan``: a replan of this config's
    plan to run instead (a checkpoint's)."""
    if lowering not in LOWERINGS:
        raise ValueError(f"lowering must be one of {LOWERINGS}: {lowering!r}")
    dev = resolve_device(device)
    sched = make_schedule(tcfg.schedule)
    n_micro = tcfg.microbatches
    base = build_plan(model, tcfg, dp_total, net)
    if plan is None:
        plan = base
    else:
        check_replan(plan, base)

    if plan is None:
        if tcfg.fsdp and coll is None:
            lowering = "manual"    # the shards are per rank: no global form
        coll = manual_context(lowering, coll, dp_total, dev)
        layout = fsdp_layout_of(model, dp_total) if tcfg.fsdp else None

        def dense_step(state: TrainState, batch, rand_fn=None):
            lr = sched(state.step)
            if coll is None:
                batch = batch_to_device(batch, dev)
                loss, grads = _accumulated_grads(model, state.params, batch,
                                                 n_micro)
                new_p, new_opt, gnorm = update(state, grads, lr, tcfg)
            else:
                batch = batch_to_device(
                    microbatch_rows(batch, coll, n_micro), dev)
                params = (gather_params(state.params, layout, coll)
                          if layout is not None else state.params)
                with shared_capacity(coll):
                    loss, leaves = rank_grads(model, params, batch,
                                              coll.local_ranks, n_micro)
                del params
                loss = global_loss(loss, coll)
                if layout is not None:
                    new_p, new_opt, gnorm = fsdp_update(state, leaves, lr,
                                                        tcfg, layout, coll)
                else:
                    new_p, new_opt, gnorm = update(
                        state, dense_sum(leaves, coll), lr, tcfg)
            return (TrainState(new_p, new_opt, None, state.step + 1),
                    {"loss": loss, "grad_norm": gnorm, "lr": lr})

        return dense_step, None

    check_bucket_size(tcfg.sync.bucket_size, dev, tcfg.sync.impl)
    coll = manual_context(lowering, coll, dp_total, dev)
    held = coll.local_ranks if coll is not None else dp_total

    def sparcml_step(state: TrainState, batch, rand_fn: Optional[RandFn] = None):
        batch = batch_to_device(local_batch(batch, coll), dev)
        loss, leaves = rank_grads(model, state.params, batch, held, n_micro)
        loss = global_loss(loss, coll)
        if rand_fn is None:
            rand_fn = StepBits(tcfg.seed, state.step, dev, dp_total)
        reduced, new_res, _ = reduce_half(plan, leaves, state.residuals,
                                          coll, rand_fn)
        # the update reads the grads' shapes and dtypes only: free them
        leaves = [torch.empty(g.shape, dtype=g.dtype, device="meta")
                  for g in leaves]
        lr = sched(state.step)
        new_p, new_opt, gnorm = optimizer_half(state, reduced, leaves, lr,
                                               tcfg, plan, coll)
        return (TrainState(new_p, new_opt, new_res, state.step + 1),
                {"loss": loss, "grad_norm": gnorm, "lr": lr})

    return sparcml_step, plan
