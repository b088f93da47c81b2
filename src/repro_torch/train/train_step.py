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
  loss is the mean over ranks, the QSGD bits are its slice of the bits
  the stacked ranks would draw, and the params start identical from the
  seed, so the run gives the stacked run's bits.

Then the synced gradients are clipped and the optimizer updates the
single params copy.

dense mode: gradients of the global batch, clipped, optimizer update.

The model's backward is PyTorch autograd over plain tensor code, as the
JAX package leaves it to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch.comm.collectives import (CollectiveContext,
                                          StackedCollectives)
from repro_torch.comm.executor import RandFn, execute_plan, execute_plan_spmd
from repro_torch.comm.plan import SyncPlan, build_sync_plan
from repro_torch.core.qsgd import random_bits
from repro_torch.device import resolve_device
from repro_torch.kernels.bucket_topk.ops import check_bucket_size
from repro_torch.models.model import Model, init_params
from repro_torch.models.specs import param_specs
from repro_torch.optim.optimizers import (clip_by_global_norm, init_opt_state,
                                          opt_update)
from repro_torch.optim.schedule import make_schedule
from repro_torch.train.state import TrainConfig, TrainState
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


def build_plan(model: Model, tcfg: TrainConfig, dp_total: int
               ) -> Optional[SyncPlan]:
    """The sync plan of a sparcml config (None in dense mode), built from
    shapes only."""
    if tcfg.sync.mode != "sparcml":
        return None
    pshapes = init_params(model.cfg, device="meta")
    return build_sync_plan(pshapes, param_specs(pshapes, model.cfg),
                           tcfg.sync, dp_total)


def init_state(model: Model, tcfg: TrainConfig, plan: Optional[SyncPlan],
               device="cuda", params=None,
               coll: Optional[CollectiveContext] = None) -> TrainState:
    """Fresh state: params from a generator seeded with ``tcfg.seed`` (or
    the given ``params``), zero optimizer moments and EF residuals for the
    ranks the process holds (all of them unless ``coll`` says otherwise)."""
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
        params = model.init(gen, dev)
    ranks = coll.local_ranks if coll is not None else None
    res = plan.init_residuals(dev, ranks) if plan is not None else None
    return TrainState(params, init_opt_state(params, tcfg.optimizer), res, 0)


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
            acc_loss = acc_loss + loss
            acc_g = [a + g.to(torch.float32) for a, g in zip(acc_g, grads)]
    inv = 1.0 / n_micro
    return acc_loss * inv, [g * inv for g in acc_g]


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
    optimizer at ``lr``: (new params, new opt, grad norm)."""
    _, paths = tree_flatten(state.params)
    grads, gnorm = clip_by_global_norm(tree_unflatten(paths, synced),
                                       tcfg.optimizer.grad_clip)
    new_p, new_opt = opt_update(state.params, grads, state.opt, lr,
                                tcfg.optimizer)
    return new_p, new_opt, gnorm


# --------------------------------------------------------------------------
# One rank a process: what differs from the stacked ranks
# --------------------------------------------------------------------------

def _one_rank_a_process(coll: Optional[CollectiveContext]) -> bool:
    return coll is not None and coll.local_ranks < coll.p


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
    if not _one_rank_a_process(coll):
        return batch
    rows = len(next(iter(batch.values())))
    if rows % coll.p:
        raise ValueError(f"global batch {rows} does not split into "
                         f"{coll.p} ranks")
    n = rows // coll.p
    return {k: v[coll.rank * n:(coll.rank + 1) * n] for k, v in batch.items()}


def global_loss(loss, coll: Optional[CollectiveContext]):
    """The mean loss over ranks: one rank a process gathers every rank's
    and takes the mean the stacked ranks take."""
    if not _one_rank_a_process(coll):
        return loss
    return coll.all_gather(loss.reshape(1, 1), axis=0).mean()


def ranks_all_finite(leaves, coll: Optional[CollectiveContext]):
    """The guard verdict over every rank's raw grads: the AND over ranks
    (the reference's pmin) when a process holds one."""
    fin = all_finite_leaves(leaves)
    if not _one_rank_a_process(coll):
        return fin
    return coll.all_gather(fin.reshape(1, 1), axis=0).amin()


def rank_rand_fn(rand_fn: RandFn, coll: Optional[CollectiveContext]
                 ) -> RandFn:
    """The per-rank executor asks for its held ranks' bits; one rank a
    process draws every rank's, as the stacked ranks do, and keeps its
    own slice: p times the RNG work of its own draw (ROADMAP, item 7)."""
    if not _one_rank_a_process(coll):
        return rand_fn
    p, r = coll.p, coll.rank
    return lambda bucket_idx, n: rand_fn(bucket_idx, n * p).reshape(p, n)[r]


# --------------------------------------------------------------------------
# Guarded-step helpers: the all-finite check over the raw gradient leaves
# and the select that rolls state back on a trip (the JAX package's
# ``all_finite_leaves`` / ``guard_select``). Both are tensor ops on the
# device: the verdict is never read on the host inside a step.
# --------------------------------------------------------------------------

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


def step_rand_fn(seed: int, step: int, device) -> RandFn:
    """Default QSGD bits of one step: bucket ``bucket_idx``'s come from a
    generator (Philox on CUDA) seeded from (seed, step, bucket_idx), so a
    replayed step draws the same bits, and a bucket a replan demotes to
    dense (which draws none) does not shift the bits of later buckets."""
    base = (seed * 1_000_003 + step) * 1_000_033

    def rand_fn(bucket_idx: int, n: int) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed((base + bucket_idx) % (2**63))
        return random_bits(n, gen, device)

    return rand_fn


LOWERINGS = ("spmd", "manual")


def build_train_step(model: Model, tcfg: TrainConfig, dp_total: int = 1,
                     device="cuda", lowering: str = "spmd",
                     coll: Optional[CollectiveContext] = None):
    """Returns (step_fn, plan). ``step_fn(state, batch, rand_fn=None) ->
    (new_state, metrics)``; batch values (the global batch) may be numpy
    or tensors. ``rand_fn(bucket_idx, n)`` overrides the QSGD rounding bits
    (see ``comm/executor.py``; both lowerings lay them out alike, so the
    same function drives either). ``lowering`` picks the sparcml executor;
    ``coll`` is the manual lowering's context (``StackedCollectives`` of
    the dp_total ranks if None; a ``ProcessGroupCollectives`` runs one
    rank a process)."""
    if lowering not in LOWERINGS:
        raise ValueError(f"lowering must be one of {LOWERINGS}: {lowering!r}")
    dev = resolve_device(device)
    sched = make_schedule(tcfg.schedule)
    n_micro = tcfg.microbatches
    plan = build_plan(model, tcfg, dp_total)

    if plan is None:
        def dense_step(state: TrainState, batch, rand_fn=None):
            batch = batch_to_device(batch, dev)
            loss, grads = _accumulated_grads(model, state.params, batch,
                                             n_micro)
            lr = sched(state.step)
            new_p, new_opt, gnorm = update(state, grads, lr, tcfg)
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
            rand_fn = step_rand_fn(tcfg.seed, state.step, dev)
        if coll is not None:
            synced, new_res = execute_plan(plan, leaves, state.residuals,
                                           coll=coll,
                                           rand_fn=rank_rand_fn(rand_fn, coll))
        else:
            synced, new_res = execute_plan_spmd(
                plan, leaves, state.residuals, p_data=dp_total,
                rand_fn=rand_fn)
        lr = sched(state.step)
        new_p, new_opt, gnorm = update(state, synced, lr, tcfg)
        return (TrainState(new_p, new_opt, new_res, state.step + 1),
                {"loss": loss, "grad_norm": gnorm, "lr": lr})

    return sparcml_step, plan
