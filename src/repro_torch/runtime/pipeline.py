"""Pipelined stale-gradient steps (the JAX package's
``repro.runtime.pipeline``, DESIGN.md §6), in both lowerings.

The synchronous SparCML step puts the reduce half of the sync between
step t's backward and step t+1's forward:

    grads_t -> reduce(grads_t) -> apply -> update

The pipelined step splits the executor into its halves
(``reduce_buckets_spmd`` / ``apply_buckets_spmd``, or the per-rank
``reduce_buckets`` / ``apply_buckets``) and staggers them by
``staleness`` steps (bounded at 1):

    step t:  grads_t = backward(params_t, batch_t)
             params_{t+1} = update(params_t, apply(inflight))   # = R(g_{t-1})
             inflight' = reduce(grads_t)                        # in flight
                                                                # until t+1

so reduce(t) no longer sits in front of step t+1's forward. On a CUDA
device the reduce half runs on a side stream, one per built step:

    main stream:  forward/backward(t) -> grads, guard verdict -> event A
    side stream:  wait A; reduce(grads, residuals); guard select of the
                  residuals and in-flight buffers -> event B(t)
    main stream:  wait B(t-1); apply(inflight); clip; AdamW

and reduce(t) can run beside apply(t) and forward/backward(t+1). The caching
allocator hands a freed block back to the stream that allocated it, so
every tensor made on one stream and read on the other is marked with
``record_stream``: without it step t+1's forward could reuse the memory
of gradients reduce(t) is still reading, a silent wrong answer. The
per-rank reduce issues its collectives with the side stream current, so
NCCL orders them after that stream's work. A CPU device runs the same ops
in the same order on one thread. The step never waits on the card from
the host: no ``.item()``, no host copy.

Lowerings: ``"spmd"`` (the default) runs the stacked-replica executor;
``"manual"`` runs the per-rank executor over a ``CollectiveContext``:
``StackedCollectives(dp_total)`` on one device, or a given
``ProcessGroupCollectives`` with one rank a process, where the loss is the
mean over ranks and the guard's verdict the AND over ranks (the
reference's ``pmin``). The reference's ``emulated`` lowering works around
an XLA fault that PyTorch does not have and is not ported.

Error-feedback residuals stay keyed by bucket and are updated by the
reduce half every step, exactly as in the synchronous executor.
``staleness=0`` is the synchronous step: the same ops in the same order,
no side stream, so its output equals ``build_train_step``'s bit for bit.

In-flight buffers carry a scalar validity flag (``VALID_KEY``): a step
that applies INVALID (all-zero) buffers, the first one and the first
after every attach or resume, runs at lr 0, so parameters stay untouched
until a real reduction lands (the optimizer's count still advances and
its moments decay once).

``telemetry=True`` (the reference's default) returns the reduce half's
per-bucket rows as ``metrics["telemetry"]``: {EF bucket -> (4,) f32
[nnz, wire bytes, mass coverage, EF norm]}, stacked to (K, 4) by the
superstep (on the side stream, after the last reduce that wrote them);
they stay on the device, and the driver reads them back with the losses.

``plan=`` takes a replanned ``SyncPlan`` (``SyncPlan.replan`` of the base
plan, the adaptive runtime's swaps): the same residual and in-flight
layout, other bucket algorithms; a plan that changes the layout is
refused when the step is built.

The optimizer half runs in the config's layout (``train_step.
optimizer_half``): full, ZeRO-1 chunks, or the scattered mode, whose
in-flight buffers are the reduce's owner chunks ((ranks, rows, cols/dp)
a bucket) and whose apply is the shard update itself: on the per-rank
path its dense param allgather (one a bucket, ``plan.num_buckets`` a
step) runs at apply time, beside the next reduce.

``inject=True`` builds the chaos harness's step: the batch carries the
injector's (n_leaves,) fault vector under ``runtime.faults.FAULT_KEY``,
and the raw grads pass through ``train_step.inject_nonfinite_leaves``
(a select) before the guard and the reduce half; the vector rides the
batch's copy to the device, so the step still never waits on the card.

``build_superstep`` chains K steps with no host sync in between and
stacks their metrics: the counterpart of the reference's ``lax.scan``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.comm.collectives import CollectiveContext
from repro_torch.comm.executor import RandFn
from repro_torch.device import resolve_device
from repro_torch.kernels.bucket_topk.ops import check_bucket_size
from repro_torch.models.model import Model
from repro_torch.optim.schedule import make_schedule
from repro_torch.runtime.faults import FAULT_KEY
from repro_torch.train import train_step as ts
from repro_torch.train.state import TrainConfig, TrainState
from repro_torch.utils.tree import tree_leaves

LOWERINGS = ("manual", "emulated", "spmd")

# Scalar validity flag carried inside the in-flight dict (f32 0/1). Bucket
# names are "g<gid>b<idx>", so the key cannot collide.
VALID_KEY = "__valid__"


def resolve_lowering(lowering: Optional[str] = None) -> str:
    """The lowering the pipelined step runs: the stacked-replica one by
    default, or the per-rank one ("manual"). The reference's emulated
    lowering works around an XLA fault that PyTorch does not have."""
    if lowering is None:
        return "spmd"
    if lowering not in LOWERINGS:
        raise ValueError(f"lowering must be one of {LOWERINGS}: {lowering!r}")
    if lowering == "emulated":
        raise NotImplementedError(
            "lowering='emulated' is not ported: the reference's psum-only "
            "emulation works around an XLA-CPU fault that PyTorch does not "
            "have (ROADMAP Queue 1 item 7)")
    return lowering


def attach_inflight(state: TrainState, plan,
                    ranks: Optional[int] = None) -> TrainState:
    """Zero in-flight buffers onto a synchronous-shaped TrainState (a
    resume from a checkpoint, or a hand-off from ``Trainer.run``); a
    scattered plan's chunks for the ``ranks`` the process holds (all by
    default). The validity flag starts at 0, so the first pipelined step
    applies at lr 0, whatever the step."""
    if state.inflight is not None:
        return state
    dev = tree_leaves(state.params)[0].device
    zeros = plan.init_inflight(dev, ranks)
    zeros[VALID_KEY] = torch.zeros((), dtype=torch.float32, device=dev)
    return state._replace(inflight=zeros)


class PipelinedStep:
    """``step(state, batch, rand_fn=None) -> (state, metrics)``, one
    pipelined step; ``rand_fn`` overrides the QSGD rounding bits as in
    ``build_train_step``. ``drain()`` makes the caller's current stream
    wait for the last reduce this step enqueued: call it before the
    returned state is read outside the next step (a checkpoint, the
    synchronous loop, a host copy)."""

    def __init__(self, model: Model, tcfg: TrainConfig, dp_total: int,
                 device, staleness: int, guard: bool,
                 lowering: Optional[str] = None,
                 coll: Optional[CollectiveContext] = None,
                 telemetry: bool = True, plan=None, inject: bool = False):
        if tcfg.sync.mode != "sparcml":
            raise ValueError(
                "the pipelined runtime overlaps the planned sparse sync and "
                "requires sync.mode='sparcml'")
        if staleness not in (0, 1):
            raise ValueError(f"staleness is bounded at 1, got {staleness}")
        lowering = resolve_lowering(lowering)
        self.model = model
        self.tcfg = tcfg
        self.dp_total = dp_total
        self.device = resolve_device(device)
        self.staleness = staleness
        self.guard = guard
        self.inject = inject
        self.telemetry = telemetry
        check_bucket_size(tcfg.sync.bucket_size, self.device, tcfg.sync.impl)
        self.coll = ts.manual_context(lowering, coll, dp_total, self.device)
        built = ts.build_plan(model, tcfg, dp_total)
        if plan is None:
            plan = built
        elif (plan.residual_shapes() != built.residual_shapes()
              or plan.inflight_shapes() != built.inflight_shapes()):
            # full name -> shape maps: a plan of another configuration can
            # reuse the g<i>b<j> names with other shapes
            raise ValueError(
                "the plan changes the residual or in-flight layout: a "
                "replanned plan must come from SyncPlan.replan() of this "
                "configuration's base plan")
        self.plan = plan
        self._sched = make_schedule(tcfg.schedule)
        self._side = (torch.cuda.Stream(self.device)
                      if staleness and self.device.type == "cuda" else None)
        self._reduce_done: Optional[torch.cuda.Event] = None

    def drain(self) -> None:
        if self._reduce_done is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._reduce_done)

    def stack_telemetry(self, rows: list) -> dict:
        """K steps' telemetry rows stacked to (K, 4) a bucket. With a side
        stream the stack runs there, after the last reduce that wrote
        rows, and ``drain()`` then covers it: the main stream has not
        waited for that reduce (the next step's apply does)."""
        side = self._side
        if side is None:
            return _stack(rows)
        with torch.cuda.stream(side):
            out = _stack(rows)
            done = torch.cuda.Event()
            done.record(side)
        main = torch.cuda.current_stream(self.device)
        for t in out.values():
            t.record_stream(main)
        self._reduce_done = done
        return out

    def _reduce_all(self, state, leaves, rand_fn):
        """(reduced, new residuals, telemetry {name -> (4,)}) of the chosen
        executor, reduced as ``train_step.optimizer_half`` takes it."""
        return ts.reduce_half(self.plan, leaves, state.residuals, self.coll,
                              rand_fn, self.telemetry)

    def _reduce_body(self, state, leaves, fin, rand_fn):
        new_inflight, new_res, telem = self._reduce_all(state, leaves,
                                                        rand_fn)
        new_inflight[VALID_KEY] = torch.ones((), dtype=torch.float32,
                                             device=self.device)
        # a trip keeps the old residuals and the old (clean) in-flight
        # reduction, which the next clean step applies
        return (ts.guard_select(fin, new_inflight, state.inflight),
                ts.guard_select(fin, new_res, state.residuals), telem)

    def _reduce(self, state, leaves, fin, rand_fn):
        """The reduce half of staleness 1: on the side stream on CUDA."""
        side = self._side
        if side is None:
            return self._reduce_body(state, leaves, fin, rand_fn)
        main = torch.cuda.current_stream(self.device)
        grads_ready = torch.cuda.Event()
        grads_ready.record(main)
        read_on_side = [*leaves, *state.residuals.values(),
                        *state.inflight.values()]
        if fin is not None:
            read_on_side.append(fin)
        for t in read_on_side:
            t.record_stream(side)
        with torch.cuda.stream(side):
            side.wait_event(grads_ready)
            new_inflight, new_res, telem = self._reduce_body(
                state, leaves, fin, rand_fn)
            done = torch.cuda.Event()
            done.record(side)
        for t in [*new_inflight.values(), *new_res.values(),
                  *telem.values()]:
            t.record_stream(main)
        self._reduce_done = done
        return new_inflight, new_res, telem

    def __call__(self, state: TrainState, batch,
                 rand_fn: Optional[RandFn] = None):
        tcfg, dev, coll = self.tcfg, self.device, self.coll
        if self.staleness and state.inflight is None:
            raise ValueError("a staleness-1 step needs in-flight buffers: "
                             "attach_inflight(state, plan) first")
        batch = dict(batch)
        fault_vec = batch.pop(FAULT_KEY, None)
        if self.inject:
            if fault_vec is None:
                raise ValueError(f"a step built with inject=True takes the "
                                 f"fault vector as batch[{FAULT_KEY!r}]")
            fault_vec = ts.batch_to_device({FAULT_KEY: fault_vec},
                                           dev)[FAULT_KEY]
        batch = ts.batch_to_device(ts.local_batch(batch, coll), dev)
        held = coll.local_ranks if coll is not None else self.dp_total
        loss, leaves = ts.rank_grads(self.model, state.params, batch, held,
                                     tcfg.microbatches)
        loss = ts.global_loss(loss, coll)
        if self.inject:
            leaves = ts.inject_nonfinite_leaves(leaves, fault_vec)
        fin = ts.ranks_all_finite(leaves, coll) if self.guard else None
        if rand_fn is None:
            rand_fn = ts.StepBits(tcfg.seed, state.step, dev,
                                      self.dp_total)
        lr = self._sched(state.step)
        if self.staleness == 0:
            # the synchronous step's ops, in its order
            reduced, new_res, telem = self._reduce_all(state, leaves,
                                                       rand_fn)
            new_res = ts.guard_select(fin, new_res, state.residuals)
            new_inflight, lr_eff = None, lr
        else:
            prev = self._reduce_done
            new_inflight, new_res, telem = self._reduce(state, leaves, fin,
                                                        rand_fn)
            if prev is not None:
                torch.cuda.current_stream(dev).wait_event(prev)
            reduced = state.inflight
            lr_eff = lr * state.inflight[VALID_KEY]
        new_p, new_opt, gnorm = ts.optimizer_half(state, reduced, leaves,
                                                  lr_eff, tcfg, self.plan,
                                                  coll)
        new_p = ts.guard_select(fin, new_p, state.params)
        new_opt = ts.guard_select(fin, new_opt, state.opt)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr_eff}
        if fin is not None:
            metrics["nonfinite"] = 1.0 - fin
        if self.telemetry:
            metrics["telemetry"] = telem
        return (TrainState(new_p, new_opt, new_res, state.step + 1,
                           new_inflight), metrics)


class Superstep:
    """``superstep(state, batches, rand_fns=None) -> (state, metrics)``:
    the batch values stacked on a leading (K,) axis, one rand_fn a step
    (or None), K pipelined steps enqueued back to back with no host sync,
    and every metric stacked to (K,). A shorter leading axis runs fewer
    steps (the driver's trailing unit)."""

    def __init__(self, step: PipelinedStep, steps: int):
        if steps < 1:
            raise ValueError(f"superstep needs steps >= 1, got {steps}")
        self.step = step
        self.plan = step.plan

    def drain(self) -> None:
        self.step.drain()

    def __call__(self, state: TrainState, batches, rand_fns=None):
        batches = ts.batch_to_device(batches, self.step.device)
        n = next(iter(batches.values())).shape[0]
        ms = []
        for i in range(n):
            state, m = self.step(state, {k: v[i] for k, v in batches.items()},
                                 None if rand_fns is None else rand_fns[i])
            ms.append(m)
        out = {k: _stack([m[k] for m in ms]) for k in ms[0]
               if k != "telemetry"}
        if "telemetry" in ms[0]:
            out["telemetry"] = self.step.stack_telemetry(
                [m["telemetry"] for m in ms])
        return state, out


def _stack(values):
    """Metrics of K steps stacked on a leading (K,) axis; a dict metric
    (the telemetry rows) entry by entry."""
    if isinstance(values[0], dict):
        return {n: torch.stack([v[n] for v in values]) for n in values[0]}
    return torch.stack(values)


def build_pipelined_step(model: Model, tcfg: TrainConfig, dp_total: int = 4,
                         device="cuda", *, staleness: int = 1,
                         guard: bool = False,
                         lowering: Optional[str] = None, plan=None,
                         telemetry: bool = True, inject: bool = False,
                         coll: Optional[CollectiveContext] = None):
    """One pipelined step. Returns (step, plan); see :class:`PipelinedStep`.
    ``guard=True`` adds the all-finite check over the raw grads: a
    non-finite gradient makes the step a no-op on params, optimizer
    state, residuals and in-flight buffers (the step counter still
    advances) and ``metrics["nonfinite"]`` reads 1.0. ``coll``: the
    manual lowering's context (``StackedCollectives(dp_total)`` if None).
    ``plan``: a replanned ``SyncPlan`` (``SyncPlan.replan`` of this
    configuration's base plan) instead of the base plan; one that changes
    the residual or in-flight layout is refused. ``inject=True`` takes
    the chaos harness's fault vector from ``batch[FAULT_KEY]`` (see the
    module)."""
    step = PipelinedStep(model, tcfg, dp_total, device, staleness, guard,
                         lowering, coll, telemetry, plan, inject)
    return step, step.plan


def build_superstep(model: Model, tcfg: TrainConfig, dp_total: int = 4,
                    device="cuda", *, staleness: int = 1, steps: int = 4,
                    guard: bool = False, lowering: Optional[str] = None,
                    plan=None, telemetry: bool = True,
                    inject: bool = False,
                    coll: Optional[CollectiveContext] = None):
    """K-step superstep over the pipelined step. Returns (superstep,
    plan); see :class:`Superstep`. ``plan`` and ``inject`` as in
    :func:`build_pipelined_step`."""
    step = PipelinedStep(model, tcfg, dp_total, device, staleness, guard,
                         lowering, coll, telemetry, plan, inject)
    return Superstep(step, steps), step.plan
