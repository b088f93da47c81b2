"""Training driver (the JAX package's ``repro.train.trainer``).

Two loops:

* :meth:`Trainer.run`, the synchronous reference: each step takes the
  deterministic synthetic batch of its step number, runs the train step
  and waits for its loss;
* :meth:`Trainer.run_pipelined`, the non-blocking runtime: pipelined
  stale-gradient supersteps (``runtime/pipeline.py``) dispatched by the
  double-buffered async driver (``runtime/driver.py``).

Both record losses and step times through one logging policy with the
straggler watchdog, checkpoint every ``ckpt_every`` steps and at the end
when a ``ckpt_dir`` is given, and resume from the newest checkpoint that
passes CRC verification. Their checkpoints are interchangeable, and
interchangeable with the JAX package's: the pipelined loop strips the
in-flight buffers before saving and attaches zeros after every restore.
Both run either lowering, over stacked ranks or one rank a process; a
run with one rank a process checkpoints as the stacked run does (rank 0
gathers and writes, each process restores its own rank's slices), and
an fsdp (ZeRO-3) state is written whole and cut again at restore.

``obs`` (``repro_torch.obs``) backs the log with its metrics registry,
and the synchronous loop's step records its ``sparcml.*`` phase spans
with it (``train_step.build_train_step``). ``run_pipelined`` builds the per-bucket telemetry into its step when
metrics are on, and records the rows (``TelemetryObserver``) or, with
``adapt``, feeds them to the adaptive controller (``AdaptiveRuntime``),
whose accepted replans swap the step at drain barriers; checkpoints then
carry the active plan, and a resume rebuilds it (a checkpoint of the JAX
package's included). The network parameters the controller costs plans
with are fitted once a Trainer (``utils/calibrate.py``) on its own
context.

A sparcml config with ``algorithm="auto"`` (the default) selects each
bucket's algorithm by the cost model before the step is built, on the
``net`` the Trainer is given or on that fit (over a process group, rank
0's fit on every rank, so every rank builds the same plan). Its
checkpoints carry the parameters and the plan's algorithm map, and a
resume rebuilds that plan from them, whatever a new fit would select.

A resume converts the optimizer state when the checkpoint was written
under the other ZeRO layout (zero1_leaf <-> zero_scattered, value for
value), and ``resume_elastic`` restores onto another replica count.
``run_pipelined(injector=..., recovery=...)`` runs a chaos plan under the
retry supervisor (``runtime/faults.py``): the guarded, injectable step,
checkpoint corruption after each save, and restores that fall back to
the newest checkpoint that verifies.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.core.cost_model import NetworkParams
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.obs import resolve as _resolve_obs
from repro_torch.runtime.driver import DriverLog, record_step
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import TrainConfig, TrainState
from repro_torch.train import train_step as ts
from repro_torch.train.train_step import build_train_step, init_state
from repro_torch.utils.tree import tree_leaves, tree_map

TrainerLog = DriverLog


class Trainer:
    """Trains ``model`` under ``tcfg`` with ``dp_total`` data-parallel
    replicas on ``device`` (the card unless the caller asks for the CPU).
    ``lowering`` picks the sparcml executor of both loops: "spmd" (the
    stacked sum) or "manual" (the per-rank wire protocols). ``coll``, a
    ``ProcessGroupCollectives``, runs the manual lowering one rank a
    process over ``torch.distributed`` (each process its own Trainer,
    all of them given the same ``ckpt_dir``); without it the ranks are
    stacked on one device. ``obs``: a
    ``repro_torch.obs.Observability`` handle (None = the session default,
    off unless configured). ``net``: the ``NetworkParams`` that
    ``algorithm="auto"`` and the adaptive loop cost plans on (None: fitted
    once on the Trainer's context when needed)."""

    def __init__(self, model, tcfg: TrainConfig, data_cfg: DataConfig, *,
                 dp_total: int = 4, device="cuda",
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 straggler_factor: float = 3.0, lowering: str = "spmd",
                 coll=None, obs=None, net=None):
        self.device = resolve_device(device)
        self.model = model
        self.tcfg = tcfg
        self.data_cfg = data_cfg
        self.dp_total = dp_total
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.obs = _resolve_obs(obs)
        self.log = TrainerLog(
            registry=self.obs.metrics if self.obs.metrics_on else None)
        self.lowering = lowering
        self.coll = coll
        self._net_given = net
        self._net_cal = net         # NetworkParams: given, or fitted once
        self._build_step()
        self.fsdp_layout = (ts.fsdp_layout_of(model, dp_total) if tcfg.fsdp
                            else None)
        # the process that writes checkpoints: rank 0 of a process group
        self._root = not ckpt.one_rank_a_process(coll) or coll.rank == 0
        self.state: Optional[TrainState] = None
        # the AdaptiveRuntime of the last run_pipelined(adapt=...) call
        self.last_adapt_runtime = None
        # the plan the last run_pipelined ended on (what obs.audit_sync_plan
        # probes after a run)
        self.last_plan = None
        # the HealthMonitor of the last run_pipelined with metrics on
        self.last_health = None

    def _build_step(self) -> None:
        """The step and its plan. Under "auto" the plan is selected on the
        network parameters (a resume's: the newest checkpoint's, with its
        algorithm map; else given or fitted)."""
        self._plan_net, plan = None, None
        if ts.resolves_auto(self.tcfg):
            meta = self._resume_meta()
            if meta.get("net"):
                self._net_cal = NetworkParams(**meta["net"])
            self._plan_net = self._calibrated_net()
            if meta.get("plan_algorithms"):
                plan = ts.build_plan(
                    self.model, self.tcfg, self.dp_total,
                    self._plan_net).replan(
                        algorithms=meta["plan_algorithms"],
                        pod_sparse=meta.get("plan_pod_sparse"))
        self.step_fn, self.plan = build_train_step(
            self.model, self.tcfg, self.dp_total, self.device, self.lowering,
            self.coll, net=self._plan_net, plan=plan, obs=self.obs)

    def _resume_meta(self) -> dict:
        """The meta of the newest checkpoint under ``ckpt_dir`` whose
        meta.json reads ({} when there is none)."""
        if not self.ckpt_dir:
            return {}
        for step in reversed(ckpt._steps(self.ckpt_dir)):
            try:
                return ckpt.load_meta(self.ckpt_dir, step)
            except (OSError, ValueError):
                continue
        return {}

    def _plan_meta(self, plan) -> dict:
        """What a checkpoint records of the plan it was written under."""
        out = {"plan_signature": plan.signature(),
               "plan_version": plan.version,
               "plan_algorithms": plan.algorithms(),
               "plan_pod_sparse": plan.pod_sparse_flags()}
        if self._plan_net is not None:
            net = self._plan_net
            out["net"] = {"alpha": net.alpha,
                          "link_bytes_per_s": net.link_bytes_per_s,
                          "isize": net.isize}
        return out

    # -- lifecycle ---------------------------------------------------------
    def init(self, params=None) -> int:
        """Fresh state (from ``params`` when given), ignoring checkpoints."""
        self.state = init_state(self.model, self.tcfg, self.plan, self.device,
                                params=params, coll=self.coll,
                                dp_total=self.dp_total)
        return self.state.step

    def init_or_resume(self, params=None) -> int:
        """Fresh state, or the newest checkpoint under ``ckpt_dir`` that
        passes CRC verification. Returns the step to start from."""
        self.init(params)
        if self.ckpt_dir and ckpt.latest_step(self.ckpt_dir) is not None:
            self.state = self._restore()
            self.log.restarts += 1
        return self.state.step

    def _restore(self) -> TrainState:
        """The newest verified checkpoint in this config's optimizer
        layout: one written under the other ZeRO layout is restored into
        a template of its own layout and converted (the reference's
        ``_restore_any_layout``; one rank a process converts every rank's
        chunks and keeps its own)."""
        return self._restore_newest(self._restore_step)

    def _restore_newest(self, restore_step) -> TrainState:
        """``restore_step(step)`` (a restore with ``verify=True``: one read
        of the checkpoint, its CRCs checked on the way) of the newest
        checkpoint that verifies; falls back past corrupt newer ones (a
        ``recovery/ckpt_fallback`` event), raises when none verifies."""
        newest = ckpt.latest_step(self.ckpt_dir)
        step, state = ckpt.restore_newest_valid(self.ckpt_dir, restore_step)
        if step != newest:
            self.obs.event("recovery/ckpt_fallback", step=step,
                           corrupt_step=newest)
            if self.obs.metrics_on:
                self.obs.metrics.counter("recovery/ckpt_fallbacks").inc()
        return state

    def _restore_step(self, step: int) -> TrainState:
        mine = ckpt.opt_layout_of(self.tcfg)
        theirs = ckpt.load_meta(self.ckpt_dir, step).get("opt_layout", mine)
        like = self.state._replace(inflight=None)
        kw = dict(dp_total=self.dp_total, step=step, fsdp=self.fsdp_layout,
                  verify=True)
        if theirs == mine:
            return ckpt.restore(self.ckpt_dir, like, coll=self.coll, **kw)
        if {theirs, mine} != {"zero1_leaf", "zero_scattered"}:
            raise ValueError(
                f"checkpoint opt layout {theirs!r} is not resumable under "
                f"{mine!r} (only zero1_leaf <-> zero_scattered)")
        every = ckpt.one_rank_a_process(self.coll)
        like = like._replace(opt=ts.init_opt(like.params, self.tcfg,
                                             self.plan, self.device,
                                             layout=theirs))
        if every:
            like = like._replace(residuals=self.plan.init_residuals(
                self.device))
        restored = ckpt.convert_opt_layout(
            ckpt.restore(self.ckpt_dir, like, **kw), self.plan,
            source=theirs, target=mine)
        if not every:
            return restored
        r = self.coll.rank
        own = lambda t: t[r:r + 1]  # noqa: E731
        return restored._replace(
            opt={k: v if k == "count" else tree_map(own, v)
                 for k, v in restored.opt.items()},
            residuals=tree_map(own, restored.residuals))

    def resume_elastic(self, dp_total: int) -> int:
        """An elastic restart onto ``dp_total`` replicas: the steps are
        rebuilt for the new count and the newest checkpoint restored with
        ``remesh`` (ZeRO chunks re-split, EF residuals reset). Returns the
        step to start from."""
        if self.coll is not None:
            raise ValueError("resume_elastic re-stacks the ranks of one "
                             "process: not for a run with one rank a process")
        self.dp_total = dp_total
        # the saved plan was for the old p: "auto" selects again, on the
        # given parameters or on a fit over the new ranks
        self._net_cal = self._net_given
        self._plan_net = None
        if ts.resolves_auto(self.tcfg):
            self._plan_net = self._calibrated_net()
        self.step_fn, self.plan = build_train_step(
            self.model, self.tcfg, dp_total, self.device, self.lowering,
            net=self._plan_net, obs=self.obs)
        if self.tcfg.fsdp:
            self.fsdp_layout = ts.fsdp_layout_of(self.model, dp_total)
        self.init()
        if self.ckpt_dir and ckpt.latest_step(self.ckpt_dir) is not None:
            like = self.state
            self.state = self._restore_newest(lambda step: ckpt.restore(
                self.ckpt_dir, like, dp_total=dp_total, step=step,
                remesh=True, verify=True, fsdp=self.fsdp_layout))
        return self.state.step

    def _verified_step(self) -> int:
        """The newest checkpoint that passes CRC verification; falls back
        past corrupt newer ones (a ``recovery/ckpt_fallback`` event),
        raises when none verifies."""
        newest = ckpt.latest_step(self.ckpt_dir)
        step = ckpt.latest_valid_step(self.ckpt_dir)
        if step is None:
            raise ckpt.CheckpointCorrupt(
                f"no checkpoint under {self.ckpt_dir} passes CRC "
                "verification (retention window exhausted)")
        if step != newest:
            self.obs.event("recovery/ckpt_fallback", step=step,
                           corrupt_step=newest)
            if self.obs.metrics_on:
                self.obs.metrics.counter("recovery/ckpt_fallbacks").inc()
        return step

    def _save(self, state: TrainState, extra_meta=None) -> None:
        """Every process calls it (see ``checkpoint.save``). A plan from
        "auto" is recorded whatever the loop (the active one when
        ``extra_meta`` names it)."""
        if self._plan_net is not None and not (extra_meta or {}).get(
                "plan_algorithms"):
            extra_meta = {**(extra_meta or {}), **self._plan_meta(self.plan)}
        ckpt.save(self.ckpt_dir, state._replace(inflight=None),
                  dp_total=self.dp_total, extra_meta=extra_meta,
                  opt_layout=ckpt.opt_layout_of(self.tcfg), coll=self.coll,
                  fsdp=self.fsdp_layout)

    # -- synchronous loop --------------------------------------------------
    def run(self, num_steps: int, rand_fn_for_step=None,
            fail_at: Optional[int] = None) -> TrainerLog:
        """Train up to step ``num_steps`` (absolute). ``rand_fn_for_step``
        (step -> rand_fn) overrides the QSGD rounding bits; ``fail_at``
        raises once before that step, for tests of the restore path."""
        if self.state is None:
            self.init_or_resume()
        if self.state.inflight is not None:
            # hand-off from a pipelined run: drop the in-flight reduction
            # (one step of gradients, as on a restart)
            self.state = self.state._replace(inflight=None)
        while self.state.step < num_steps:
            step = self.state.step
            batch = synthetic_batch(self.data_cfg, step)
            rand_fn = rand_fn_for_step(step) if rand_fn_for_step else None
            t0 = time.perf_counter()
            try:
                if fail_at is not None and step == fail_at:
                    fail_at = None
                    raise RuntimeError("injected node failure")
                new_state, metrics = self.step_fn(self.state, batch, rand_fn)
                loss = float(metrics["loss"])
            except Exception:
                if not self.ckpt_dir:
                    raise
                self.log.restarts += 1
                self.state = self._restore()
                continue
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.state = new_state
            record_step(self.log, step, dt, loss, self.straggler_factor)
            if self.ckpt_dir and (step + 1) % self.ckpt_every == 0:
                self._save(self.state)
        if self.ckpt_dir:
            self._save(self.state)
        return self.log

    # -- non-blocking runtime ----------------------------------------------
    def run_pipelined(self, num_steps: int, *, staleness: int = 1,
                      superstep: int = 4, depth: int = 2, prefetch: int = 2,
                      guard: bool = True, rand_fn_for_step=None,
                      adapt=False, injector=None,
                      recovery=None) -> TrainerLog:
        """Train up to step ``num_steps`` (absolute) with the pipelined
        runtime: ``superstep``-step units of stale-gradient steps
        (``staleness`` in {0, 1}; at 1 the reduce half runs on a side
        CUDA stream) dispatched ``depth`` deep by the async driver, with
        background data prefetch. ``guard`` builds the guarded step:
        non-finite gradients skip the apply with residuals and optimizer
        state kept, and three trips in a row rewind to the last
        checkpoint. Checkpoints store the synchronous state (in-flight
        buffers stripped).

        ``adapt`` (False | True | ``runtime.adapt.AdaptConfig``) turns on
        closed-loop re-planning: per-bucket measured densities feed the
        cost model on the calibrated network parameters, and accepted
        replans swap the step at drain barriers. Checkpoints then carry
        the active plan's signature and algorithm map, so a restart
        resumes the adapted plan. Without ``adapt`` the step emits its
        telemetry rows only when the metrics registry is on, and they are
        recorded.

        ``recovery`` (a ``runtime.faults.RecoveryConfig``) bounds the
        driver's restores with per-fault-class retry budgets and jittered
        backoff; ``injector`` (a ``runtime.faults.FaultInjector``) runs
        its chaos plan against this run: the step is built to take its
        grad-leaf NaN/Inf vector, and each save may be corrupted after it
        lands (the CRC fallback restores the newest valid one)."""
        from repro_torch.runtime import adapt as rt_adapt
        from repro_torch.runtime import driver as rt_driver
        from repro_torch.runtime import pipeline as rt_pipeline

        if self.state is None:
            self.init_or_resume()
        inject = injector is not None
        if inject:
            # the fault vector is indexed by grad leaf, the params' order
            injector.bind(n_leaves=len(tree_leaves(self.state.params)))
        kw = dict(staleness=staleness, guard=guard, lowering=self.lowering,
                  coll=self.coll, inject=inject, net=self._plan_net)
        runtime = None
        if adapt:
            if staleness < 1:
                raise ValueError("adaptive re-planning rides the pipelined "
                                 "runtime: needs staleness >= 1")
            acfg = (adapt if isinstance(adapt, rt_adapt.AdaptConfig)
                    else rt_adapt.AdaptConfig())
            if not acfg.calibrate:
                raise ValueError(
                    "AdaptConfig(calibrate=False) needs network parameters "
                    "(alpha, link_bytes_per_s) and the port carries no "
                    "default NetworkParams: calibrate, or build "
                    "AdaptiveRuntime(net=...) directly")
            plan0 = ts.build_plan(self.model, self.tcfg, self.dp_total,
                                  self._plan_net)
            if self.ckpt_dir and ckpt.latest_step(self.ckpt_dir) is not None:
                meta = ckpt.load_meta(self.ckpt_dir, self._verified_step())
                if meta.get("plan_algorithms"):
                    plan0 = plan0.replan(
                        algorithms=meta["plan_algorithms"],
                        pod_sparse=meta.get("plan_pod_sparse"))
            kw.pop("net")       # the runtime builds on its controller's
            runtime = rt_adapt.AdaptiveRuntime(
                self.model, self.tcfg, self.dp_total, self.device,
                plan=plan0, net=self._calibrated_net(), cfg=acfg,
                superstep=superstep, obs=self.obs, **kw)
            self.last_adapt_runtime = runtime
            fn, plan = runtime.current_fn(), runtime.current_plan
        else:
            # no controller to consume the rows: emit them only when a
            # registry records them
            telemetry = self.obs.metrics_on
            if superstep > 1:
                fn, plan = rt_pipeline.build_superstep(
                    self.model, self.tcfg, self.dp_total, self.device,
                    steps=superstep, telemetry=telemetry, plan=self.plan,
                    **kw)
            else:
                fn, plan = rt_pipeline.build_pipelined_step(
                    self.model, self.tcfg, self.dp_total, self.device,
                    telemetry=telemetry, plan=self.plan, **kw)
            if telemetry:
                runtime = rt_adapt.TelemetryObserver(self.obs)
        ranks = self.coll.local_ranks if self.coll is not None else None
        state = self.state
        if staleness:
            state = rt_pipeline.attach_inflight(state, plan, ranks)
        elif state.inflight is not None:
            state = state._replace(inflight=None)

        def ckpt_fn(s):
            active = getattr(runtime, "current_plan", None)
            self._save(s, self._plan_meta(active) if active is not None
                       else None)
            if inject:
                # a scheduled ckpt_corrupt flips bytes in the save that
                # just landed (rank 0 writes them, every process counts
                # the fault); the CRC fallback of the restore survives it
                injector.corrupt_checkpoint(self.ckpt_dir, int(s.step),
                                            write=self._root)
                ckpt.barrier(self.coll)

        def restore_fn():
            restored = self._restore()
            return (rt_pipeline.attach_inflight(restored, plan, ranks)
                    if staleness else restored)

        health = None
        if self.obs.metrics_on:
            from repro_torch.obs.health import HealthMonitor

            health = HealthMonitor(self.obs.metrics,
                                   audit=getattr(self.obs, "audit", None))
            self.last_health = health

        state, _ = rt_driver.run_pipelined(
            fn, state, start_step=state.step, num_steps=num_steps,
            batch_fn=lambda step: synthetic_batch(self.data_cfg, step),
            rand_fn_for_step=rand_fn_for_step,
            cfg=rt_driver.DriverConfig(depth=depth, prefetch=prefetch,
                                       steps_per_unit=superstep),
            log=self.log, straggler_factor=self.straggler_factor,
            ckpt_every=self.ckpt_every if self.ckpt_dir else None,
            ckpt_fn=ckpt_fn if self.ckpt_dir else None,
            restore_fn=restore_fn if self.ckpt_dir else None,
            adapt=runtime, obs=self.obs, health=health, recovery=recovery, injector=injector)
        self.state = state
        self.last_plan = getattr(runtime, "current_plan", None) or plan
        if self.ckpt_dir:
            ckpt_fn(self.state)
        return self.log

    def _calibrated_net(self):
        """The network parameters of this Trainer's context, fitted once
        (``utils/calibrate.py``): over the process group for a run with
        one rank a process, else over the stacked ranks on the Trainer's
        device (the device's sum over the rank axis: no wire). The
        observability handle's auditor, when attached, receives the
        post-fit ladder residuals."""
        if self._net_cal is None:
            from repro_torch.comm.collectives import StackedCollectives
            from repro_torch.utils.calibrate import calibrate

            coll = (self.coll if self.coll is not None
                    else StackedCollectives(self.dp_total, self.device))
            self._net_cal = calibrate(
                coll, auditor=getattr(self.obs, "audit", None))
        return self._net_cal
