"""Adaptive re-planning: measured-density telemetry -> plan swaps (the JAX
package's ``repro.runtime.adapt``, DESIGN.md §7).

A ``SyncPlan`` freezes every bucket's algorithm at the ASSUMED TopK
density; fill-in growth, EF-residual densification and real wire costs
never feed back. This module closes the loop:

  TelemetryWindow      windows the executors' per-bucket post-reduction
                       nnz (host-side, retired steps only)
  AdaptiveController   re-runs the cost model with measured densities and
                       calibrated NetworkParams, applies hysteresis so
                       plans don't flap, and emits an accepted replan
  AdaptiveRuntime      driver-facing adapter: controller + a step cache
                       keyed by the plan's signature; the driver drains
                       its dispatch window, swaps the step, and goes on
  TelemetryObserver    adapt-shaped observer that only records per-bucket
                       telemetry metrics, for runs that want the
                       observability without re-planning

Every controller decision is also a STRUCTURED EVENT carrying the
densities and modeled costs that justified it (``adapt/replan_accepted``,
``adapt/hysteresis_veto``, ``adapt/delta_forced``,
``adapt/forced_switch``, ``adapt/forced_install``, ``adapt/replan_pending``,
``adapt/health_advisory``, ``adapt/fault_demotion``) through the
``repro_torch.obs`` handle.

Replans are layout-invariant (``BucketSpec.ef`` pins the residual set),
so a swap never migrates TrainState: the in-flight reduced buffers and EF
residuals carry straight across, and checkpoints written under any plan
version restore under any other (the active plan's algorithm map rides
the checkpoint's meta, so a restart resumes the adapted plan).

The network parameters are the caller's: the port carries no default
(``utils/calibrate.py`` fits them). The output mode (replicated or
scattered) changes the state layout, so a run pins it: replans inherit
it, ``AdaptiveRuntime.maybe_swap`` refuses a plan of another mode, and
``AdaptiveController.recommend_output_mode`` is the advisory decision a
restart acts on.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.core.cost_model import (NetworkParams, algorithm_output_cap,
                                         bucket_time, plan_bucket_times,
                                         pod_wire_bytes, t_param_allgather)
from repro_torch.core.sparse_stream import delta_threshold
from repro_torch.obs import resolve as _resolve_obs
from repro_torch.obs.metrics import record_bucket_telemetry


@dataclass(frozen=True)
class AdaptConfig:
    """Knobs of the adaptive controller."""

    window: int = 8          # retired steps of telemetry per decision
    hysteresis: float = 0.2  # min fractional modeled win to switch a bucket
    patience: int = 2        # consecutive windows agreeing before a swap
    calibrate: bool = True   # fit NetworkParams from measured timings once
    pod_sparse: bool = True  # allow demoting the cross-pod dense psum
    allow: Optional[tuple] = None  # restrict replan candidates (None = all)
    # Fault demotion (DESIGN.md §12.5): decision windows a fault-demoted
    # bucket is HELD on the dense/exact algorithm before the normal
    # hysteresis+patience machinery may re-promote it.
    demote_hold: int = 4


class TelemetryWindow:
    """Fixed-size window of per-step, per-bucket post-reduction nnz."""

    def __init__(self, window: int):
        self.window = max(1, int(window))
        self._rows: list[dict] = []

    def push(self, nnz_by_bucket: dict) -> None:
        self._rows.append(dict(nnz_by_bucket))
        if len(self._rows) > self.window:
            self._rows = self._rows[-self.window:]

    @property
    def full(self) -> bool:
        return len(self._rows) >= self.window

    def mean_nnz(self) -> dict:
        out: dict = {}
        for row in self._rows:
            for name, nnz in row.items():
                out.setdefault(name, []).append(float(nnz))
        return {name: float(np.mean(v)) for name, v in out.items()}

    def clear(self) -> None:
        self._rows = []


class AdaptiveController:
    """Pure decision logic: windowed telemetry in, accepted replans out.

    Decision rule (DESIGN.md §7): every full window, re-run
    ``SyncPlan.replan`` with the window's mean measured nnz and the
    calibrated net params; a bucket's algorithm actually changes only if
    the cost model predicts at least ``hysteresis`` fractional win AT THE
    MEASURED DENSITY (flap damping #1), and the resulting plan must win
    ``patience`` consecutive windows before it is emitted (flap damping
    #2). Cross-pod demotion (``pod_sparse``) additionally requires the
    measured fill-in to stay under the delta threshold."""

    def __init__(self, plan, net: NetworkParams,
                 cfg: AdaptConfig = AdaptConfig(), p_pod: int = 1,
                 obs=None):
        self.plan = plan
        self.net = net
        self.cfg = cfg
        self.p_pod = max(1, int(p_pod))
        self.obs = _resolve_obs(obs)
        self.window = TelemetryWindow(cfg.window)
        self._pending_sig: Optional[str] = None
        self._pending_plan = None
        self._pending_count = 0
        self._urgent = False
        # fault-demoted buckets -> remaining hold windows (§12.5): while
        # held, _decide pins the bucket to "dense" whatever the model says
        self._demoted: dict = {}
        self.swaps = 0

    # -- health advisory ---------------------------------------------------
    def advise(self, events) -> None:
        """Drain-barrier advisory from the health engine (DESIGN.md
        §10.5): CRITICAL compression-health findings (EF-residual
        blowup, mass-coverage collapse) mark the controller urgent — its
        next pending proposal is accepted after a single agreeing window
        instead of waiting out the full ``patience``. Advisory only:
        nothing is forced, hysteresis still applies, and the flag clears
        at the next accepted swap (a persisting condition simply
        re-advises at the next barrier)."""
        crit = [e for e in events
                if getattr(e, "severity", None) == "critical"
                and getattr(e, "rule", None) in ("ef_growth",
                                                 "coverage_floor")]
        if not crit:
            return
        self._urgent = True
        self.obs.event("adapt/health_advisory",
                       buckets=sorted({e.subject for e in crit}),
                       rules=sorted({e.rule for e in crit}))

    def demote(self, buckets=None):
        """Fault demotion (DESIGN.md §12.5): a HealthMonitor FAULT verdict
        (non-finite grads) forces the dense/exact algorithm onto the
        offending buckets (None = every bucket — a non-finite grad cannot
        be attributed below the leaf->bucket packing) and HOLDS them
        there for ``demote_hold`` decision windows before the normal
        hysteresis+patience machinery may re-promote. Returns the forced
        plan to install at the next drain barrier, or None when the
        targets are already dense (the hold is refreshed — a persisting
        fault re-advises every barrier without re-forcing swaps)."""
        cur = self.plan.algorithms()
        names = [n for n in cur if buckets is None or n in buckets]
        if not names:
            return None
        for n in names:
            self._demoted[n] = self.cfg.demote_hold
        if all(cur[n] == "dense" for n in names):
            return None
        forced = self.plan.replan(algorithms={n: "dense" for n in names})
        self.obs.event("adapt/fault_demotion", buckets=names,
                       hold=self.cfg.demote_hold,
                       signature=forced.signature())
        self.force(forced)
        return forced

    # -- telemetry ingest --------------------------------------------------
    def observe_step(self, nnz_by_bucket: dict):
        """Feed one retired step's stats; returns an accepted new plan
        when a swap is due, else None."""
        self.window.push(nnz_by_bucket)
        if not self.window.full:
            return None
        decision = self._decide(self.window.mean_nnz())
        self.window.clear()    # non-overlapping windows
        return decision

    # -- decision ----------------------------------------------------------
    def _bucket_ctx(self):
        for g in self.plan.groups:
            for b in g.buckets:
                yield g, b, self.plan.bucket_k(g, b)

    def _pod_flags(self, densities: dict) -> dict:
        """Cross-pod demotion decisions, WITH the hysteresis damper: the
        byte comparison must win by the hysteresis margin to set a flag,
        and an already-set flag is only cleared when the measured fill-in
        actually crosses delta — a bucket hovering at the boundary keeps
        its current wire path instead of flapping (each flip costs a full
        dispatch-window drain)."""
        flags = {}
        if self.p_pod <= 1 or not self.cfg.pod_sparse:
            return flags
        p_data = self.plan.dp_total // self.p_pod
        for g, b, k in self._bucket_ctx():
            if g.rows != 1 or not b.has_residual:
                continue
            cap = min(b.n, p_data * k)
            sparse_bytes = pod_wire_bytes(self.p_pod, b.n, cap,
                                          pod_sparse=True)
            dense_bytes = pod_wire_bytes(self.p_pod, b.n, cap,
                                         pod_sparse=False)
            nnz = densities.get(b.name)
            delta = delta_threshold(b.n, self.net.isize)
            if b.pod_sparse:
                # sticky: clear only on a real delta crossing
                flags[b.name] = bool(nnz is None or nnz < delta)
            else:
                margin = 1.0 - self.cfg.hysteresis
                flags[b.name] = bool(
                    sparse_bytes <= margin * dense_bytes
                    and nnz is not None and nnz < margin * delta)
        return flags

    def _decide(self, densities: dict):
        cfg = self.plan.cfg
        vb = cfg.qsgd_bits if cfg.qsgd_bits is not None else 32
        p = self.plan.dp_total
        replan_kw = {"pod_sparse": self._pod_flags(densities)}
        if self.cfg.allow is not None:
            # SyncPlan.replan narrows its candidate set; ServePlan has no
            # allow knob (its portfolio is the stream-cap ladder).
            replan_kw["allow"] = self.cfg.allow
        candidate = self.plan.replan(densities, self.net, **replan_kw)
        # Hysteresis: revert any per-bucket change whose modeled win at
        # the measured density is under the threshold. Exception: when
        # the measured fill-in crossed the delta threshold, the sparse
        # end-representation can no longer win (Lemma 5.2) — the paper's
        # delta switchover is a rule, not a perf heuristic, so it is
        # never vetoed by hysteresis.
        cur_algo = self.plan.algorithms()
        keep: dict = {}
        for g, b, k in ((g, b, candidate.bucket_k(g, b))
                        for g in candidate.groups for b in g.buckets):
            old = cur_algo[b.name]
            if b.algorithm == old:
                continue
            nnz = densities.get(b.name)
            # Capacity-clamped algorithms (output_cap < delta) keep O(k)
            # traffic whatever the fill-in — the delta switchover rule
            # only binds algorithms whose result width tracks the fill.
            cap = algorithm_output_cap(old, p, k, b.n)
            forced = (old.startswith("ssar") and nnz is not None
                      and nnz >= delta_threshold(b.n, self.net.isize)
                      and (cap is None
                           or cap >= delta_threshold(b.n, self.net.isize)))
            # Plans may carry their own forced-switch rule (same principle
            # as the delta crossing — a correctness boundary, not a perf
            # heuristic): the serve ServePlan forces a stream off its
            # capacity once the measured occupancy reaches it.
            hook = getattr(self.plan, "switch_forced", None)
            hook_forced = False
            if not forced and hook is not None:
                hook_forced = bool(hook(b.name, old, b.algorithm, nnz))
            if forced or hook_forced:
                self.obs.event(
                    "adapt/delta_forced" if forced else "adapt/forced_switch",
                    bucket=b.name, old=old, new=b.algorithm, nnz=nnz)
                continue
            t_old = bucket_time(old, p, k, b.n, self.net, vb,
                                reduced_nnz=nnz)
            t_new = bucket_time(b.algorithm, p, k, b.n, self.net, vb,
                                reduced_nnz=nnz)
            win = t_new <= (1.0 - self.cfg.hysteresis) * t_old
            keep[b.name] = b.algorithm if win else old
            if not win:
                self.obs.event("adapt/hysteresis_veto", bucket=b.name,
                               old=old, new=b.algorithm, nnz=nnz,
                               t_old_s=t_old, t_new_s=t_new,
                               hysteresis=self.cfg.hysteresis)
        # Fault-demotion hold (§12.5): buckets inside their hold window
        # stay dense whatever the cost model proposes; the hold ticks
        # down one per decision window, and only after it expires does
        # the normal hysteresis+patience path get to re-promote.
        if self._demoted:
            for n in self._demoted:
                if n in cur_algo:
                    keep[n] = "dense"
            for n in list(self._demoted):
                self._demoted[n] -= 1
                if self._demoted[n] <= 0:
                    del self._demoted[n]
        if keep:
            # revert ONLY the vetoed buckets; delta-forced and clear-win
            # changes keep the candidate's choice (replan defaults every
            # unnamed bucket to its current algorithm). One accepted swap
            # = one version step, whatever the internal passes did.
            candidate = dataclasses.replace(
                candidate.replan(algorithms=keep),
                version=self.plan.version + 1)
        if candidate.signature() == self.plan.signature():
            self._pending_sig, self._pending_count = None, 0
            return None
        # Patience: the same proposal must win consecutive windows.
        sig = candidate.signature()
        if sig == self._pending_sig:
            self._pending_count += 1
        else:
            self._pending_sig, self._pending_plan = sig, candidate
            self._pending_count = 1
        need = 1 if self._urgent else self.cfg.patience
        if self._pending_count < need:
            self.obs.event("adapt/replan_pending", signature=sig,
                           count=self._pending_count,
                           patience=self.cfg.patience, densities=densities)
            return None
        accepted = self._pending_plan
        self.plan = accepted
        self._pending_sig, self._pending_count = None, 0
        self._urgent = False
        self.swaps += 1
        self.obs.event("adapt/replan_accepted", signature=accepted.signature(),
                       version=accepted.version, swaps=self.swaps,
                       densities=densities)
        return accepted

    def recommend_output_mode(self, densities: dict | None = None,
                              overlap_s: float = 0.0) -> str:
        """Advisory replicated <-> scattered decision. The output mode
        changes the optimizer-state layout, so the runtime pins it for a
        run: this is a restart-barrier decision, never a ``maybe_swap``
        candidate. Sticky with the per-bucket switches' hysteresis: the
        other mode must beat the current one by the ``hysteresis``
        fraction of modeled comm time a step. Scattered is charged its
        per-bucket scatter costs plus the dense param allgather's exposed
        tail after ``overlap_s`` seconds of independent next-step compute
        (it is overlappable, so it weighs at its uncovered remainder)."""
        p = self.plan.dp_total
        cur = self.plan.output_mode
        t_mode = {}
        for mode in ("replicated", "scattered"):
            trial = (self.plan if mode == cur
                     else dataclasses.replace(self.plan, output_mode=mode))
            t = sum(plan_bucket_times(trial, p, self.net,
                                      densities=densities))
            if mode == "scattered":
                t_ag = sum(t_param_allgather(p, b.n, self.net)
                           for b in trial.buckets)
                t += max(0.0, t_ag - max(0.0, float(overlap_s)))
            t_mode[mode] = t
        other = "scattered" if cur == "replicated" else "replicated"
        switch = t_mode[other] <= (1.0 - self.cfg.hysteresis) * t_mode[cur]
        rec = other if switch else cur
        self.obs.event("adapt/mode_recommend", current=cur, recommended=rec,
                       t_replicated_s=t_mode["replicated"],
                       t_scattered_s=t_mode["scattered"],
                       overlap_s=overlap_s, hysteresis=self.cfg.hysteresis)
        return rec

    def force(self, plan) -> None:
        """Install an externally-forced plan NOW, bypassing hysteresis
        and patience — the caller hit a correctness boundary (the serve
        engine's occupancy guard crossing a stream capacity before the
        windowed controller could react). Pending proposals and the
        half-full telemetry window are dropped: they described the plan
        that was just invalidated."""
        self.plan = plan
        self._pending_sig, self._pending_plan = None, None
        self._pending_count = 0
        self.window.clear()
        self.swaps += 1
        self.obs.event("adapt/forced_install", signature=plan.signature(),
                       version=getattr(plan, "version", None),
                       swaps=self.swaps)


class AdaptiveRuntime:
    """What ``runtime.driver.run_pipelined(adapt=...)`` drives: consumes
    retired units' telemetry, and hands back the step built for the
    accepted plan (from a cache keyed by the plan's signature) whenever
    the controller accepts a replan. Swaps happen only at drain barriers
    (the driver empties its dispatch window first), so one step's work is
    in flight at a time. The arguments after ``plan`` are those of
    ``runtime.pipeline.build_pipelined_step`` / ``build_superstep``
    (``superstep`` > 1 builds the latter). ``build_fn(plan)``, when given,
    builds the step for a plan instead: the continuous serve engine
    caches its slot decode steps by ``ServePlan`` signature this way."""

    def __init__(self, model, tcfg, dp_total: int, device="cuda", *, plan,
                 net: NetworkParams, cfg: AdaptConfig = AdaptConfig(),
                 staleness: int = 1, superstep: int = 1, obs=None,
                 guard: bool = False, lowering: Optional[str] = None,
                 coll=None, inject: bool = False,
                 build_fn: Optional[Callable] = None):
        self.model, self.tcfg = model, tcfg
        self.dp_total, self.device = dp_total, device
        self.staleness, self.superstep = staleness, superstep
        # every rebuilt step keeps the guard and the chaos harness's
        # injection of the step it replaces
        self.guard, self.inject = guard, inject
        self.lowering, self.coll = lowering, coll
        self.obs = _resolve_obs(obs)
        # the pipelined step has no pod axis: its ranks are one data axis
        self.controller = AdaptiveController(plan, net, cfg, p_pod=1,
                                             obs=self.obs)
        # the output mode is pinned for the runtime's life: it changes the
        # state layout, which a drain-barrier swap cannot migrate
        self._output_mode = plan.output_mode
        self._build_fn = build_fn or self._build
        self._cache: dict = {}
        self._swap_to = None
        self._demote_at = None

    # -- step cache --------------------------------------------------------
    def _build(self, plan):
        from repro_torch.runtime import pipeline as rt_pipeline

        kw = dict(staleness=self.staleness, guard=self.guard,
                  lowering=self.lowering, plan=plan, coll=self.coll,
                  inject=self.inject, net=self.controller.net)
        if self.superstep > 1:
            fn, _ = rt_pipeline.build_superstep(
                self.model, self.tcfg, self.dp_total, self.device,
                steps=self.superstep, **kw)
        else:
            fn, _ = rt_pipeline.build_pipelined_step(
                self.model, self.tcfg, self.dp_total, self.device, **kw)
        return fn

    def step_fn_for(self, plan):
        sig = plan.signature()
        if sig not in self._cache:
            self._cache[sig] = self._build_fn(plan)
        return self._cache[sig]

    @property
    def current_plan(self):
        return self.controller.plan

    def current_fn(self):
        return self.step_fn_for(self.current_plan)

    # -- driver hooks ------------------------------------------------------
    def observe(self, first_step: int, n_steps: int, metrics) -> None:
        """Retire hook: pull per-bucket telemetry off a retired unit's
        metrics (host arrays the driver has read back) and feed the
        controller, one row per step of the unit; then apply a demotion
        scheduled by ``demote_after`` for the unit that ends here."""
        telem = metrics.get("telemetry") if hasattr(metrics, "get") else None
        if telem:
            arrs = {name: np.atleast_2d(np.asarray(v)) for name, v in
                    telem.items()}
            # (k, 4) [nnz, wire, mass coverage, EF norm] rows: col 0 (nnz)
            # drives replans; every column feeds the health histograms
            record_bucket_telemetry(self.obs.metrics, arrs)
            k = min(a.shape[0] for a in arrs.values())
            for i in range(k):
                row = {name: float(a[i, 0]) for name, a in arrs.items()}
                accepted = self.controller.observe_step(row)
                if accepted is not None:
                    self._swap_to = accepted
        if self._demote_at is not None and \
                first_step + n_steps == self._demote_at[0]:
            names, self._demote_at = self._demote_at[1], None
            self.demote(names)

    def demote(self, names=None) -> None:
        """Fault-demote the buckets ``names`` (None = all) to dense
        (AdaptiveController.demote); the forced plan installs at the
        next drain barrier via maybe_swap."""
        forced = self.controller.demote(names)
        if forced is not None:
            self._swap_to = forced

    def demote_after(self, step: int, names) -> None:
        """Schedule ``demote(names)`` after the retired unit that ends at
        ``step``: a forced swap at a known drain barrier."""
        self._demote_at = (int(step), set(names))

    def advise(self, events) -> None:
        """Forward the driver's drain-barrier health advisory to the
        controller (see AdaptiveController.advise), and act on FAULT
        verdicts: a critical ``nonfinite`` finding demotes the offending
        buckets to the dense algorithm; the forced plan installs at the
        next drain barrier via maybe_swap, with the controller's
        demote-hold gating re-promotion."""
        self.controller.advise(events)
        crit = [e for e in events
                if getattr(e, "severity", None) == "critical"
                and getattr(e, "rule", None) == "nonfinite"]
        if not crit:
            return
        bucket_names = {b.name for g in self.controller.plan.groups
                        for b in g.buckets}
        subjects = {getattr(e, "subject", None) for e in crit} & bucket_names
        self.demote(subjects or None)

    def maybe_swap(self):
        """Returns (new step, new plan) once after each accepted replan,
        else None. The driver calls this between dispatches and drains
        its window before installing the new step."""
        if self._swap_to is None:
            return None
        plan, self._swap_to = self._swap_to, None
        if plan.output_mode != self._output_mode:
            raise RuntimeError(
                f"a replan changed the output_mode ({self._output_mode!r} -> "
                f"{plan.output_mode!r}); the mode is pinned for a run: use "
                "AdaptiveController.recommend_output_mode and restart")
        return self.step_fn_for(plan), plan


class TelemetryObserver:
    """``run_pipelined(adapt=...)`` duck-type that RECORDS the in-graph
    per-bucket telemetry (nnz / wire-bytes histograms) without ever
    proposing a replan — the metrics path for runs that compile telemetry
    in but leave the adaptive controller off."""

    def __init__(self, obs=None):
        self.obs = _resolve_obs(obs)

    def observe(self, first_step: int, n_steps: int, metrics) -> None:
        telem = metrics.get("telemetry") if hasattr(metrics, "get") else None
        if not telem or not self.obs.metrics_on:
            return
        arrs = {name: np.atleast_2d(np.asarray(v)) for name, v in
                telem.items()}
        record_bucket_telemetry(self.obs.metrics, arrs)

    def maybe_swap(self):
        return None
