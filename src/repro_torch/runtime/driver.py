"""Double-buffered non-blocking host driver (the JAX package's
``repro.runtime.driver``, DESIGN.md §6).

``Trainer.run`` enqueues one step, then waits for its loss before it
enqueues the next: the host's round trip serialises with the device.
This driver keeps a dispatch WINDOW instead:

  * **async dispatch**: up to ``depth`` units (steps, or K-step
    supersteps) are enqueued before the oldest is retired, so the card's
    queue stays full while the host prepares the next batch;
  * **data prefetch**: a background thread builds host batches
    ``prefetch`` units ahead of dispatch;
  * **retire-only syncing**: at dispatch the unit's stacked losses (and
    guard flags) start one non-blocking copy to pinned host memory and an
    event is recorded after it; retiring a unit waits on that event and
    nothing else. Checkpoints first drain the window and the step's side
    stream, so the save reads a fully retired state.

Step times are retire-to-retire wall intervals divided by the unit's
step count: with the window full, that is the steady-state cost of a
step, with dispatch overhead and data generation overlapped. Pipeline
fill inflates the first interval and the final drain deflates the last,
so the one summary statistic of ``log.step_times`` is the rolling median
of the last ``STRAGGLER_WINDOW`` steps, which the straggler watchdog
compares against (``record_step``).

The driver is state-linear: after a dispatch only the returned state is
live. On failure the window is discarded and ``restore_fn`` supplies a
replayable state (the data pipeline is keyed by step, so replayed batches
are identical).

Observability (``repro_torch.obs``): ``run_pipelined`` takes an ``obs``
handle. Host spans wrap dispatch, retire, drain and checkpoint; plan
swaps, restarts and guard trips become structured events; the retire
intervals feed the ``driver/retire_wall_s`` histogram. A unit's
per-bucket telemetry rows join its losses in the one non-blocking host
copy, so with observability on the retire is still the only host wait
(``_wait``, which tests count). ``adapt`` (``runtime/adapt.py``) is fed
each retired unit's rows and may hand back a replanned step, installed
at a drain barrier; ``health`` (``obs.HealthMonitor``) is evaluated at
drain barriers and at the end.

Faults (``runtime/faults.py``): ``recovery`` turns the bare
restore-on-failure into the bounded policy of the retry supervisor
(classify the exception, charge its class's budget, wait out a jittered
backoff, then restore; a spent budget is a clean abort after the
blackbox dump), and ``injector`` runs a chaos plan against the run: its
stall and fault-vector hooks wrap ``batch_fn`` on the prefetch thread,
its collective / SIGTERM hook fires before each dispatch, its straggler
hook inside each retire interval, and every restore first refunds the
fault vectors made for steps never dispatched. Before any restore the
step is drained, so no kernel still reads buffers the restored state
will reuse.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from statistics import median
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.obs import resolve as _resolve_obs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.faults import (NonFiniteEscalation, PrefetchStalled,
                                        RecoveryConfig, RetrySupervisor)

# Rolling window (in steps) of the step-time statistic the straggler
# watchdog compares against.
STRAGGLER_WINDOW = 50
# Minimum retired steps before the watchdog trusts the median at all.
STRAGGLER_WARMUP = 5


@dataclass(frozen=True)
class DriverConfig:
    depth: int = 2          # dispatched-but-unretired units (double-buffered)
    prefetch: int = 2       # units of host batches prepared ahead
    steps_per_unit: int = 1 # K of the superstep (1 = plain step)
    # Bound on waiting for the prefetch thread before declaring the data
    # pipeline stalled. Generous: batch generation takes milliseconds.
    prefetch_timeout_s: float = 60.0


class DriverLog:
    """Run log shared by ``Trainer.run`` and the driver, with
    registry-backed storage: the public fields are plain lists that are
    views of ``Series`` metrics in a ``MetricsRegistry``, so a run with
    metrics on exports losses, step times, straggler and plan-swap events
    through the JSONL sink with no second bookkeeping path. With no
    registry the log owns a private (disabled) one."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry(enabled=False)
        self.losses = self.registry.series("train/loss").data
        self.step_times = self.registry.series("train/step_time_s").data
        # (step, dt, rolling median) triples
        self.straggler_events = \
            self.registry.series("driver/straggler_events").data
        # (step, plan signature) pairs
        self.plan_swaps = self.registry.series("driver/plan_swaps").data

    @property
    def restarts(self) -> int:
        return self.registry.counter("driver/restarts").value

    @restarts.setter
    def restarts(self, v: int) -> None:
        self.registry.counter("driver/restarts").value = int(v)


def record_step(log: DriverLog, step: int, dt: float, loss: float,
                straggler_factor: float) -> None:
    """Append one step's loss and wall time and run the straggler
    watchdog: a step slower than ``straggler_factor`` times the rolling
    median of the last ``STRAGGLER_WINDOW`` step times records a
    ``(step, dt, median)`` event and bumps the ``driver/stragglers``
    counter; the median is exported as the ``driver/straggler_median_s``
    gauge. The one logging policy of both loops."""
    log.losses.append(loss)
    log.step_times.append(dt)
    if len(log.step_times) >= STRAGGLER_WARMUP:
        med = median(log.step_times[-STRAGGLER_WINDOW:])
        log.registry.gauge("driver/straggler_median_s").set(med)
        if dt > straggler_factor * med:
            log.straggler_events.append((step, dt, med))
            log.registry.counter("driver/stragglers").inc()
            log.registry.event("driver/straggler", step=step, dt_s=dt,
                               median_s=med, factor=straggler_factor)


class _Prefetcher:
    """Background thread producing HOST batches ahead of dispatch (the
    device copy stays on the driver's thread). Restartable after a
    failure."""

    def __init__(self, batch_fn: Callable[[int], Any], prefetch_units: int,
                 steps_per_unit: int):
        self._batch_fn = batch_fn
        self._cap = max(1, prefetch_units) * steps_per_unit
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self, start_step: int, num_steps: int):
        self.stop()
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self._cap)
        stop, q = self._stop, self._q

        def work():
            for s in range(start_step, num_steps):
                if stop.is_set():
                    return
                try:
                    item = (s, self._batch_fn(s))
                except Exception as e:  # surfaced by take() on the driver
                    item = (None, e)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if item[0] is None:
                    return

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def take(self, step: int, timeout: float = 60.0):
        """The batch of ``step``; raises :class:`PrefetchStalled` when the
        producer died or produced nothing within ``timeout``."""
        if self._q is None:
            raise RuntimeError("prefetcher not started")
        deadline = time.perf_counter() + timeout
        while True:
            try:
                s, batch = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                alive = self._thread is not None and self._thread.is_alive()
                if not alive and self._q.empty():
                    raise PrefetchStalled(
                        f"prefetch thread died before producing step {step}")
                if time.perf_counter() >= deadline:
                    raise PrefetchStalled(
                        f"no batch for step {step} within {timeout:.1f}s "
                        "(data pipeline stalled)")
        if s is None:
            raise PrefetchStalled(
                f"prefetch batch_fn failed at step {step}: {batch!r}",
                cause=batch) from batch
        if s != step:
            raise RuntimeError(f"prefetcher produced step {s}, expected "
                               f"{step}")
        return batch

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            try:  # drain so the producer can observe the stop flag
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            self._thread = None


def _wait(done: Optional[torch.cuda.Event]) -> None:
    """The driver's one host wait: the end of the retiring unit's
    readback copy (nothing to wait for on the CPU)."""
    if done is not None:
        done.synchronize()


def _readback(metrics, step_fn, stream: Optional[torch.cuda.Stream]):
    """Start the one host copy of a unit: its losses, for a guarded step
    its nonfinite flags, and its per-bucket telemetry rows, stacked into
    one (R, k) f32 tensor (loss, [nonfinite], then 4 rows a bucket).
    Returns (values, telemetry bucket names, event). On CUDA the stack
    and the copy to pinned memory run on the driver's readback
    ``stream``, after the main stream's work so far and, when telemetry
    rows ride in the copy, after the step's last reduce on its side
    stream (``step_fn.drain()`` issued on that stream, since the rows are
    that reduce's results), without blocking; the returned event marks
    the copy's end.
    On the CPU the values are there already."""
    loss = metrics["loss"]
    k = loss.numel()
    rows = [loss.reshape(1, k)]
    if "nonfinite" in metrics:
        rows.append(metrics["nonfinite"].reshape(1, k))
    telem = metrics.get("telemetry") or {}
    names = list(telem)
    rows += [telem[n].reshape(k, -1).t() for n in names]
    if not loss.is_cuda:
        return torch.cat([r.to(torch.float32) for r in rows]), names, None
    stream.wait_stream(torch.cuda.current_stream(loss.device))
    for r in rows:
        r.record_stream(stream)
    with torch.cuda.stream(stream):
        if names:
            step_fn.drain()
        vals = torch.cat([r.to(torch.float32) for r in rows])
        host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        host.copy_(vals, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return host, names, done


def _host_metrics(vals: np.ndarray, names: list, guarded: bool) -> dict:
    """A retired unit's metrics from its read-back values: "loss" (k,),
    "nonfinite" (k,) for a guarded step, and "telemetry" {bucket -> (k,
    4)} when the step emits rows."""
    out = {"loss": vals[0]}
    off = 1
    if guarded:
        out["nonfinite"] = vals[1]
        off = 2
    if names:
        out["telemetry"] = {n: vals[off + 4 * i:off + 4 * i + 4].T
                            for i, n in enumerate(names)}
    return out


def run_pipelined(
    step_fn: Callable,
    state,
    *,
    start_step: int,
    num_steps: int,
    batch_fn: Callable[[int], Any],
    rand_fn_for_step: Optional[Callable[[int], Any]] = None,
    cfg: DriverConfig = DriverConfig(),
    log: Optional[DriverLog] = None,
    straggler_factor: float = 3.0,
    ckpt_every: Optional[int] = None,
    ckpt_fn: Optional[Callable[[Any], None]] = None,
    restore_fn: Optional[Callable[[], Any]] = None,
    adapt=None,
    obs=None,
    health=None,
    recovery=None,
    injector=None,
):
    """Drive ``step_fn`` from ``start_step`` to ``num_steps`` (absolute).

    step_fn: a pipelined step (``cfg.steps_per_unit == 1``) or a
    superstep taking batches stacked (K, ...) and a list of K rand_fns;
    it has a ``drain()`` method (``runtime.pipeline``). A trailing unit
    shorter than K runs with the smaller leading axis.
    batch_fn: step -> HOST batch dict (numpy); called from the prefetch
    thread, so it must be thread-compatible (the synthetic pipeline is).
    rand_fn_for_step: step -> QSGD rand_fn, or None for the step's own
    seeded bits.
    adapt: an ``runtime.adapt.AdaptiveRuntime`` (duck-typed: ``observe``
    + ``maybe_swap``, optionally ``advise``). Retired units feed it their
    metrics (host arrays); when it accepts a replan the window is DRAINED
    and the step swapped at that barrier; the state rides across
    unchanged (replans are layout-invariant), and the swap is recorded in
    ``log.plan_swaps`` and as a ``driver/plan_swap`` event.
    obs: a ``repro_torch.obs.Observability`` handle (None = the session
    default, OFF unless configured). Host spans and structured events
    only: the retire stays the only host wait either way.
    health: an ``obs.HealthMonitor``, evaluated at drain barriers and at
    the end; its verdicts land as ``health/*`` events, and critical ones
    go to ``adapt.advise``. The flight recorder (``obs.recorder``) notes
    every retired unit and dumps on a watchdog fire and on any exception.
    A guarded step's nonfinite flags are read at retire: each trip is a
    critical ``health/nonfinite`` event, and the recovery config's
    ``max_consecutive_nonfinite`` consecutive trips raise
    :class:`NonFiniteEscalation` into the restore path.
    recovery: a ``runtime.faults.RecoveryConfig`` (or a prebuilt
    ``RetrySupervisor``): each failure is classified, charged against its
    class's budget and delayed by the jittered backoff before the
    restore; a spent budget raises ``RetryBudgetExhausted`` after the
    blackbox dump. None keeps the unbounded restore.
    injector: a ``runtime.faults.FaultInjector``; the step must then be
    built with ``inject=True`` (see the module).
    Returns (final state, log)."""
    if cfg.depth < 1 or cfg.prefetch < 1 or cfg.steps_per_unit < 1:
        raise ValueError(f"DriverConfig fields must be >= 1: {cfg}")
    obs = _resolve_obs(obs)
    rec = getattr(obs, "recorder", None)
    reg = obs.metrics if obs.metrics_on else None
    if log is None:
        log = DriverLog(registry=reg)
    supervisor = None
    if recovery is not None:
        supervisor = (recovery if isinstance(recovery, RetrySupervisor)
                      else RetrySupervisor(recovery, registry=reg))
    rcfg = supervisor.cfg if supervisor is not None else RecoveryConfig()
    max_trips = rcfg.max_consecutive_nonfinite
    if injector is not None:
        injector.bind(registry=reg)
        batch_fn = injector.wrap_batch_fn(batch_fn)
    k_unit = cfg.steps_per_unit
    prefetcher = _Prefetcher(batch_fn, cfg.prefetch, k_unit)
    prefetcher.start(start_step, num_steps)
    # (first_step, n_steps, host values, telemetry names, guarded, event)
    window: deque = deque()
    readback_stream: Optional[torch.cuda.Stream] = None
    step = start_step
    last_retire_t = time.perf_counter()
    consec_nonfinite = 0

    def retire_one():
        nonlocal last_retire_t, consec_nonfinite
        s0, k, vals, names, guarded, done = window.popleft()
        with obs.span("driver/retire", step=s0, k=k):
            _wait(done)                          # the ONLY host wait
            if injector is not None:
                # the straggler hook: its delay lands inside this retire
                # interval, so the watchdog sees a slow step
                med0 = (median(log.step_times[-STRAGGLER_WINDOW:])
                        if len(log.step_times) >= STRAGGLER_WARMUP else 0.0)
                injector.after_retire(s0, k, med0)
        now = time.perf_counter()
        dt_unit = now - last_retire_t
        dt = dt_unit / k
        last_retire_t = now
        metrics = _host_metrics(vals.numpy(), names, guarded)
        losses = metrics["loss"]
        n_stragglers = len(log.straggler_events)
        for i in range(k):
            record_step(log, s0 + i, dt, float(losses[i]), straggler_factor)
        if guarded:
            # each trip was a state no-op on the device; N consecutive
            # trips escalate to a rewind
            for i in range(k):
                if metrics["nonfinite"][i] > 0.5:
                    consec_nonfinite += 1
                    if reg is not None:
                        reg.counter("guard/nonfinite_trips").inc()
                    obs.event("health/nonfinite", severity="critical",
                              subject="grads", step=s0 + i,
                              consecutive=consec_nonfinite,
                              message="non-finite grads: apply skipped, "
                                      "EF/opt state preserved")
                    if rec is not None:
                        rec.note("guard/nonfinite", step=s0 + i,
                                 consecutive=consec_nonfinite)
                    if consec_nonfinite >= max_trips:
                        raise NonFiniteEscalation(
                            f"{consec_nonfinite} consecutive non-finite "
                            f"steps ending at step {s0 + i}")
                else:
                    consec_nonfinite = 0
        if reg is not None:
            reg.histogram("driver/retire_wall_s").observe(dt_unit)
        if rec is not None:
            rec.note("driver/retire", step=s0, k=k, dt_unit_s=dt_unit,
                     loss=float(losses[-1]))
            if len(log.straggler_events) > n_stragglers:
                rec._safe_dump("watchdog")
        if adapt is not None:
            adapt.observe(s0, k, metrics)

    def health_check():
        """Drain-barrier health evaluation (host reads of the registry);
        critical findings go to the adaptive controller as its advisory."""
        if health is None:
            return
        events = health.evaluate()
        if events and adapt is not None and hasattr(adapt, "advise"):
            adapt.advise(events)

    def drain():
        if window:
            with obs.span("driver/drain", inflight=len(window)):
                while window:
                    retire_one()
        step_fn.drain()
        health_check()

    def check_swap():
        """Install an accepted replan: drain every in-flight unit, then
        swap the step. Called wherever retires may have fed the
        controller, so the plan a checkpoint records is one installed."""
        nonlocal step_fn
        if adapt is None:
            return
        swap = adapt.maybe_swap()
        if swap is None:
            return
        drain()
        step_fn, new_plan = swap
        log.plan_swaps.append((step, new_plan.signature()))
        obs.event("driver/plan_swap", step=step,
                  signature=new_plan.signature(),
                  version=getattr(new_plan, "version", None))

    def dispatch(state, step):
        nonlocal readback_stream
        k = min(k_unit, num_steps - step)
        if injector is not None:
            # collective raise / SIGTERM: before the step is called, so no
            # state is half-consumed and a restore replays the unit
            injector.before_dispatch(step, k)
        with obs.span("driver/dispatch", step=step, k=k):
            take = lambda s: prefetcher.take(s, cfg.prefetch_timeout_s)
            rand = (lambda s: None) if rand_fn_for_step is None \
                else rand_fn_for_step
            if k_unit == 1:
                new_state, metrics = step_fn(state, take(step), rand(step))
            else:
                host = [take(step + i) for i in range(k)]
                batches = {key: np.stack([h[key] for h in host])
                           for key in host[0]}
                rand_fns = (None if rand_fn_for_step is None
                            else [rand(step + i) for i in range(k)])
                new_state, metrics = step_fn(state, batches, rand_fns)
            if metrics["loss"].is_cuda and readback_stream is None:
                readback_stream = torch.cuda.Stream(metrics["loss"].device)
            vals, names, done = _readback(metrics, step_fn, readback_stream)
            window.append((step, k, vals, names, "nonfinite" in metrics,
                           done))
        return new_state, step + k

    try:
        while step < num_steps or window:
            try:
                if step >= num_steps:
                    retire_one()
                    check_swap()
                    continue
                prev = step
                state, step = dispatch(state, step)
                while len(window) >= cfg.depth:  # at most `depth` in flight
                    retire_one()
                check_swap()
                if (ckpt_every and ckpt_fn is not None and step < num_steps
                        and step // ckpt_every > prev // ckpt_every):
                    # a unit crossed a checkpoint boundary: drain so the
                    # save reads a fully retired state (and install a
                    # replan the drain accepted before the save records
                    # the active plan)
                    drain()
                    check_swap()
                    with obs.span("driver/checkpoint", step=step):
                        ckpt_fn(state)
            except Exception as e:
                if rec is not None:
                    # the ring still holds the pre-failure steps
                    if isinstance(e, PrefetchStalled) and e.cause is not None:
                        rec.note("driver/prefetch_error",
                                 error=type(e.cause).__name__,
                                 message=str(e.cause))
                    rec._safe_dump(f"exception:{type(e).__name__}")
                if restore_fn is None:
                    raise
                if supervisor is not None:
                    # classify, charge the class's budget (a spent one
                    # raises RetryBudgetExhausted: the clean abort, after
                    # the blackbox above), wait out the backoff
                    time.sleep(supervisor.on_failure(e, step))
                window.clear()
                # no kernel of the failed window may still read buffers
                # the restored state reuses
                step_fn.drain()
                consec_nonfinite = 0
                log.restarts += 1
                obs.event("driver/restart", step=step,
                          error=type(e).__name__)
                if injector is not None:
                    # fault vectors made for never-dispatched steps died
                    # with the prefetch queue: refund them, so the replay
                    # injects them for real (``step`` is the frontier)
                    injector.refund_undispatched(step)
                state = restore_fn()
                step = int(state.step)
                prefetcher.start(step, num_steps)
                last_retire_t = time.perf_counter()
        step_fn.drain()
        health_check()                  # end-of-run verdicts
    finally:
        prefetcher.stop()
    return state, log
