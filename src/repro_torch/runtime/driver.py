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

Observability, adaptive re-planning, health rules, the retry supervisor
and the chaos injector are not ported yet: passing one raises.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from statistics import median
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.runtime.faults import (NonFiniteEscalation, PrefetchStalled,
                                        RecoveryConfig)

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


@dataclass
class DriverLog:
    """Run log shared by ``Trainer.run`` and the driver."""

    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)        # seconds
    straggler_events: list = field(default_factory=list)  # (step, dt, median)
    restarts: int = 0


def record_step(log: DriverLog, step: int, dt: float, loss: float,
                straggler_factor: float) -> None:
    """Append one step's loss and wall time and run the straggler
    watchdog: a step slower than ``straggler_factor`` times the rolling
    median of the last ``STRAGGLER_WINDOW`` step times records a
    ``(step, dt, median)`` event. The one logging policy of both loops."""
    log.losses.append(loss)
    log.step_times.append(dt)
    if len(log.step_times) >= STRAGGLER_WARMUP:
        med = median(log.step_times[-STRAGGLER_WINDOW:])
        if dt > straggler_factor * med:
            log.straggler_events.append((step, dt, med))


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


def _readback(metrics) -> tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Start the one host copy of a unit: its losses and, for a guarded
    step, its nonfinite flags, stacked (1 or 2, k). On CUDA the copy goes
    to pinned memory without blocking and the returned event marks its
    end; on the CPU the values are there already."""
    rows = [metrics["loss"].reshape(-1)]
    if "nonfinite" in metrics:
        rows.append(metrics["nonfinite"].reshape(-1))
    vals = torch.stack(rows).to(torch.float32)
    if not vals.is_cuda:
        return vals, None
    host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
    host.copy_(vals, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _refuse_unported(**options) -> None:
    items = {"adapt": 9, "obs": 13, "phase_attr": 13, "health": 13,
             "recovery": 13, "injector": 13}
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(
                f"run_pipelined({name}=...) is not ported (ROADMAP Queue 1 "
                f"item {items[name]})")


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
    phase_attr=None,
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
    A guarded step's nonfinite flags are read at retire;
    ``RecoveryConfig().max_consecutive_nonfinite`` consecutive trips
    raise :class:`NonFiniteEscalation` into the restore path.
    Returns (final state, log)."""
    _refuse_unported(adapt=adapt, obs=obs, phase_attr=phase_attr,
                     health=health, recovery=recovery, injector=injector)
    if cfg.depth < 1 or cfg.prefetch < 1 or cfg.steps_per_unit < 1:
        raise ValueError(f"DriverConfig fields must be >= 1: {cfg}")
    if log is None:
        log = DriverLog()
    max_trips = RecoveryConfig().max_consecutive_nonfinite
    k_unit = cfg.steps_per_unit
    prefetcher = _Prefetcher(batch_fn, cfg.prefetch, k_unit)
    prefetcher.start(start_step, num_steps)
    window: deque = deque()  # (first_step, n_steps, host values, event)
    step = start_step
    last_retire_t = time.perf_counter()
    consec_nonfinite = 0

    def retire_one():
        nonlocal last_retire_t, consec_nonfinite
        s0, k, vals, done = window.popleft()
        if done is not None:
            done.synchronize()                   # the ONLY sync point
        now = time.perf_counter()
        dt = (now - last_retire_t) / k
        last_retire_t = now
        vals = vals.numpy()
        for i in range(k):
            record_step(log, s0 + i, dt, float(vals[0, i]), straggler_factor)
        if vals.shape[0] > 1:
            # guarded step: each trip was a state no-op on the device; N
            # consecutive trips escalate to a rewind
            for i in range(k):
                if vals[1, i] > 0.5:
                    consec_nonfinite += 1
                    if consec_nonfinite >= max_trips:
                        raise NonFiniteEscalation(
                            f"{consec_nonfinite} consecutive non-finite "
                            f"steps ending at step {s0 + i}")
                else:
                    consec_nonfinite = 0

    def drain():
        while window:
            retire_one()
        step_fn.drain()

    def dispatch(state, step):
        k = min(k_unit, num_steps - step)
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
        window.append((step, k, *_readback(metrics)))
        return new_state, step + k

    try:
        while step < num_steps or window:
            try:
                if step >= num_steps:
                    retire_one()
                    continue
                prev = step
                state, step = dispatch(state, step)
                while len(window) >= cfg.depth:  # at most `depth` in flight
                    retire_one()
                if (ckpt_every and ckpt_fn is not None and step < num_steps
                        and step // ckpt_every > prev // ckpt_every):
                    # a unit crossed a checkpoint boundary: drain so the
                    # save reads a fully retired state
                    drain()
                    ckpt_fn(state)
            except Exception:
                if restore_fn is None:
                    raise
                window.clear()
                consec_nonfinite = 0
                log.restarts += 1
                state = restore_fn()
                step = int(state.step)
                prefetcher.start(step, num_steps)
                last_retire_t = time.perf_counter()
        step_fn.drain()
    finally:
        prefetcher.stop()
    return state, log
