"""Non-blocking sync runtime and adaptive re-planning (the JAX package's
``repro.runtime``, DESIGN.md §6–§7), stacked-replica form:

  pipeline.py  pipelined stale-gradient steps: step t's forward/backward
               runs while the reduce half of step t-1's gradients
               completes on a side CUDA stream (staleness 1; staleness 0
               is the synchronous step exactly), and K-step supersteps;
               either over a replanned plan
  driver.py    double-buffered host driver: dispatch N units deep,
               background data prefetch, logging and checkpoints that
               wait only on retired steps, observability hooks, and plan
               swaps at drain barriers
  adapt.py     closed-loop re-planning: windowed measured-density
               telemetry + calibrated alpha-beta cost model re-select
               each bucket's algorithm; accepted replans swap the step
               at drain barriers (hysteresis + patience damp flapping)
  faults.py    the exceptions and the recovery setting the driver uses

The chaos injector and the retry supervisor are not ported yet (ROADMAP
Queue 1 item 13).
"""
from repro_torch.runtime.adapt import (AdaptConfig, AdaptiveController,
                                       AdaptiveRuntime, TelemetryObserver,
                                       TelemetryWindow)
from repro_torch.runtime.driver import (DriverConfig, DriverLog, record_step,
                                        run_pipelined)
from repro_torch.runtime.faults import (FaultError, NonFiniteEscalation,
                                        PrefetchStalled, RecoveryConfig)
from repro_torch.runtime.pipeline import (VALID_KEY, attach_inflight,
                                          build_pipelined_step,
                                          build_superstep, resolve_lowering)

__all__ = [
    "AdaptConfig",
    "AdaptiveController",
    "AdaptiveRuntime",
    "DriverConfig",
    "DriverLog",
    "FaultError",
    "NonFiniteEscalation",
    "PrefetchStalled",
    "RecoveryConfig",
    "TelemetryObserver",
    "TelemetryWindow",
    "VALID_KEY",
    "attach_inflight",
    "build_pipelined_step",
    "build_superstep",
    "record_step",
    "resolve_lowering",
    "run_pipelined",
]
