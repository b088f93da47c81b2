"""Non-blocking sync runtime, adaptive re-planning and the fault-tolerant
runtime (the JAX package's ``repro.runtime``, DESIGN.md §6, §7, §12),
stacked-replica form:

  pipeline.py  pipelined stale-gradient steps: step t's forward/backward
               runs while the reduce half of step t-1's gradients
               completes on a side CUDA stream (staleness 1; staleness 0
               is the synchronous step exactly), and K-step supersteps;
               either over a replanned plan, in every optimizer layout,
               and injectable by the chaos harness
  driver.py    double-buffered host driver: dispatch N units deep,
               background data prefetch, logging and checkpoints that
               wait only on retired steps, observability hooks, plan
               swaps at drain barriers, and the retry supervisor's
               bounded restores
  adapt.py     closed-loop re-planning: windowed measured-density
               telemetry + calibrated alpha-beta cost model re-select
               each bucket's algorithm; accepted replans swap the step
               at drain barriers (hysteresis + patience damp flapping)
  faults.py    deterministic chaos injection (FaultPlan/FaultInjector),
               fault classification, and the retry/backoff supervisor
               the driver escalates through (RecoveryConfig/
               RetrySupervisor)
"""
from repro_torch.runtime.adapt import (AdaptConfig, AdaptiveController,
                                       AdaptiveRuntime, TelemetryObserver,
                                       TelemetryWindow)
from repro_torch.runtime.driver import (DriverConfig, DriverLog, record_step,
                                        run_pipelined)
from repro_torch.runtime.faults import (FAULT_CLASSES, FAULT_KEY, FaultError,
                                        FaultInjectionError, FaultInjector,
                                        FaultPlan, FaultSpec,
                                        NonFiniteEscalation, PrefetchStalled,
                                        RecoveryConfig, RetryBudgetExhausted,
                                        RetrySupervisor, classify_fault,
                                        crc32_of)
from repro_torch.runtime.pipeline import (VALID_KEY, attach_inflight,
                                          build_pipelined_step,
                                          build_superstep, resolve_lowering)

__all__ = [
    "AdaptConfig",
    "AdaptiveController",
    "AdaptiveRuntime",
    "DriverConfig",
    "DriverLog",
    "FAULT_CLASSES",
    "FAULT_KEY",
    "FaultError",
    "FaultInjectionError",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "NonFiniteEscalation",
    "PrefetchStalled",
    "RecoveryConfig",
    "RetryBudgetExhausted",
    "RetrySupervisor",
    "TelemetryObserver",
    "TelemetryWindow",
    "VALID_KEY",
    "attach_inflight",
    "build_pipelined_step",
    "build_superstep",
    "classify_fault",
    "crc32_of",
    "record_step",
    "resolve_lowering",
    "run_pipelined",
]
