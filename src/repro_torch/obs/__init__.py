"""repro_torch.obs — unified observability: tracing, metrics, drift audit,
health rules, flight recorder (the JAX package's ``repro.obs``).

One facade object (:class:`Observability`) bundles the concerns so
every layer threads a single handle:

    obs = configure(trace=True, metrics=True, recorder="blackbox.json")
    with obs.span("driver/dispatch", step=i): ...
    obs.event("adapt/replan_accepted", signature=sig)
    obs.export(trace_path="trace.json", metrics_path="metrics.jsonl")

The second tier (DESIGN.md §10.5–§10.7) layers on the same registry:
:class:`~repro_torch.obs.health.HealthMonitor` runs windowed compression-
health rules over it, :class:`~repro_torch.obs.recorder.FlightRecorder`
(``obs.recorder``) dumps a bounded ring to ``blackbox.json`` on
crashes, and ``python -m repro_torch.obs.report`` renders the exported
artifacts into a terminal summary.

The module-level default is OFF (``obs.OFF``): every span is a shared
no-op context manager, every event a single attribute check — the
pipelined driver's retire stays the only sync point and the hot path is
unchanged (tests/test_torch_obs.py pins both). While a ``torch.profiler``
session records, spans and instants enter the profiler's ranges of
their names whether the tracer is on or off (``obs/trace.py``). ``resolve`` maps the ubiquitous
``obs=None`` parameter onto the current default so call sites stay
one-liners.
"""
from __future__ import annotations

from repro_torch.obs.audit import (
    DriftAuditor,
    audit_serve_plan,
    audit_sync_plan,
)
from repro_torch.obs.health import (
    HealthConfig,
    HealthEvent,
    HealthMonitor,
    rank_events,
)
from repro_torch.obs.metrics import (
    SCHEMA_VERSION,
    JsonlSink,
    MetricsRegistry,
    record_bucket_telemetry,
)
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import NULL_TRACER, Tracer, validate_span_tree


class Observability:
    """Tracer + metrics registry + drift auditor (+ optional flight
    recorder) behind one handle."""

    def __init__(self, tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None,
                 audit: DriftAuditor | None = None,
                 recorder=None):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)
        self.audit = audit
        # FlightRecorder (repro_torch.obs.recorder) or None; runtime loops
        # check the attribute and dump on exception/watchdog/signal.
        self.recorder = recorder

    @property
    def trace_on(self) -> bool:
        return self.tracer.enabled

    @property
    def metrics_on(self) -> bool:
        return self.metrics.enabled

    @property
    def enabled(self) -> bool:
        return self.trace_on or self.metrics_on

    # -- delegation shorthands --------------------------------------------
    def span(self, name: str, /, cat: str = "host", **args):
        return self.tracer.span(name, cat, **args)

    def instant(self, name: str, /, cat: str = "host", **args) -> None:
        self.tracer.instant(name, cat, **args)

    def event(self, name: str, /, **fields) -> None:
        """A structured event lands in BOTH sinks: the metrics event log
        and (as an instant marker) the trace timeline. ``name`` is
        positional-only so fields may themselves be named ``name``."""
        self.metrics.event(name, **fields)
        self.tracer.instant(name, cat="event")

    def export(self, trace_path: str | None = None,
               metrics_path: str | None = None,
               meta: dict | None = None) -> dict:
        """Flush whichever sinks have destinations; returns written paths.
        The audit report (when an auditor is attached) rides the metrics
        JSONL as ``audit/*`` events, emitted here."""
        out = {}
        if (self.audit is not None and len(self.audit) and self.metrics_on
                and not self.metrics.events_named("audit/algorithm_residual")):
            # the audit probes emit() themselves when handed the registry;
            # don't double the residual events here
            self.audit.emit(self.metrics)
        if trace_path and self.trace_on:
            out["trace"] = self.tracer.export(trace_path, meta=meta)
        if metrics_path and self.metrics_on:
            out["metrics"] = self.metrics.dump_jsonl(metrics_path, meta=meta)
        return out


OFF = Observability()

_default = OFF


def configure(trace: bool = False, metrics: bool = False,
              audit: bool = False, *, set_as_default: bool = True,
              flag_ratio: float = 3.0,
              recorder: str | bool = False,
              recorder_capacity: int = 256) -> Observability:
    """Build (and by default install) an Observability handle.

    ``recorder`` attaches a :class:`~repro_torch.obs.recorder.FlightRecorder`:
    pass a path for its ``blackbox.json`` (or ``True`` for the default
    name in the CWD). The runtime driver and serve engine dump it on
    exception and watchdog fire; call
    ``obs.recorder.install_signal_handlers()`` from the main thread to
    add the signal trigger."""
    ob = Observability(
        tracer=Tracer(enabled=True) if trace else NULL_TRACER,
        metrics=MetricsRegistry(enabled=metrics),
        audit=DriftAuditor(flag_ratio=flag_ratio) if audit else None,
    )
    if recorder:
        path = recorder if isinstance(recorder, str) else "blackbox.json"
        ob.recorder = FlightRecorder(path, capacity=recorder_capacity,
                                     obs=ob)
    if set_as_default:
        set_default(ob)
    return ob


def get_default() -> Observability:
    return _default


def set_default(ob: Observability) -> None:
    global _default
    _default = ob


def resolve(ob: Observability | None) -> Observability:
    """Map the ``obs=None`` call-site convention onto the default."""
    return ob if ob is not None else _default


__all__ = [
    "SCHEMA_VERSION",
    "DriftAuditor",
    "FlightRecorder",
    "HealthConfig",
    "HealthEvent",
    "HealthMonitor",
    "JsonlSink",
    "MetricsRegistry",
    "NULL_TRACER",
    "Observability",
    "OFF",
    "Tracer",
    "audit_serve_plan",
    "audit_sync_plan",
    "configure",
    "get_default",
    "rank_events",
    "record_bucket_telemetry",
    "resolve",
    "set_default",
    "validate_span_tree",
]
