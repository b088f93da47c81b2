"""Compression-health rule engine over the metrics registry (DESIGN.md §10.5).

SparCML's correctness story is error feedback: clamped/dropped gradient
mass must land in the EF residual and drain back out on later steps
(the global-residual rule, DESIGN.md §9). Nothing enforces that it
*does* drain — a too-small k, a mis-clamped portfolio algorithm, or a
drifting density can grow the residual without bound while the loss
curve still looks plausible for a while. The mass telemetry the
executor now emits (`bucket/*/mass_coverage`, `bucket/*/ef_norm`)
makes the failure observable; this module turns it into ranked,
actionable events.

``HealthMonitor.evaluate()`` runs a fixed set of WINDOWED rules over
whatever the registry currently holds and returns severity-ranked
:class:`HealthEvent` rows (worst first, deterministic order). Each
evaluation also mirrors the events into the registry
(``health/<rule>``) so they ride the normal JSONL/report sinks. Rules:

  ef_growth        per bucket: median ‖r‖ of the most recent window vs
                   the window before it — EF residual mass should hover,
                   not grow geometrically
  coverage_floor   per bucket: recent median ‖topk‖²/‖g+r‖² below the
                   floor means most gradient mass is riding the residual
                   instead of the wire (k too small for the density)
  step_time_p99    recent p99 step wall time vs the preceding window's
                   median — pipelined-runtime regression watch
  serve_slo        p99 of ``serve/<key>_steps`` vs the SLO targets a
                   serve configuration declares
  nonfinite        guarded-step trips (``guard/nonfinite_trips``) since
                   the last evaluation — always critical; feeds the
                   controller's fault demotion (DESIGN.md §12)
  drift_flag       DriftAuditor escalation: a flagged algorithm is a
                   warn; a median measured/predicted ratio beyond
                   flag_ratio² is critical

Everything is host-side reads of already-recorded host scalars: no
device work, no sync points. The driver evaluates at drain barriers and
end-of-run; the serve engine at end-of-run; ``repro_torch.obs.report`` renders
the recorded events as the health timeline.

The advisory side (:meth:`HealthMonitor.advisory`) compresses the event
list into the one decision the AdaptiveController can act on at a drain
barrier: which buckets are critically unhealthy. The controller treats
that as an urgency signal (patience bypass on its next accepted
proposal) — advisory, never a forced plan change.

The JAX package's ``repro.obs.health`` uses no JAX; the port keeps
this copy of it so that it imports nothing of that package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

SEVERITIES = ("critical", "warn", "info")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclass(frozen=True)
class HealthConfig:
    """Thresholds of the rule engine. ``window`` is the sample count of
    the "recent" window each rule compares against its predecessor;
    rules stay silent until ``min_samples`` fill both sides (no verdicts
    from noise). ``critical_factor`` scales any warn threshold up to its
    critical escalation."""

    window: int = 32
    min_samples: int = 8
    ef_growth_ratio: float = 2.0     # recent/baseline median ‖r‖
    coverage_floor: float = 0.5      # recent median mass coverage
    step_p99_factor: float = 2.0     # recent p99 / baseline median wall
    critical_factor: float = 2.0
    step_time_series: str = "train/step_time_s"


@dataclass(frozen=True)
class HealthEvent:
    """One rule verdict. ``subject`` is the bucket/algorithm/SLO key the
    rule fired on; ``value``/``threshold`` are the measured quantity and
    the bound it crossed (units depend on the rule)."""

    severity: str
    rule: str
    subject: str
    message: str
    value: float
    threshold: float

    def sort_key(self):
        return (_SEV_RANK[self.severity], self.rule, self.subject)


def rank_events(events) -> list[HealthEvent]:
    """Deterministic severity-ranked order: critical first, then warn,
    then info; ties broken by (rule, subject) so identical registries
    always produce the identical list."""
    return sorted(events, key=HealthEvent.sort_key)


def _split_windows(values, window: int, min_samples: int):
    """(baseline, recent) tail split, or None while underfilled. Recent
    is the last ``window`` samples; baseline the ``window`` before them
    (shorter histories split in half so early steps still get a
    verdict once 2*min_samples exist)."""
    n = len(values)
    if n < 2 * min_samples:
        return None
    w = min(window, n // 2)
    return values[-2 * w:-w], values[-w:]


class HealthMonitor:
    """Windowed rules over a :class:`repro_torch.obs.metrics.MetricsRegistry`.

    ``serve_slo`` maps latency keys ("ttft", "tpot", ...) to targets in
    decode-step units — pass ``ServeConfig.slo_targets()``. ``audit`` is
    an optional DriftAuditor. All inputs are read-only; evaluation is
    pure over the registry state plus the monitor's own event history.
    """

    def __init__(self, registry, cfg: HealthConfig = HealthConfig(), *,
                 serve_slo: Optional[dict] = None, audit=None):
        self.registry = registry
        self.cfg = cfg
        self.serve_slo = dict(serve_slo or {})
        self.audit = audit
        self.history: list[HealthEvent] = []
        self._nonfinite_seen = 0

    # -- rule helpers ------------------------------------------------------
    def _bucket_histograms(self, suffix: str):
        pre, post = "bucket/", "/" + suffix
        for name in sorted(self.registry.metrics):
            if name.startswith(pre) and name.endswith(post):
                m = self.registry.metrics[name]
                if getattr(m, "kind", None) == "histogram" and m.values:
                    yield name[len(pre):-len(post)], m.values

    def _escalate(self, value, warn_at, *, above: bool) -> Optional[str]:
        """warn/critical/None for a threshold crossed from above or
        below (coverage is a floor, everything else a ceiling)."""
        crit = (warn_at * self.cfg.critical_factor if above
                else warn_at / self.cfg.critical_factor)
        if above:
            if value >= crit:
                return "critical"
            return "warn" if value >= warn_at else None
        if value <= crit:
            return "critical"
        return "warn" if value <= warn_at else None

    # -- rules -------------------------------------------------------------
    def _rule_ef_growth(self):
        for bucket, vals in self._bucket_histograms("ef_norm"):
            split = _split_windows(vals, self.cfg.window,
                                   self.cfg.min_samples)
            if split is None:
                continue
            base, recent = split
            m0 = float(np.median(base))
            m1 = float(np.median(recent))
            ratio = m1 / max(m0, 1e-30)
            sev = self._escalate(ratio, self.cfg.ef_growth_ratio, above=True)
            if sev:
                yield HealthEvent(
                    sev, "ef_growth", bucket,
                    f"EF residual norm grew {ratio:.2f}x over the last "
                    f"window ({m0:.3g} -> {m1:.3g}): compressed mass is "
                    "accumulating instead of draining (k too small or "
                    "clamp fold runaway)", ratio, self.cfg.ef_growth_ratio)

    def _rule_coverage_floor(self):
        for bucket, vals in self._bucket_histograms("mass_coverage"):
            if len(vals) < self.cfg.min_samples:
                continue
            recent = vals[-min(self.cfg.window, len(vals)):]
            med = float(np.median(recent))
            sev = self._escalate(med, self.cfg.coverage_floor, above=False)
            if sev:
                yield HealthEvent(
                    sev, "coverage_floor", bucket,
                    f"median compressed-mass coverage {med:.3f} under the "
                    f"{self.cfg.coverage_floor:.2f} floor: most gradient "
                    "mass rides the EF residual, not the wire",
                    med, self.cfg.coverage_floor)

    def _rule_step_time(self):
        m = self.registry.metrics.get(self.cfg.step_time_series)
        vals = list(getattr(m, "data", None) or getattr(m, "values", []) or [])
        split = _split_windows(vals, self.cfg.window, self.cfg.min_samples)
        if split is None:
            return
        base, recent = split
        baseline = float(np.median(base))
        p99 = float(np.percentile(np.asarray(recent, dtype=np.float64), 99))
        factor = p99 / max(baseline, 1e-30)
        sev = self._escalate(factor, self.cfg.step_p99_factor, above=True)
        if sev:
            yield HealthEvent(
                sev, "step_time_p99", self.cfg.step_time_series,
                f"recent p99 step time {p99 * 1e3:.3g} ms is {factor:.2f}x "
                f"the preceding window's median ({baseline * 1e3:.3g} ms)",
                factor, self.cfg.step_p99_factor)

    def _rule_serve_slo(self):
        for key in sorted(self.serve_slo):
            target = float(self.serve_slo[key])
            m = self.registry.metrics.get(f"serve/{key}_steps")
            vals = getattr(m, "values", None)
            if not vals:
                continue
            p99 = float(np.percentile(np.asarray(vals, np.float64), 99))
            sev = self._escalate(p99, target, above=True)
            if sev:
                yield HealthEvent(
                    sev, "serve_slo", key,
                    f"serve {key} p99 of {p99:.3g} decode steps misses the "
                    f"{target:.3g}-step SLO target", p99, target)

    def _rule_nonfinite(self):
        """Guard trips since the last evaluation (DESIGN.md §12.2). The
        guarded step already skipped the apply and preserved EF/optimizer
        state; this verdict is the drain-barrier signal the
        AdaptiveController keys its fault demotion on."""
        m = self.registry.metrics.get("guard/nonfinite_trips")
        total = int(getattr(m, "value", 0) or 0)
        new = total - self._nonfinite_seen
        self._nonfinite_seen = total
        if new <= 0:
            return
        yield HealthEvent(
            "critical", "nonfinite", "grads",
            f"{new} guarded step(s) tripped on non-finite gradients since "
            f"the last evaluation ({total} total): apply skipped, EF "
            "residuals and optimizer state preserved", float(new), 0.0)

    def _rule_drift_flag(self):
        if self.audit is None or not len(self.audit):
            return
        fr = self.audit.flag_ratio
        for alg, st in self.audit.per_algorithm().items():
            if not st["flagged"]:
                continue
            med = st["median_ratio"]
            # escalation: a flag is a warn; a ratio beyond flag_ratio²
            # means the cost model is off by more than one whole trust
            # band in either direction — critical.
            beyond = med >= fr * fr or med <= 1.0 / (fr * fr)
            yield HealthEvent(
                "critical" if beyond else "warn", "drift_flag", alg,
                f"cost-model drift: median measured/predicted ratio "
                f"{med:.3g} outside [{1.0 / fr:.2g}, {fr:.2g}]", med, fr)

    # -- engine ------------------------------------------------------------
    def evaluate(self) -> list[HealthEvent]:
        """Run every rule once; return the ranked verdicts and mirror
        them into the registry as ``health/<rule>`` events."""
        events: list[HealthEvent] = []
        for rule in (self._rule_ef_growth, self._rule_coverage_floor,
                     self._rule_step_time, self._rule_serve_slo,
                     self._rule_nonfinite, self._rule_drift_flag):
            events.extend(rule() or ())
        ranked = rank_events(events)
        for ev in ranked:
            self.registry.event(f"health/{ev.rule}", severity=ev.severity,
                                subject=ev.subject, value=ev.value,
                                threshold=ev.threshold, message=ev.message)
        self.history.extend(ranked)
        return ranked

    def advisory(self, events: Optional[list] = None) -> dict:
        """Compress verdicts into the drain-barrier advisory the
        AdaptiveController consumes: the critically-unhealthy buckets
        and the worst severity seen. Uses the latest evaluation when
        ``events`` is omitted (empty advisory before the first one)."""
        evs = self.history if events is None else events
        buckets = sorted({e.subject for e in evs
                          if e.severity == "critical"
                          and e.rule in ("ef_growth", "coverage_floor")})
        worst = min((e.severity for e in evs), default=None,
                    key=lambda s: _SEV_RANK[s])
        return {"critical_buckets": buckets, "worst": worst,
                "n_events": len(evs)}

    def summary(self) -> str:
        """Aligned terminal table of the accumulated verdicts."""
        if not self.history:
            return "  health: no findings"
        lines = []
        for ev in rank_events(self.history):
            lines.append(f"  [{ev.severity:<8}] {ev.rule:<15} "
                         f"{ev.subject:<24} {ev.message}")
        return "\n".join(lines)
