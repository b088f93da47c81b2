"""Metrics registry: counters, gauges, histograms, series + sinks.

Single process-wide registry shape (DESIGN.md §10):

  Counter    monotonically increasing int (plan swaps, stragglers,
             restarts, clamp-fold drops)
  Gauge      last-written float (current density, straggler median)
  Histogram  full sample list with count/sum/mean/min/max/percentiles
             (per-bucket nnz and wire bytes, serve TTFT/TPOT, step wall)
  Series     append-only typed list whose ``.data`` IS a plain python
             list — DriverLog's public fields (losses, step_times, ...)
             are views of Series data, so PR-2 consumers keep indexing
             real lists while the registry owns storage
  Event      a timestamped dict (controller decisions with the
             densities/costs that justified them, audit residuals)

Two sinks: ``dump_jsonl`` (header line with ``schema_version`` + run
metadata, then one line per metric and per event) and ``summary()``
(aligned terminal table). No dependencies beyond numpy; everything is
host-side only — recording a metric never touches a device value that
isn't already a host scalar.

The JAX package's ``repro.obs.metrics`` uses no JAX; the port keeps
this copy of it so that it imports nothing of that package.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

SCHEMA_VERSION = 2


def _jsonable(v):
    """Best-effort conversion of numpy and torch scalars and containers."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "item") and getattr(v, "ndim", None) in (0, None):
        try:
            return v.item()
        except Exception:
            pass
    if hasattr(v, "tolist"):
        try:
            return v.tolist()
        except Exception:
            pass
    return str(v)


class Counter:
    kind = "counter"

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += int(n)

    def snapshot(self) -> dict:
        return {"value": self.value}

    def brief(self) -> str:
        return str(self.value)


class Gauge:
    kind = "gauge"

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"value": self.value}

    def brief(self) -> str:
        return "-" if self.value is None else f"{self.value:.6g}"


class Histogram:
    """Keeps every sample (runs here are short); percentiles on demand."""

    kind = "histogram"

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: list[float] = []

    def observe(self, v) -> None:
        self.values.append(float(v))

    def observe_many(self, vs) -> None:
        self.values.extend(float(v) for v in np.asarray(vs).ravel())

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.values, q)) if self.values else float("nan")

    def snapshot(self) -> dict:
        if not self.values:
            return {"count": 0}
        a = np.asarray(self.values, dtype=np.float64)
        p50, p90, p99 = np.percentile(a, [50, 90, 99])
        return {
            "count": int(a.size), "sum": float(a.sum()),
            "mean": float(a.mean()), "min": float(a.min()),
            "max": float(a.max()), "p50": float(p50),
            "p90": float(p90), "p99": float(p99),
        }

    def brief(self) -> str:
        s = self.snapshot()
        if not s["count"]:
            return "empty"
        return (f"n={s['count']} mean={s['mean']:.4g} p50={s['p50']:.4g} "
                f"p90={s['p90']:.4g} p99={s['p99']:.4g}")


class Series:
    """Append-only list metric. ``.data`` is the underlying plain list —
    hand it out as a public field and callers index it like any list."""

    kind = "series"

    __slots__ = ("name", "data")

    def __init__(self, name: str):
        self.name = name
        self.data: list = []

    def append(self, v) -> None:
        self.data.append(v)

    def snapshot(self) -> dict:
        return {"count": len(self.data), "values": _jsonable(self.data)}

    def brief(self) -> str:
        return f"n={len(self.data)}"


class MetricsRegistry:
    """Get-or-create metric store plus a structured event log."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.metrics: dict[str, object] = {}
        self.events: list[dict] = []
        self._born = time.time()

    def _get(self, name: str, cls):
        m = self.metrics.get(name)
        if m is None:
            m = cls(name)
            self.metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def series(self, name: str) -> Series:
        return self._get(name, Series)

    def event(self, name: str, /, **fields) -> None:
        """Record a structured event (no-op when the registry is off).
        ``name`` is positional-only so fields may themselves be named
        ``name`` (e.g. a bench row's name)."""
        if not self.enabled:
            return
        self.events.append({
            "event": name, "t": time.time() - self._born,
            **{k: _jsonable(v) for k, v in fields.items()},
        })

    def events_named(self, name: str) -> list[dict]:
        return [e for e in self.events if e["event"] == name]

    # -- sinks -------------------------------------------------------------
    def dump_jsonl(self, path: str, meta: dict | None = None) -> str:
        """JSONL sink: header line, then one line per metric, then one per
        event. The header carries ``schema_version`` and run metadata so
        files are joinable across PRs. The write is atomic (tmp file +
        flush + fsync + rename) so an abnormal exit mid-dump can never
        leave a truncated file — readers see the previous complete dump
        or the new one, nothing in between."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(json.dumps({
                "kind": "header", "schema_version": SCHEMA_VERSION,
                "meta": _jsonable(meta or {}),
            }) + "\n")
            for name in sorted(self.metrics):
                m = self.metrics[name]
                f.write(json.dumps({
                    "kind": m.kind, "name": name, **_jsonable(m.snapshot()),
                }) + "\n")
            for ev in self.events:
                f.write(json.dumps({"kind": "event", **ev}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def jsonl_sink(self, path: str, meta: dict | None = None) -> "JsonlSink":
        """Open a context-managed JSONL sink bound to this registry: a
        handle that re-dumps the registry on ``flush()``, on context
        exit (including exceptions), and — as a last resort — at
        interpreter exit via ``atexit``, so a run killed halfway still
        leaves a valid, parseable JSONL behind instead of nothing."""
        return JsonlSink(self, path, meta)

    def summary(self) -> str:
        """Aligned terminal table of every metric plus event counts."""
        lines = []
        if self.metrics:
            w = max(len(n) for n in self.metrics)
            for name in sorted(self.metrics):
                m = self.metrics[name]
                lines.append(f"  {name:<{w}}  {m.kind:<9}  {m.brief()}")
        by_name: dict[str, int] = {}
        for ev in self.events:
            by_name[ev["event"]] = by_name.get(ev["event"], 0) + 1
        for name in sorted(by_name):
            lines.append(f"  {name:<{max(len(n) for n in by_name)}}  "
                         f"event     x{by_name[name]}")
        return "\n".join(lines) if lines else "  (no metrics recorded)"


class JsonlSink:
    """Crash-safe handle on a metrics JSONL file (DESIGN.md §10.2).

    ``MetricsRegistry.dump_jsonl`` alone only writes when the program
    reaches the final export call — a run that dies early leaves no
    metrics at all. The sink closes that gap: open it at run START, and
    every exit path (normal return, exception via the ``with`` block,
    SIGTERM-free interpreter shutdown via ``atexit``) re-dumps whatever
    the registry holds at that moment. Each dump is the atomic
    whole-file write of ``dump_jsonl``, so the file on disk is always a
    complete, parseable JSONL — partial runs included. ``meta`` may be
    mutated (or replaced via the attribute) before the final flush."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 meta: dict | None = None):
        import atexit

        self.registry = registry
        self.path = path
        self.meta = dict(meta or {})
        self._closed = False
        self._atexit = atexit
        atexit.register(self._atexit_flush)

    def flush(self) -> str:
        return self.registry.dump_jsonl(self.path, self.meta)

    def _atexit_flush(self) -> None:
        if not self._closed:
            try:
                self.flush()
            except Exception:
                pass  # interpreter teardown — never raise from atexit

    def close(self) -> str:
        """Final flush + atexit deregistration (idempotent)."""
        if not self._closed:
            self._closed = True
            try:
                self._atexit.unregister(self._atexit_flush)
            except Exception:
                pass
            return self.flush()
        return self.path

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


NULL_REGISTRY = MetricsRegistry(enabled=False)


def record_bucket_telemetry(registry: MetricsRegistry, telemetry: dict,
                            *, prefix: str = "bucket") -> None:
    """Fold one step's in-graph telemetry into per-bucket histograms.

    Accepts both wire widths: (k, 2) [nnz, wire] (the PR-3 format the
    serve activation exchange still emits) and (k, 4) [nnz, wire, mass
    coverage, EF-residual norm] (the training executor, DESIGN.md
    §10.5). The extra columns land in ``<prefix>/<name>/mass_coverage``
    and ``.../ef_norm`` histograms the health engine windows over."""
    if not registry.enabled:
        return
    for name, arr in telemetry.items():
        # a single step's (2,)/(4,) row is one-row 2-D
        a = np.atleast_2d(np.asarray(arr))
        if a.ndim != 2 or a.shape[-1] not in (2, 4):
            continue
        registry.histogram(f"{prefix}/{name}/nnz").observe_many(a[:, 0])
        registry.histogram(f"{prefix}/{name}/wire_bytes").observe_many(a[:, 1])
        if a.shape[-1] == 4:
            registry.histogram(
                f"{prefix}/{name}/mass_coverage").observe_many(a[:, 2])
            registry.histogram(
                f"{prefix}/{name}/ef_norm").observe_many(a[:, 3])
