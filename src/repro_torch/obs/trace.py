"""Structured span tracer with Chrome-trace export (DESIGN.md §10).

One clock, Unix time in microseconds (``time.time_ns``), one append-only
event list, Chrome Trace Event JSON out — the file loads directly in
``chrome://tracing`` / Perfetto. Two event kinds:

  span(name)       a host-side complete event ("ph": "X"), recorded by a
                   context manager; spans opened on the same thread nest
                   by construction (enter/exit is LIFO per thread), so
                   the exported tree is always well-formed
  instant(name)    a zero-duration marker ("ph": "i") — plan swaps,
                   forced switches, checkpoint boundaries, allocator
                   retries

Two sinks: whenever a ``torch.profiler`` session is recording, a span
also enters a ``torch.profiler.record_function`` range of its name, and
an instant a zero-length one, enabled tracer or not. The profiler then
stamps them itself, on the clock it lays the device's kernels on; the
tracer's own Unix-time stamps line up with a profiler's Chrome export of
the same process.

The tracer NEVER touches the device: no synchronisation, no tensor
reads. Everything it records is host wall time, so tracing adds no sync
points — the pipelined driver's retire remains the only one (the
invariant tests/test_torch_obs.py pins). A disabled tracer with no
profiler recording returns a shared null context manager from
:func:`Tracer.span`; the hot-path cost of tracing-off is one attribute
check and one check of the profiler's state.

The JAX package's ``repro.obs.trace`` uses no JAX; the port keeps
this copy of it so that it imports nothing of that package.
"""
from __future__ import annotations

import json
import os
import threading
import time

import torch

# whether a torch.profiler session records on this thread (a C call)
_profiling = torch._C._autograd._profiler_enabled


class _NullSpan:
    """Shared no-op context manager (tracer disabled)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One open host span; records a complete ("X") event on exit, inside
    the profiler's range of the same name when a profiler records."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        tr = self._tracer
        tr._append({
            "name": self._name, "cat": self._cat, "ph": "X",
            "ts": self._t0 / 1e3, "dur": (t1 - self._t0) / 1e3,
            "pid": tr.pid, "tid": threading.get_ident(),
            **({"args": self._args} if self._args else {}),
        })
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Tracer:
    """Append-only Chrome-trace event recorder.

    ``enabled=False`` builds a permanently-off tracer (``NULL_TRACER`` is
    the shared instance): it records no event of its own, and ``span``
    returns the shared null context manager unless a profiler records
    (then the profiler's range alone).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: list[dict] = []
        self.pid = os.getpid()
        self._lock = threading.Lock()

    # -- clock -------------------------------------------------------------
    @staticmethod
    def now_us() -> float:
        """Current timestamp: Unix time in microseconds."""
        return time.time_ns() / 1e3

    # -- recording ---------------------------------------------------------
    def _append(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    def span(self, name: str, /, cat: str = "host", **args):
        """Context manager recording one host span (and the profiler's
        range of ``name`` while a profiler records)."""
        if self.enabled:
            return _Span(self, name, cat, args)
        if _profiling():
            return torch.profiler.record_function(name)
        return _NULL_SPAN

    def instant(self, name: str, /, cat: str = "host", **args) -> None:
        """A zero-duration marker (and a zero-length profiler range of
        ``name`` while a profiler records)."""
        if _profiling():
            with torch.profiler.record_function(name):
                pass
        if not self.enabled:
            return
        self._append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self.now_us(), "pid": self.pid,
            "tid": threading.get_ident(),
            **({"args": args} if args else {}),
        })

    def counter(self, name: str, **series) -> None:
        """Chrome counter event ("C"): a stacked timeline in the viewer."""
        if not self.enabled:
            return
        self._append({
            "name": name, "cat": "metric", "ph": "C",
            "ts": self.now_us(), "pid": self.pid, "tid": 0,
            "args": {k: float(v) for k, v in series.items()},
        })

    # -- export ------------------------------------------------------------
    def export(self, path: str, meta: dict | None = None) -> str:
        """Write Chrome Trace Event JSON; returns the path."""
        with self._lock:
            events = list(self.events)
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": dict(meta or {}),
        }
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def clear(self) -> None:
        with self._lock:
            self.events = []


NULL_TRACER = Tracer(enabled=False)


def validate_span_tree(events: list[dict], tol_us: float = 1.0) -> list[str]:
    """Check that complete events nest properly per (pid, tid): no span
    partially overlaps another on its own track. Returns a list of
    violation descriptions (empty = well-formed). Used by tests and by
    ``benchmarks/run.py --trace`` as a cheap artifact sanity check."""
    by_track: dict = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        by_track.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    bad = []
    for track, evs in by_track.items():
        evs = sorted(evs, key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: list[dict] = []
        for ev in evs:
            t0, t1 = ev["ts"], ev["ts"] + ev.get("dur", 0.0)
            while stack and t0 >= stack[-1]["ts"] + stack[-1]["dur"] - tol_us:
                stack.pop()
            if stack:
                p0 = stack[-1]["ts"]
                p1 = p0 + stack[-1]["dur"]
                if t1 > p1 + tol_us or t0 < p0 - tol_us:
                    bad.append(
                        f"track {track}: span {ev['name']!r} "
                        f"[{t0:.1f},{t1:.1f}]us partially overlaps "
                        f"{stack[-1]['name']!r} [{p0:.1f},{p1:.1f}]us")
            stack.append(ev)
    return bad
