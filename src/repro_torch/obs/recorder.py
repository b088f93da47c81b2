"""Bounded flight recorder: crash diagnostics for driver and serve runs.

A long pipelined run that dies — an exception deep in a step,
a watchdog straggler storm, a SIGTERM from the cluster scheduler —
historically left nothing behind: the trace and metrics JSONL are only
written by the end-of-run export. The :class:`FlightRecorder` is the
aviation-style answer (DESIGN.md §10.6): a fixed-capacity ring of the
most recent activity that can be dumped ATOMICALLY to ``blackbox.json``
at any moment, from any exit path.

What a dump contains (everything bounded by ``capacity``):

  notes        the recorder's own ring — one entry per retired driver
               unit / serve decode step (step index, loss/occupancy,
               wall time), appended by the runtime host loops
  trace_tail   the last N Chrome-trace events from the attached tracer
  event_tail   the last N structured events from the metrics registry
  series_tail  the last N samples of every Series metric
  metrics      full counter/gauge values + histogram snapshots (these
               are already O(1)-ish summaries)

Dump triggers, wired by the runtime driver and serve engine:

  exception    ``run_pipelined``/``ContinuousServeEngine.run`` dump
               before re-raising (and before a restore_fn restart)
  watchdog     the driver's straggler watchdog fires
  signal       ``install_signal_handlers`` (opt-in, main thread only)
               dumps on SIGTERM/SIGINT-style signals, then chains to
               the previous handler

The write is tmp-file + fsync + ``os.replace``: a reader either sees a
complete parseable JSON document or the previous one — never a torn
file. Dumping is idempotent and cheap (host-side snapshots only), so
repeated triggers just refresh the same path.

The JAX package's ``repro.obs.recorder`` uses no JAX; the port keeps
this copy of it so that it imports nothing of that package.
"""
from __future__ import annotations

import json
import os
import signal as _signal
import threading
import time
from collections import deque
from typing import Optional

from repro_torch.obs.metrics import _jsonable


class FlightRecorder:
    """Ring buffer + atomic ``blackbox.json`` dumper.

    ``obs`` is the :class:`repro_torch.obs.Observability` handle whose tracer
    and registry get snapshotted into each dump; the recorder works
    (notes ring only) with the OFF handle too. Thread-safe: the driver's
    retire closure and a signal handler may race a dump. ``deaths_only``
    (a rank other than 0 of a process group, whose rank 0 records the
    run) skips the dumps of recovered exceptions and the watchdog: only a
    signal or a ``death:`` dump (the process's own end) writes."""

    def __init__(self, path: str = "blackbox.json", capacity: int = 256,
                 obs=None):
        from repro_torch.obs import resolve

        self.path = str(path)
        self.deaths_only = False
        self.capacity = max(1, int(capacity))
        self.obs = resolve(obs)
        self.notes: deque = deque(maxlen=self.capacity)
        self.dumps = 0
        self.last_reason: Optional[str] = None
        self._born = time.time()
        self._lock = threading.Lock()
        self._prev_handlers: dict = {}

    # -- ring --------------------------------------------------------------
    def note(self, kind: str, /, **fields) -> None:
        """Append one bounded ring entry (host scalars only — callers
        pass floats/ints they already hold; never a device value)."""
        self.notes.append({
            "kind": kind, "t": time.time() - self._born,
            **{k: _jsonable(v) for k, v in fields.items()},
        })

    # -- snapshot + dump ---------------------------------------------------
    def snapshot(self, reason: str) -> dict:
        cap = self.capacity
        reg = self.obs.metrics
        metrics: dict = {}
        series_tail: dict = {}
        for name in sorted(reg.metrics):
            m = reg.metrics[name]
            if m.kind == "series":
                series_tail[name] = _jsonable(m.data[-cap:])
            else:
                metrics[name] = {"kind": m.kind, **_jsonable(m.snapshot())}
        return {
            "kind": "blackbox",
            "reason": reason,
            "wall_time": time.time(),
            "uptime_s": time.time() - self._born,
            "pid": os.getpid(),
            "capacity": cap,
            "notes": list(self.notes),
            "trace_tail": _jsonable(self.obs.tracer.events[-cap:])
            if self.obs.trace_on else [],
            "event_tail": _jsonable(reg.events[-cap:]),
            "series_tail": series_tail,
            "metrics": metrics,
        }

    def dump(self, reason: str) -> str:
        """Atomically (re)write ``blackbox.json``. Never raises from a
        teardown path the caller can't handle — IO failures surface as
        the returned path vs a raised error only outside handlers."""
        with self._lock:
            doc = self.snapshot(reason)
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            tmp = os.path.join(
                d, f".{os.path.basename(self.path)}.tmp.{os.getpid()}")
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self.dumps += 1
            self.last_reason = reason
            return self.path

    def _safe_dump(self, reason: str) -> Optional[str]:
        if self.deaths_only and not reason.startswith(("signal:", "death:")):
            return None
        try:
            return self.dump(reason)
        except Exception:
            return None

    # -- signal trigger ----------------------------------------------------
    def install_signal_handlers(self, signals=("SIGTERM",)) -> list:
        """Dump on delivery of each named signal, then chain to the
        previously-installed handler (or re-raise the default action for
        terminating signals so exit codes stay honest). Main thread
        only — Python restricts ``signal.signal`` to it; callers off the
        main thread get an empty install instead of a crash."""
        installed = []
        if threading.current_thread() is not threading.main_thread():
            return installed
        for name in signals:
            signum = getattr(_signal, name, None)
            if signum is None:
                continue

            def _handler(num, frame, _name=name):
                self._safe_dump(f"signal:{_name}")
                prev = self._prev_handlers.get(num)
                if callable(prev):
                    prev(num, frame)
                elif prev == _signal.SIG_DFL:
                    _signal.signal(num, _signal.SIG_DFL)
                    _signal.raise_signal(num)

            self._prev_handlers[signum] = _signal.getsignal(signum)
            _signal.signal(signum, _handler)
            installed.append(name)
        return installed

    def uninstall_signal_handlers(self) -> None:
        for signum, prev in self._prev_handlers.items():
            try:
                _signal.signal(signum, prev)
            except (ValueError, TypeError):
                pass
        self._prev_handlers = {}
