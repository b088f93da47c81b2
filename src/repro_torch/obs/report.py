"""``python -m repro_torch.obs.report`` — render exported obs artifacts.

Reads the metrics JSONL a run dumped (``MetricsRegistry.dump_jsonl`` /
``JsonlSink``) plus, optionally, its Chrome trace, and prints the
terminal summary a human wants after (or instead of) opening Perfetto:

  * run header metadata
  * per-bucket density/mass spectra: nnz, wire bytes, mass coverage and
    EF-residual norm percentiles per fusion bucket (DESIGN.md §10.5)
  * the health timeline: every ``health/*`` event in time order with
    severity markers
  * the recovery timeline: injected faults, guard trips, retries,
    checkpoint fallbacks, demotions and serve sheds (DESIGN.md §12)
  * the serve SLO attainment table: declared ServeConfig targets vs the
    measured p99s (``serve/slo_targets`` event + ``serve/*_steps``
    histograms)
  * a trace digest: span-tree validation + the heaviest span names

Pure stdlib + the repro_torch.obs readers; no torch import, so it runs anywhere
the artifacts land (CI included: examples-smoke invokes it on the
train/serve artifacts it just produced).

Usage:
    python -m repro_torch.obs.report RUN.jsonl [--trace TRACE.json] [--blackbox BB.json]

The JAX package's ``repro.obs.report`` uses no JAX; the port keeps
this copy of it so that it imports nothing of that package.
"""
from __future__ import annotations

import argparse
import json
import sys


def load_metrics_jsonl(path: str) -> dict:
    """Parse a dump into {header, metrics: {name: row}, events: [...]}.
    Tolerates trailing garbage lines (a crashed writer mid-line) —
    parseable prefix wins."""
    header = None
    metrics: dict = {}
    events: list = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                break
            kind = row.get("kind")
            if kind == "header":
                header = row
            elif kind == "event":
                events.append(row)
            elif kind is not None:
                metrics[row.get("name", "?")] = row
    if header is None:
        raise ValueError(f"{path}: no JSONL header line "
                         "(not a metrics dump?)")
    return {"header": header, "metrics": metrics, "events": events}


def _fmt(v, width: int = 9) -> str:
    if v is None:
        return "-".rjust(width)
    try:
        return f"{float(v):.4g}".rjust(width)
    except (TypeError, ValueError):
        return str(v).rjust(width)


def _bucket_spectra(metrics: dict) -> list[str]:
    """Per-bucket table from the bucket/<name>/<col> histogram rows."""
    cols = ("nnz", "wire_bytes", "mass_coverage", "ef_norm")
    buckets: dict[str, dict] = {}
    for name, row in metrics.items():
        parts = name.split("/")
        if len(parts) == 3 and parts[0] == "bucket" and parts[2] in cols:
            buckets.setdefault(parts[1], {})[parts[2]] = row
    if not buckets:
        return ["  (no per-bucket telemetry in this run)"]
    w = max(len(b) for b in buckets)
    head = (f"  {'bucket':<{w}} {'nnz p50':>9} {'nnz p99':>9} "
            f"{'wire p50':>9} {'cov p50':>9} {'cov min':>9} "
            f"{'ef p50':>9} {'ef max':>9}")
    lines = [head, "  " + "-" * (len(head) - 2)]
    for b in sorted(buckets):
        r = buckets[b]

        def g(col, stat):
            return (r.get(col) or {}).get(stat)

        lines.append(
            f"  {b:<{w}} {_fmt(g('nnz', 'p50'))} {_fmt(g('nnz', 'p99'))} "
            f"{_fmt(g('wire_bytes', 'p50'))} "
            f"{_fmt(g('mass_coverage', 'p50'))} "
            f"{_fmt(g('mass_coverage', 'min'))} "
            f"{_fmt(g('ef_norm', 'p50'))} {_fmt(g('ef_norm', 'max'))}")
    return lines


def _health_timeline(events: list) -> list[str]:
    rows = [e for e in events
            if str(e.get("event", "")).startswith("health/")]
    if not rows:
        return ["  (no health events — clean run or health engine off)"]
    mark = {"critical": "!!", "warn": " !", "info": "  "}
    lines = []
    for e in sorted(rows, key=lambda e: e.get("t", 0.0)):
        sev = e.get("severity", "info")
        lines.append(
            f"  t+{float(e.get('t', 0.0)):7.2f}s {mark.get(sev, '  ')} "
            f"[{sev:<8}] {e['event'][len('health/'):]:<15} "
            f"{e.get('subject', '?'):<20} {e.get('message', '')}")
    return lines


def _recovery_timeline(metrics: dict, events: list) -> list[str]:
    """Fault/recovery story of the run (DESIGN.md §12): injected faults,
    guard trips, retries/aborts, checkpoint fallbacks, demotions and
    serve sheds in time order, closed by the recovery counters. Works on
    torn tails too — load_metrics_jsonl already dropped them."""
    prefixes = ("faults/", "recovery/", "serve/shed", "adapt/fault_")
    rows = [e for e in events
            if str(e.get("event", "")).startswith(prefixes)
            or e.get("event") in ("driver/restart", "health/nonfinite")]
    counters = {n: r.get("value") for n, r in sorted(metrics.items())
                if r.get("kind") == "counter"
                and n.startswith(("faults/", "recovery/", "guard/",
                                  "serve/shed", "serve/retries"))}
    if not rows and not counters:
        return ["  (no fault/recovery activity in this run)"]
    lines = []
    for e in sorted(rows, key=lambda e: e.get("t", 0.0)):
        detail = " ".join(
            f"{k}={e[k]}" for k in sorted(e)
            if k not in ("event", "t", "kind", "message"))
        msg = e.get("message", "")
        lines.append(f"  t+{float(e.get('t', 0.0)):7.2f}s "
                     f"{e['event']:<24} {detail}"
                     + (f"  {msg}" if msg else ""))
    if counters:
        lines.append("  counters: " + " ".join(
            f"{n}={v}" for n, v in counters.items()))
    return lines


def _slo_table(metrics: dict, events: list) -> list[str]:
    targets: dict = {}
    for e in events:
        if e.get("event") == "serve/slo_targets":
            # keep only the numeric target fields; the JSONL record also
            # carries bookkeeping keys (kind, event, t)
            targets.update({k: v for k, v in e.items()
                            if k not in ("event", "t", "kind")
                            and isinstance(v, (int, float))})
    if not targets:
        return ["  (no SLO targets declared — pass a ServeConfig with "
                "slo_* set)"]
    head = (f"  {'slo':<14} {'target':>9} {'p99':>9} {'p50':>9} "
            f"{'attained':>9}")
    lines = [head, "  " + "-" * (len(head) - 2)]
    for key in sorted(targets):
        t = targets[key]
        row = metrics.get(f"serve/{key}_steps") or {}
        p99 = row.get("p99")
        ok = ("-" if p99 is None or t is None
              else ("yes" if float(p99) <= float(t) else "NO"))
        lines.append(f"  {key:<14} {_fmt(t)} {_fmt(p99)} "
                     f"{_fmt(row.get('p50'))} {ok:>9}")
    return lines


def _trace_digest(path: str) -> list[str]:
    from repro_torch.obs.trace import validate_span_tree

    doc = json.load(open(path))
    evs = doc.get("traceEvents", [])
    spans = [e for e in evs if e.get("ph") == "X"]
    problems = validate_span_tree(evs)
    by_name: dict[str, float] = {}
    for s in spans:
        by_name[s["name"]] = by_name.get(s["name"], 0.0) + s.get("dur", 0.0)
    lines = [f"  {len(evs)} events, {len(spans)} spans; span tree "
             + ("OK" if not problems else f"{len(problems)} problem(s)")]
    for p in problems[:5]:
        lines.append(f"    problem: {p}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        lines.append(f"  {name:<32} {us / 1e3:10.3f} ms total")
    return lines


def _blackbox_digest(path: str) -> list[str]:
    doc = json.load(open(path))
    notes = doc.get("notes", [])
    return [
        f"  reason={doc.get('reason')!r} uptime={doc.get('uptime_s', 0):.1f}s "
        f"notes={len(notes)} trace_tail={len(doc.get('trace_tail', []))} "
        f"event_tail={len(doc.get('event_tail', []))}",
        *(f"    last note: {json.dumps(notes[-1])}" if notes else ()),
    ]


def render(metrics_path: str, trace_path: str | None = None,
           blackbox_path: str | None = None) -> str:
    doc = load_metrics_jsonl(metrics_path)
    meta = doc["header"].get("meta") or {}
    out = [f"== obs report: {metrics_path} "
           f"(schema v{doc['header'].get('schema_version')}) =="]
    if meta:
        out.append("  " + " ".join(f"{k}={v}" for k, v in
                                   sorted(meta.items())[:8]))
    out.append("")
    out.append("-- per-bucket density/mass spectra --")
    out.extend(_bucket_spectra(doc["metrics"]))
    out.append("")
    out.append("-- health timeline --")
    out.extend(_health_timeline(doc["events"]))
    out.append("")
    out.append("-- recovery timeline --")
    out.extend(_recovery_timeline(doc["metrics"], doc["events"]))
    out.append("")
    out.append("-- serve SLO attainment --")
    out.extend(_slo_table(doc["metrics"], doc["events"]))
    if trace_path:
        out.append("")
        out.append(f"-- trace digest: {trace_path} --")
        out.extend(_trace_digest(trace_path))
    if blackbox_path:
        out.append("")
        out.append(f"-- flight recorder: {blackbox_path} --")
        out.extend(_blackbox_digest(blackbox_path))
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a run's obs artifacts as a terminal summary")
    ap.add_argument("metrics", help="metrics JSONL path (dump_jsonl output)")
    ap.add_argument("--trace", default=None, help="Chrome trace JSON path")
    ap.add_argument("--blackbox", default=None,
                    help="flight-recorder blackbox.json path")
    args = ap.parse_args(argv)
    print(render(args.metrics, args.trace, args.blackbox))
    return 0


if __name__ == "__main__":
    sys.exit(main())
