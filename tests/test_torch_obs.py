"""The port's observability package (``repro_torch.obs``) against the JAX
package's ``repro.obs``, and the port's driver with observability on.

The same inputs (numpy samples, span lists, registry contents, audit
samples) go to both packages; their outputs are held equal exactly:
histogram snapshots and percentiles, the JSONL lines (but for the
timestamps), span-tree verdicts, health verdicts in rank order and the
drift report. The driver's tests count its host waits (one a retired
unit, observability on or off) and check the trace and metrics of a run;
none rests on a wall clock. The sparcml step's own spans are
tests/test_torch_spans.py's.
"""
import dataclasses
import itertools
import json
import signal
import time

import numpy as np
import pytest
import torch

from repro.obs import audit as jax_audit
from repro.obs import health as jax_health
from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro_torch import obs
from repro_torch.comm.collectives import StackedCollectives
from repro_torch.core.compressor import SyncConfig
from repro_torch.core.cost_model import NetworkParams
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.obs import audit, health, metrics, recorder, report, trace
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime import driver as rt_driver
from repro_torch.runtime import pipeline as rt_pipeline
from repro_torch.runtime.adapt import TelemetryObserver
from repro_torch.train import train_step as ts
from repro_torch.train.state import TrainConfig

P_DATA = 4
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
DATA = dict(global_batch=8, seq_len=16, vocab_size=256)
NET = NetworkParams(alpha=1e-5, link_bytes_per_s=1e9)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

SAMPLES = {"empty": [], "one": [7.5], "ramp": list(np.arange(1.0, 101.0)),
           "noisy": list(np.random.default_rng(0).lognormal(0, 2, 257))}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_histogram_matches_jax(name):
    """Snapshots, percentiles and the one-line brief, empty and single
    samples included."""
    got, want = metrics.Histogram("h"), jax_metrics.Histogram("h")
    got.observe_many(np.asarray(SAMPLES[name]))
    want.observe_many(np.asarray(SAMPLES[name]))
    assert got.snapshot() == want.snapshot()
    assert got.brief() == want.brief()
    for q in (0, 1, 50, 90, 99, 100):
        a, b = got.percentile(q), want.percentile(q)
        assert a == b or (np.isnan(a) and np.isnan(b))


def _fill(reg, m):
    reg.counter("c").inc()
    reg.counter("c").inc(2)
    reg.gauge("g").set(np.float32(1.5))
    reg.histogram("h").observe_many(SAMPLES["noisy"][:20])
    reg.series("s").append((1, "x"))
    m.record_bucket_telemetry(reg, {
        "b0": np.array([[3, 96.0], [5, 160.0]]),
        "b1": np.array([[3, 96.0, 0.5, 1.25]]),
        "bad": np.array([1.0])})
    reg.event("ev/one", step=3, signature="sig", arr=np.arange(3),
              scalar=np.float64(2.5), t_like=torch.tensor(4.0))


def test_jsonl_round_trip_matches_jax(tmp_path):
    """The same registry contents dump to the same JSONL lines (header,
    metrics, events; the event times aside), and the summaries agree."""
    got, want = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    _fill(got, metrics)
    _fill(want, jax_metrics)
    lines = []
    for reg, name in ((got, "port"), (want, "jax")):
        path = reg.dump_jsonl(str(tmp_path / f"{name}.jsonl"),
                              meta={"who": "test"})
        rows = [json.loads(ln) for ln in open(path)]
        for r in rows:
            r.pop("t", None)
        lines.append(rows)
    assert lines[0] == lines[1]
    assert lines[0][0]["schema_version"] == metrics.SCHEMA_VERSION == 2
    assert "bucket/bad/nnz" not in got.metrics
    assert got.summary() == want.summary()
    with pytest.raises(TypeError):
        got.gauge("c")


def test_disabled_registry_keeps_series_views():
    reg = metrics.MetricsRegistry(enabled=False)
    view = reg.series("train/loss").data
    view.append(1.0)
    reg.event("nope", x=1)
    assert reg.series("train/loss").data is view == [1.0]
    assert reg.events == []
    log = rt_driver.DriverLog(reg)
    assert log.losses is view
    log.restarts += 2
    assert reg.counter("driver/restarts").value == 2


def test_jsonl_sink_flushes_on_exception(tmp_path):
    reg = metrics.MetricsRegistry()
    path = str(tmp_path / "m.jsonl")
    with pytest.raises(RuntimeError):
        with reg.jsonl_sink(path, meta={"run": 1}):
            reg.counter("steps").inc(3)
            raise RuntimeError("killed")
    rows = [json.loads(ln) for ln in open(path)]
    assert rows[0]["meta"] == {"run": 1}
    assert {"kind": "counter", "name": "steps", "value": 3} in rows


# --------------------------------------------------------------------------
# trace
# --------------------------------------------------------------------------

NESTED = [
    {"name": "root", "ph": "X", "ts": 0.0, "dur": 100.0, "pid": 1, "tid": 1},
    {"name": "mid", "ph": "X", "ts": 10.0, "dur": 50.0, "pid": 1, "tid": 1},
    {"name": "leaf", "ph": "X", "ts": 20.0, "dur": 10.0, "pid": 1, "tid": 1},
    {"name": "tail", "ph": "X", "ts": 70.0, "dur": 20.0, "pid": 1, "tid": 1},
]
OVERLAP = {"name": "ovl", "ph": "X", "ts": 45.0, "dur": 20.0, "pid": 1,
           "tid": 1}


def _span_cases():
    for perm in itertools.permutations(NESTED):
        yield list(perm)
    for pos in range(len(NESTED) + 1):
        yield NESTED[:pos] + [OVERLAP] + NESTED[pos:]
    yield [dict(OVERLAP, tid=2)] + NESTED
    yield [{"name": "p", "ph": "X", "ts": 0.0, "dur": 100.0, "pid": 1,
            "tid": 1},
           {"name": "c", "ph": "X", "ts": 0.0, "dur": 40.0, "pid": 1,
            "tid": 1},
           {"name": "dot", "ph": "X", "ts": 99.9, "dur": 0.0, "pid": 1,
            "tid": 1},
           {"name": "i", "ph": "i", "ts": 1e9, "pid": 1, "tid": 1}]


def test_validate_span_tree_matches_jax():
    """Every order of a well-formed tree, a partial overlap anywhere in
    the list, the same spans on another track, same-start twins."""
    n_bad = 0
    for evs in _span_cases():
        got = trace.validate_span_tree(evs)
        assert got == jax_trace.validate_span_tree(evs)
        n_bad += bool(got)
    assert n_bad == len(NESTED) + 1


def test_tracer_records_nested_spans_and_exports(tmp_path):
    tr = trace.Tracer()
    with tr.span("outer", step=1):
        with tr.span("inner/a"):
            pass
        with tr.span("inner/b"):
            pass
    tr.instant("marker")
    tr.counter("occupancy", active=3)
    assert trace.validate_span_tree(tr.events) == []
    assert [e["name"] for e in tr.events if e["ph"] == "X"][:3] == [
        "inner/a", "inner/b", "outer"]
    doc = json.load(open(tr.export(str(tmp_path / "t.json"),
                                   meta={"run": "t"})))
    assert doc["otherData"] == {"run": "t"}
    assert len(doc["traceEvents"]) == len(tr.events)
    assert trace.NULL_TRACER.span("a") is trace.NULL_TRACER.span("b")
    trace.NULL_TRACER.instant("x")
    assert trace.NULL_TRACER.events == []


# --------------------------------------------------------------------------
# health
# --------------------------------------------------------------------------

def _health_registry(m, h, seed):
    """EF blow-up on one bucket, a coverage collapse on another, a healthy
    third, a step-time regression, serve latencies and guard trips."""
    rng = np.random.default_rng(seed)
    reg = m.MetricsRegistry()
    for i in range(40):
        grow = 1.0 if i < 20 else 6.0
        reg.histogram("bucket/g1b0/ef_norm").observe(grow + rng.uniform())
        reg.histogram("bucket/g1b0/mass_coverage").observe(0.9)
        reg.histogram("bucket/g2b0/ef_norm").observe(1.0 + 0.1 * rng.uniform())
        reg.histogram("bucket/g2b0/mass_coverage").observe(
            0.3 if i > 10 else 0.9)
        reg.histogram("bucket/g3b0/ef_norm").observe(2.0)
        reg.histogram("bucket/g3b0/mass_coverage").observe(0.8)
        reg.series("train/step_time_s").append(
            0.1 if i < 30 else 0.1 + 0.05 * i)
        reg.histogram("serve/ttft_steps").observe(3 + i % 7)
    reg.counter("guard/nonfinite_trips").inc(2)
    aud = m is metrics and audit.DriftAuditor() or jax_audit.DriftAuditor()
    for i in range(3):
        aud.record("good", f"b{i}", 1e-3, 1.2e-3)
        aud.record("bad", f"b{i}", 1e-3, 2e-2)
    mon = h.HealthMonitor(reg, h.HealthConfig(window=16, min_samples=4),
                          serve_slo={"ttft": 4.0}, audit=aud)
    return reg, mon


def _verdicts(events):
    return [(e.severity, e.rule, e.subject, e.message, e.value, e.threshold)
            for e in events]


def test_health_monitor_matches_jax():
    """The same registry contents give the same verdicts in the same
    order, the same mirrored events, the same advisory and summary; the
    guard-trip rule reports only new trips."""
    reg, mon = _health_registry(metrics, health, 1)
    jreg, jmon = _health_registry(jax_metrics, jax_health, 1)
    got, want = mon.evaluate(), jmon.evaluate()
    assert _verdicts(got) == _verdicts(want)
    assert {e.rule for e in got} == {"ef_growth", "coverage_floor",
                                     "step_time_p99", "serve_slo",
                                     "nonfinite", "drift_flag"}
    strip = lambda r: [{k: v for k, v in e.items() if k != "t"}
                       for e in r.events]
    assert strip(reg) == strip(jreg)
    assert mon.advisory() == jmon.advisory()
    assert mon.summary() == jmon.summary()
    again, jagain = mon.evaluate(), jmon.evaluate()
    assert _verdicts(again) == _verdicts(jagain)
    assert "nonfinite" not in {e.rule for e in again}


def test_rank_events_matches_jax():
    rows = [("warn", "ef_growth", "b2"), ("critical", "nonfinite", "grads"),
            ("info", "x", "a"), ("critical", "coverage_floor", "b1"),
            ("warn", "ef_growth", "b1")]
    got = health.rank_events([health.HealthEvent(s, r, b, "", 0.0, 0.0)
                              for s, r, b in rows])
    want = jax_health.rank_events([jax_health.HealthEvent(s, r, b, "", 0.0,
                                                          0.0)
                                   for s, r, b in rows])
    assert _verdicts(got) == _verdicts(want)


def test_health_underfilled_windows_stay_silent():
    reg = metrics.MetricsRegistry()
    for _ in range(5):
        reg.histogram("bucket/b/ef_norm").observe(1.0)
    assert health.HealthMonitor(reg).evaluate() == []


# --------------------------------------------------------------------------
# the drift auditor
# --------------------------------------------------------------------------

def _audit_samples(aud):
    rng = np.random.default_rng(2)
    for i in range(5):
        aud.record("dsar_split_allgather", f"b{i}", 1e-3,
                   1e-3 * rng.uniform(0.8, 1.4), n=4096 * (i + 1))
        aud.record("ssar_recursive_double", f"b{i}", 2e-4,
                   2e-4 * rng.uniform(5, 12))
    aud.record("dense", "zero", 0.0, 1e-3)
    return aud


def test_drift_auditor_matches_jax():
    got = _audit_samples(audit.DriftAuditor(flag_ratio=3.0))
    want = _audit_samples(jax_audit.DriftAuditor(flag_ratio=3.0))
    assert json.dumps(got.report(), sort_keys=True) == json.dumps(
        want.report(), sort_keys=True)
    assert got.summary() == want.summary()
    assert got.flagged_algorithms() == ["ssar_recursive_double"]
    reg, jreg = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    got.emit(reg)
    want.emit(jreg)
    strip = lambda r: json.dumps([{k: v for k, v in e.items() if k != "t"}
                                  for e in r.events], sort_keys=True)
    assert strip(reg) == strip(jreg)      # NaN ratios of the 0 prediction
    assert reg.gauge("audit/net_scale_hint").value == \
        jreg.gauge("audit/net_scale_hint").value
    with pytest.raises(ValueError):
        audit.DriftAuditor(flag_ratio=1.0)


def _tiny():
    model = build_model(ModelConfig(**TINY, dtype=torch.float32,
                                    param_dtype=torch.float32))
    tcfg = TrainConfig(
        sync=SyncConfig(mode="sparcml", k_per_bucket=4, bucket_size=128,
                        algorithm="dsar_split_allgather", qsgd_bits=4,
                        qsgd_bucket=128, min_sparse_size=1024),
        optimizer=OptimizerConfig(),
        schedule=ScheduleConfig(kind="wsd", peak_lr=3e-3, warmup_steps=2,
                                total_steps=20),
        microbatches=2)
    return model, tcfg


def test_audit_sync_plan_probes_each_signature():
    """One probe a distinct (algorithm, n, k), on the stacked ranks of the
    CPU; buckets over max_n are skipped with an event; the join lands in
    the registry."""
    model, tcfg = _tiny()
    plan = ts.build_plan(model, tcfg, P_DATA).replan(
        algorithms={"g1b0": "dense", "g2b0": "ssar_recursive_double"})
    reg = metrics.MetricsRegistry()
    big = max(b.n for b in plan.buckets)
    aud = audit.audit_sync_plan(plan, StackedCollectives(P_DATA,
                                                         device="cpu"),
                                net=NET, reps=1, registry=reg,
                                max_n=big - 1)
    sigs = {(b.algorithm, b.n, plan.bucket_k(g, b)) for g in plan.groups
            for b in g.buckets if b.n < big}
    assert len(aud) == len(sigs)
    assert {s["algorithm"] for s in aud.samples} == {a for a, _, _ in sigs}
    assert all(s["p"] == P_DATA and s["kind"] == "train_bucket"
               and np.isfinite(s["measured_s"]) and s["predicted_s"] > 0
               for s in aud.samples)
    assert [e["name"] for e in reg.events_named("audit/bucket_skipped")] \
        == [b.name for b in plan.buckets if b.n == big]
    assert reg.events_named("audit/algorithm_residual")


def test_audit_probe_errors(monkeypatch):
    """A probe the library refuses before any launch is an event; any
    other error (a CUDA error, a kernel that fails) propagates."""
    from repro_torch.core import allreduce

    model, tcfg = _tiny()
    plan = ts.build_plan(model, tcfg, P_DATA)
    coll = StackedCollectives(P_DATA, device="cpu")

    def refuse(*a, **k):
        raise ValueError("bucket_size 100 is not a multiple of 128")

    monkeypatch.setattr(allreduce, "make_sparse_allreduce", refuse)
    reg = metrics.MetricsRegistry()
    aud = audit.audit_sync_plan(plan, coll, net=NET, registry=reg)
    assert len(aud) == 0 and reg.events_named("audit/bucket_probe_failed")

    def launch_fails(*a, **k):
        def f(x, rand):
            raise RuntimeError("CUDA error: an illegal memory access")
        return f

    monkeypatch.setattr(allreduce, "make_sparse_allreduce", launch_fails)
    with pytest.raises(RuntimeError, match="CUDA error"):
        audit.audit_sync_plan(plan, coll, net=NET)


def test_audit_kernel_refusal_at_launch_propagates():
    """A probe that builds but whose kernel refuses its inputs at launch
    (the CUDA route handed the CPU's tensors) raises out of the audit:
    only a refusal to build is recorded as an event."""
    model, tcfg = _tiny()
    tcfg = dataclasses.replace(
        tcfg, sync=dataclasses.replace(tcfg.sync, impl="cuda"))
    plan = ts.build_plan(model, tcfg, P_DATA)
    reg = metrics.MetricsRegistry()
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        audit.audit_sync_plan(plan, StackedCollectives(P_DATA, device="cpu"),
                              net=NET, reps=1, registry=reg)
    assert not reg.events_named("audit/bucket_probe_failed")


# --------------------------------------------------------------------------
# the flight recorder and the report
# --------------------------------------------------------------------------

def test_recorder_ring_is_bounded_and_dumps_atomically(tmp_path):
    ob = obs.configure(trace=True, metrics=True, set_as_default=False,
                       recorder=str(tmp_path / "bb.json"),
                       recorder_capacity=4)
    for i in range(10):
        ob.recorder.note("driver/retire", step=i, loss=np.float32(1.5))
        with ob.span("s", i=i):
            pass
    ob.metrics.series("train/loss").data.extend(range(10))
    path = ob.recorder.dump("test")
    doc = json.load(open(path))
    assert doc["reason"] == "test" and ob.recorder.dumps == 1
    assert [n["step"] for n in doc["notes"]] == [6, 7, 8, 9]
    assert len(doc["trace_tail"]) == 4
    assert doc["series_tail"]["train/loss"] == [6, 7, 8, 9]
    assert not list(tmp_path.glob(".bb.json.tmp*"))


def test_recorder_signal_handler_dumps_and_chains(tmp_path):
    rec = recorder.FlightRecorder(str(tmp_path / "bb.json"))
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda n, f: seen.append(n))
    try:
        assert rec.install_signal_handlers(("SIGUSR1",)) == ["SIGUSR1"]
        signal.raise_signal(signal.SIGUSR1)
        assert rec.last_reason == "signal:SIGUSR1" and seen
    finally:
        rec.uninstall_signal_handlers()
        signal.signal(signal.SIGUSR1, prev)


def test_report_renders_a_runs_artifacts(tmp_path, capsys):
    """The report (a stdlib copy of the reference's) over the port's own
    metrics JSONL and trace gives the reference's report's text."""
    from repro.obs import report as jax_report

    ob = obs.configure(trace=True, metrics=True, set_as_default=False)
    metrics.record_bucket_telemetry(ob.metrics, {
        "g1b0": np.array([[10, 96.0, 0.5, 1.0], [12, 100.0, 0.4, 1.2]])})
    ob.event("health/ef_growth", severity="warn", subject="g1b0",
             message="grew")
    with ob.span("driver/retire"):
        pass
    paths = ob.export(trace_path=str(tmp_path / "t.json"),
                      metrics_path=str(tmp_path / "m.jsonl"))
    argv = [paths["metrics"], "--trace", paths["trace"]]
    assert report.main(argv) in (0, None)
    got = capsys.readouterr().out
    jax_report.main(argv)
    want = capsys.readouterr().out
    assert got == want and "g1b0" in got


def test_observability_facade():
    off = obs.Observability()
    assert not off.enabled and off.span("x") is off.span("y")
    off.event("nothing", name="n")
    assert off.metrics.events == []
    ob = obs.configure(trace=True, metrics=True, audit=True,
                       set_as_default=False)
    assert obs.resolve(None) is obs.get_default()
    assert obs.resolve(ob) is ob
    ob.event("adapt/x", name="field-named-name")
    assert ob.metrics.events[0]["name"] == "field-named-name"
    assert ob.tracer.events[0]["ph"] == "i"
    prev = obs.get_default()
    try:
        obs.set_default(ob)
        assert obs.resolve(None) is ob
    finally:
        obs.set_default(prev)


# --------------------------------------------------------------------------
# the driver with observability on
# --------------------------------------------------------------------------

K_UNIT = 2


@pytest.fixture(scope="module")
def pipelined():
    model, tcfg = _tiny()
    fn, plan = rt_pipeline.build_superstep(model, tcfg, P_DATA, "cpu",
                                           steps=K_UNIT)
    return model, tcfg, fn, plan


def _drive(pipelined, n=8, ob=None, adapt=None, health_mon=None,
           ckpt_every=None):
    model, tcfg, fn, plan = pipelined
    state = rt_pipeline.attach_inflight(ts.init_state(model, tcfg, plan,
                                                      "cpu"), plan)
    return rt_driver.run_pipelined(
        fn, state, start_step=0, num_steps=n,
        batch_fn=lambda s: synthetic_batch(DataConfig(**DATA), s),
        cfg=rt_driver.DriverConfig(steps_per_unit=K_UNIT), obs=ob,
        adapt=adapt, health=health_mon,
        ckpt_every=ckpt_every,
        ckpt_fn=(lambda s: None) if ckpt_every else None)


def test_driver_obs_adds_no_host_waits(pipelined, monkeypatch):
    """The retire's wait is the only one: one a retired unit with
    observability off and fully on (trace, metrics, telemetry recorded,
    health rules), and the losses are the same; the trace draws no
    derived device-phase track."""
    real = rt_driver._wait
    count = {"n": 0}

    def counting(done):
        count["n"] += 1
        return real(done)

    monkeypatch.setattr(rt_driver, "_wait", counting)

    def run(ob, **kw):
        count["n"] = 0
        _, log = _drive(pipelined, ob=ob, **kw)
        return count["n"], list(log.losses)

    off, losses_off = run(obs.Observability())
    ob = obs.configure(trace=True, metrics=True, set_as_default=False)
    on, losses_on = run(
        ob, adapt=TelemetryObserver(ob),
        health_mon=health.HealthMonitor(ob.metrics), ckpt_every=4)
    assert off == on == 4        # one retire per 2-step unit, 8 steps
    assert losses_off == losses_on
    assert not [e for e in ob.tracer.events
                if e.get("tid") == "device-phases"]


def test_driver_trace_and_metrics(pipelined, tmp_path):
    """The spans of dispatch, retire, drain and checkpoint nest, on Unix
    time; the pipelined step records no sparcml.* phase span and no
    derived device-phase track is drawn; the log is registry-backed;
    every EF bucket's four histograms hold one sample a retired step."""
    ob = obs.configure(trace=True, metrics=True, set_as_default=False)
    t0 = time.time_ns() / 1e3
    state, log = _drive(pipelined, ob=ob, adapt=TelemetryObserver(ob),
                        ckpt_every=4)
    assert state.step == 8
    assert log.losses is ob.metrics.series("train/loss").data
    assert len(log.losses) == 8 == len(log.step_times)
    assert ob.metrics.histogram("driver/retire_wall_s").snapshot()[
        "count"] == 4
    assert obs.validate_span_tree(ob.tracer.events) == []
    names = {e["name"] for e in ob.tracer.events if e["ph"] == "X"}
    assert {"driver/dispatch", "driver/retire", "driver/drain",
            "driver/checkpoint"} <= names
    assert not {n for n in names if n.startswith("sparcml.")}
    assert not [e for e in ob.tracer.events
                if e.get("tid") == "device-phases"]
    assert all(t0 <= e["ts"] <= time.time_ns() / 1e3
               for e in ob.tracer.events)
    plan = pipelined[3]
    for b in plan.buckets:
        for col in ("nnz", "wire_bytes", "mass_coverage", "ef_norm"):
            h = ob.metrics.metrics.get(f"bucket/{b.name}/{col}")
            assert (h is not None and len(h.values) == 8) == b.has_residual
    doc = json.load(open(ob.tracer.export(str(tmp_path / "t.json"))))
    assert len(doc["traceEvents"]) == len(ob.tracer.events)


def test_driver_dumps_the_blackbox_on_failure(pipelined, tmp_path):
    ob = obs.configure(metrics=True, set_as_default=False,
                       recorder=str(tmp_path / "bb.json"))

    def batch_fn(s):
        if s == 4:
            raise OSError("disk gone")
        return synthetic_batch(DataConfig(**DATA), s)

    model, tcfg, fn, plan = pipelined
    state = rt_pipeline.attach_inflight(ts.init_state(model, tcfg, plan,
                                                      "cpu"), plan)
    with pytest.raises(Exception):
        rt_driver.run_pipelined(
            fn, state, start_step=0, num_steps=8, batch_fn=batch_fn,
            cfg=rt_driver.DriverConfig(steps_per_unit=K_UNIT), obs=ob)
    doc = json.load(open(tmp_path / "bb.json"))
    assert doc["reason"].startswith("exception:")
    assert [n["kind"] for n in doc["notes"]][-1] == "driver/prefetch_error"
    assert any(n["kind"] == "driver/retire" for n in doc["notes"])


# --------------------------------------------------------------------------
# run_lm's observability flags
# --------------------------------------------------------------------------

def test_run_lm_adapt_trace_metrics_blackbox(monkeypatch, capsys, tmp_path):
    """run_lm --pipeline --adapt --trace --metrics-out --blackbox on a tiny
    model on the CPU (fixed network parameters: no wall clock decides the
    plan): it prints the plan swaps, the drift audit, the health summary,
    the metrics summary and the paths it wrote, and the files parse."""
    from repro_torch.train import run_lm
    from repro_torch.train.trainer import Trainer

    cfg = ModelConfig(**TINY, dtype=torch.float32, param_dtype=torch.float32)
    monkeypatch.setattr(run_lm, "lm_config",
                        lambda fast: (cfg, DataConfig(**DATA)))
    monkeypatch.setattr(Trainer, "_calibrated_net", lambda self: NET)
    t, m, bb = (str(tmp_path / n) for n in ("t.json", "m.jsonl", "bb.json"))
    prev = signal.getsignal(signal.SIGTERM)
    try:
        log = run_lm.main(["--fast", "--steps", "12", "--pipeline",
                           "--superstep", "2", "--adapt", "--trace", t,
                           "--metrics-out", m, "--blackbox", bb,
                           "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, prev)    # the recorder's handler
    out = capsys.readouterr().out
    assert "adaptive re-planning:" in out and "plan swap(s)" in out
    assert "med_ratio" in out            # the drift audit's table
    assert "health:" in out and "train/loss" in out
    assert f"obs: wrote {t}" in out and f"obs: wrote {m}" in out
    assert np.isfinite(log.losses).all()
    doc = json.load(open(t))
    assert obs.validate_span_tree(doc["traceEvents"]) == []
    rows = [json.loads(ln) for ln in open(m)]
    assert rows[0]["kind"] == "header"
    assert any(r.get("event") == "audit/algorithm_residual" for r in rows)


def test_run_lm_audit_skips_a_degenerate_fit(monkeypatch, capsys, tmp_path):
    """run_lm --metrics-out whose calibration ladder does not fit (host
    timing noise) skips the drift audit with an event and a line, and still
    reports and exports the run."""
    from repro_torch.train import run_lm
    from repro_torch.utils import calibrate

    def degenerate(*a, **k):
        raise calibrate.DegenerateFit("slope -1e-12 is not positive")

    cfg = ModelConfig(**TINY, dtype=torch.float32, param_dtype=torch.float32)
    monkeypatch.setattr(run_lm, "lm_config",
                        lambda fast: (cfg, DataConfig(**DATA)))
    monkeypatch.setattr(calibrate, "calibrate", degenerate)
    m = str(tmp_path / "m.jsonl")
    log = run_lm.main(["--fast", "--steps", "10", "--pipeline",
                       "--superstep", "2", "--metrics-out", m,
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "drift audit skipped: slope" in out and "health:" in out
    assert f"obs: wrote {m}" in out and np.isfinite(log.losses).all()
    rows = [json.loads(ln) for ln in open(m)]
    assert any(r.get("event") == "audit/skipped" for r in rows)


@pytest.mark.parametrize("net_known", [False, True])
def test_traced_trainer_derives_phases_on_a_known_network(monkeypatch,
                                                          net_known):
    """A traced Trainer run with adapt off runs no calibration ladder, and
    draws no derived device-phase track whether a network is known or
    not; its synchronous loop's step records its sparcml.* phases, once a
    step each, nested in the step."""
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils import calibrate

    def no_ladder(*a, **k):
        raise AssertionError("a traced run ran the calibration ladder")

    monkeypatch.setattr(calibrate, "calibrate", no_ladder)
    model, tcfg = _tiny()
    ob = obs.configure(trace=True, metrics=True, set_as_default=False)
    tr = Trainer(model, tcfg, DataConfig(**DATA), dp_total=P_DATA,
                 device="cpu", obs=ob)
    tr.init()
    if net_known:
        tr._net_cal = NET
    log = tr.run_pipelined(4, superstep=2)
    assert not [e for e in ob.tracer.events
                if e["name"].startswith("sparcml.")
                or e.get("tid") == "device-phases"]
    log = tr.run(6)
    assert np.isfinite(log.losses).all()
    assert obs.validate_span_tree(ob.tracer.events) == []
    spans = [e for e in ob.tracer.events if e["name"].startswith("sparcml.")]
    assert sorted(e["name"] for e in spans) == sorted(
        ["sparcml.step", "sparcml.rank_grads", "sparcml.reduce_half",
         "sparcml.reduce.buckets", "sparcml.optimizer_half"] * 2)
    for step in (e for e in spans if e["name"] == "sparcml.step"):
        inner = [e for e in spans if step["ts"] <= e["ts"]
                 and e["ts"] + e["dur"] <= step["ts"] + step["dur"]]
        assert len(inner) == 5
    assert not [e for e in ob.tracer.events
                if e.get("tid") == "device-phases"]


def test_contexts_default_to_the_card():
    """Both collectives contexts hold their tensors on the card unless
    asked for the CPU; without CUDA a bare constructor raises."""
    from repro_torch.comm.collectives import ProcessGroupCollectives

    if torch.cuda.is_available():
        assert StackedCollectives(2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StackedCollectives(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProcessGroupCollectives()
    assert StackedCollectives(2, device="cpu").device.type == "cpu"


def test_trainer_records_telemetry_without_adapt():
    """With metrics on and adapt off the Trainer builds the telemetry rows
    into its step and records them (TelemetryObserver); with metrics off
    it builds none, and the losses are the same bit for bit."""
    from repro_torch.train.trainer import Trainer

    model, tcfg = _tiny()
    runs = {}
    for on in (False, True):
        ob = obs.configure(metrics=True, set_as_default=False) if on \
            else None
        tr = Trainer(model, tcfg, DataConfig(**DATA), dp_total=P_DATA,
                     device="cpu", obs=ob)
        tr.init()
        runs[on] = list(tr.run_pipelined(4, superstep=2).losses)
        assert tr.last_adapt_runtime is None
        assert (tr.last_health is not None) == on
    assert runs[True] == runs[False]
    ef = [b.name for b in tr.plan.buckets if b.has_residual]
    assert all(len(ob.metrics.histogram(f"bucket/{n}/ef_norm").values) == 4
               for n in ef)
    assert len(ob.metrics.series("train/loss").data) == 4
