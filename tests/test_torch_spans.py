"""The sparcml step's phase spans (``train/train_step.py``) and the
tracer's two sinks (``obs/trace.py``): its own Chrome-trace events when it
is on, and a recording ``torch.profiler`` session's ranges whether it is
on or not; nothing of either, and no read of the allocator's counters,
when both are off."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core.compressor import SyncConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.obs import trace
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.train import train_step as ts
from repro_torch.train.state import TrainConfig

P_DATA = 4
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=64)
DATA = DataConfig(global_batch=8, seq_len=16, vocab_size=256)
PHASES = ("sparcml.rank_grads", "sparcml.reduce_half",
          "sparcml.optimizer_half")
SPANS = ("sparcml.step",) + PHASES + ("sparcml.reduce.buckets",)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
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


def _steps(tiny, n=2, lowering="spmd", ob=None):
    model, tcfg = tiny
    fn, plan = ts.build_train_step(model, tcfg, P_DATA, "cpu",
                                   lowering=lowering, obs=ob)
    state = ts.init_state(model, tcfg, plan, "cpu")
    for s in range(n):
        state, m = fn(state, synthetic_batch(DATA, s))
    return state, m


def _profiled(fn):
    """fn() under a CPU profiler: its host events as (start, end, name)
    in ns, sorted."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events())


def _inside(outer, events, name):
    return [e for e in events if e[2] == name
            and outer[0] <= e[0] and e[1] <= outer[1]]


@pytest.mark.parametrize("lowering", ["spmd", "manual"])
def test_profiler_records_the_phases_once_a_step(tiny, lowering):
    """Tracer off, a profiler recording: each step's sparcml.step range
    holds one range of each phase, the reduce half the bucket loop's, for
    the stacked step and the manual lowering over StackedCollectives."""
    events = _profiled(lambda: _steps(tiny, 2, lowering))
    steps = [e for e in events if e[2] == "sparcml.step"]
    assert len(steps) == 2
    for name in SPANS[1:]:
        assert sum(e[2] == name for e in events) == 2, name
    for step in steps:
        for name in PHASES:
            assert len(_inside(step, events, name)) == 1, name
        (red,) = _inside(step, events, "sparcml.reduce_half")
        assert len(_inside(red, events, "sparcml.reduce.buckets")) == 1
    assert not [e for e in events if e[2] == "sparcml.alloc_retry"]


def test_off_enters_no_range_and_reads_no_allocator(tiny, monkeypatch):
    """Tracer off and no profiler: the shared null span, no
    record_function entered and no allocator statistics read."""
    def refuse(*a, **k):
        raise AssertionError("entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(ts, "_alloc_retries", refuse)
    assert obs.OFF.span("sparcml.step") is trace._NULL_SPAN
    assert trace.NULL_TRACER.span("x") is trace._NULL_SPAN
    obs.OFF.instant("sparcml.alloc_retry")
    _, m = _steps(tiny, 1)
    assert torch.isfinite(m["loss"]).all()


def test_tracer_events_on_unix_time(tiny):
    """Tracer on: its own events carry the spans' names, once a step,
    nest, and are stamped in Unix microseconds."""
    ob = obs.configure(trace=True, set_as_default=False)
    t0 = time.time_ns() / 1e3
    _steps(tiny, 2, ob=ob)
    t1 = time.time_ns() / 1e3
    evs = ob.tracer.events
    assert sorted(e["name"] for e in evs) == sorted(SPANS * 2)
    assert trace.validate_span_tree(evs) == []
    assert all(t0 - 1e6 <= e["ts"] and e["ts"] + e["dur"] <= t1 + 1e6
               for e in evs)


@pytest.mark.parametrize("traced", [False, True])
def test_an_allocator_retry_marks_its_phase(tiny, monkeypatch, traced):
    """A faked allocator count that rises inside the reduce half gives
    exactly one sparcml.alloc_retry marker, inside that phase: in the
    profiler's trace, and in the tracer's events when it is on."""
    count = {"n": 0, "reads": 0}
    real = ts.reduce_half

    def reads(dev):
        count["reads"] += 1
        return count["n"]

    def rising(*a, **k):
        out = real(*a, **k)
        count["n"] += 1
        return out

    monkeypatch.setattr(ts, "_alloc_retries", reads)
    monkeypatch.setattr(ts, "reduce_half", rising)
    ob = obs.configure(trace=traced, set_as_default=False)
    events = _profiled(lambda: _steps(tiny, 1, ob=ob))
    assert count["reads"] == 2 * len(PHASES)       # each phase's open, close
    marks = [e for e in events if e[2] == "sparcml.alloc_retry"]
    assert len(marks) == 1
    (red,) = [e for e in events if e[2] == "sparcml.reduce_half"]
    assert red[0] <= marks[0][0] and marks[0][1] <= red[1]
    own = [e for e in ob.tracer.events if e["name"] == "sparcml.alloc_retry"]
    assert [e.get("args") for e in own] == (
        [{"phase": "sparcml.reduce_half"}] if traced else [])
