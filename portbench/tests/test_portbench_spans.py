"""The span-read per-layer metrics (``spans.py`` and its readers) on a
hand-built trace of two steps: host time inside each range, idle time by
the phase open when each gap began, the allocator markers, and nothing
read from a trace whose ``sparcml.step`` ranges are not the window's
steps."""
import pytest

from portbench import measure, spans
from portbench.run import Context, read_metric
from portbench.tests.test_portbench_trace import _Event, _Prof

STEP_RANGES = [
    # (name, start, end) in ns: step 1
    ("bench.step", 100, 1000), ("sparcml.step", 100, 1000),
    ("sparcml.rank_grads", 120, 400), ("aten::mm", 130, 180),
    ("sparcml.reduce_half", 400, 800), ("sparcml.reduce.buckets", 420, 700),
    ("sparcml.alloc_retry", 790, 795),
    ("sparcml.optimizer_half", 820, 980),
    # step 2
    ("bench.step", 1000, 1900), ("sparcml.step", 1000, 1900),
    ("sparcml.rank_grads", 1010, 1300),
    ("sparcml.reduce_half", 1300, 1600),
    ("sparcml.reduce.buckets", 1310, 1500),
    ("sparcml.optimizer_half", 1600, 1880),
    ("sparcml.alloc_retry", 1870, 1875),
    ("bench.sync", 1900, 2000)]
# the card's kernels: busy [100, 200] [300, 450] [500, 850] [900, 990]
# [1050, 1350] [1400, 1610] [1700, 1890] [1950, 2100]
KERNELS = [(100, 200), (300, 450), (500, 850), (900, 990), (1050, 1350),
           (1400, 1610), (1700, 1890), (1950, 2100)]
# idle gaps by the phase open when each began, ns over the two steps:
# rank grads [200, 300]; reduce half [450, 500] [1350, 1400]; optimizer
# [850, 900] [1610, 1700]; none open [990, 1050] [1890, 1950]
IDLE = {"sparcml.rank_grads": 100, "sparcml.reduce_half": 100,
        "sparcml.optimizer_half": 140, spans.OUTSIDE: 120}
# per step, in ms (ns / 2 steps / 1e6)
WANT = {"rank_grads_host_ms": (280 + 290) / 2e6,
        "reduce_half_host_ms": (400 + 300) / 2e6,
        "bucket_loop_host_ms": (280 + 190) / 2e6,
        "optimizer_half_host_ms": (160 + 280) / 2e6,
        "rank_grads_idle_ms": 100 / 2e6,
        "reduce_half_idle_ms": 100 / 2e6,
        "optimizer_half_idle_ms": 140 / 2e6,
        "alloc_retries_per_step": 1.0}


def _trace(ranges=STEP_RANGES):
    ev = [_Event(measure.WINDOW, 0, 2000, False),
          _Event("at::cuda::spin_kernel(long)", 0, 100, True)]
    ev += [_Event(n, a, b - a, False) for n, a, b in ranges]
    ev += [_Event(n, a, b - a, True, annotation=True) for n, a, b in ranges
           if n.startswith("sparcml.")]         # their device-side copies
    ev += [_Event("gemm", a, b - a, True) for a, b in KERNELS]
    return measure.read_trace(_Prof(ev))


def _ctx(tr, steps=2):
    return Context(trace=tr, trace_valid=True, launches={}, steps=steps,
                   peak_bytes=0, flops_per_step=1.0, sync_bytes={},
                   probes={})


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_against_hand_sums(metric):
    assert read_metric(metric, _ctx(_trace())) == pytest.approx(
        WANT[metric], rel=1e-12)


def test_idle_by_phase_adds_up_to_the_window_idle():
    """The three phases' idle and the idle that began in none add up to
    idle_share x window: every gap is put down to one of them."""
    tr = _trace()
    ctx = _ctx(tr)
    by = spans.idle_by_phase(ctx)
    assert by == pytest.approx({k: v / 1e9 for k, v in IDLE.items()})
    total = tr.window_s - tr.busy_s
    assert sum(by.values()) == pytest.approx(total, rel=1e-12)
    assert sum(by.values()) == pytest.approx(
        read_metric("idle_share", ctx) / 100 * tr.window_s, rel=1e-12)
    per_step = sum(read_metric(m, ctx) for m in (
        "rank_grads_idle_ms", "reduce_half_idle_ms",
        "optimizer_half_idle_ms")) + 1e3 * by[spans.OUTSIDE] / 2
    assert per_step == pytest.approx(1e3 * total / 2, rel=1e-12)


@pytest.mark.parametrize("ranges,steps", [
    (STEP_RANGES, 3),                             # a step without its range
    ([r for r in STEP_RANGES if not r[0].startswith("sparcml.")], 2)],
    ids=["steps-differ", "no-spans"])
def test_readers_need_a_range_for_every_step(ranges, steps):
    """A trace whose sparcml.step ranges are not the window's steps (one
    lost, or a program that records none) reads nothing."""
    ctx = _ctx(_trace(ranges), steps)
    assert spans.idle_by_phase(ctx) is None
    for metric in WANT:
        assert read_metric(metric, ctx) is None, metric
