"""Reading a profiler trace: busy and idle time within the benchmark's
window (after the spin marker, the benchmark's own ranges left out), the
port kernels' launches against the wrappers' counters, and idle time by
what the host was in when each gap began."""
import pytest

from portbench import measure


class _Event:
    def __init__(self, name, start, dur, cuda, annotation=False):
        self._v = (name, start, dur, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})()})()


def _trace():
    ev = [_Event(measure.WINDOW, 0, 1000, False),
          _Event(measure.WINDOW, 0, 1000, True, annotation=True),
          _Event("bench.step", 100, 700, False),
          _Event("aten::mm", 150, 50, False),
          _Event("bench.sync", 850, 150, False),
          _Event("cudaDeviceSynchronize", 860, 140, False),
          _Event("at::cuda::spin_kernel(long)", 0, 100, True),
          _Event("bucket_topk_kernel(float const*)", 100, 100, True),
          _Event("bucket_topk_kernel(float const*)", 150, 100, True),
          _Event("gemm", 400, 200, True),
          _Event("ncclDevKernel_SendRecv", 900, 50, True)]
    return measure.read_trace(_Prof(ev))


def test_busy_idle_and_kernels():
    tr = _trace()
    assert tr.marker and tr.lo == 100 and tr.hi == 1000
    assert tr.window_s == pytest.approx(900e-9)
    # busy: [100, 250] + [400, 600] + [900, 950]
    assert tr.busy_s == pytest.approx(400e-9)
    assert tr.kernel_s("bucket_topk") == pytest.approx(200e-9)
    assert tr.kernel_s("nccl") == pytest.approx(50e-9)
    assert tr.valid({"bucket_topk": 2})
    assert not tr.valid({"bucket_topk": 3})


def test_idle_gaps_by_host_range():
    gaps = dict(_trace().idle_gaps())
    # [250, 400] and [600, 900] began in bench.step, [950, 1000] in
    # bench.sync's device synchronise
    assert gaps == pytest.approx({"bench.step/idle host": 450e-9,
                                  "bench.sync/cudaDeviceSynchronize": 50e-9})
