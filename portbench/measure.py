"""Timing and trace reading on the card.

``time_ms``, ``_union`` and ``_length`` are copies of ``chip_smoke.py``'s;
the spin marker and the rule that a trace counts only if it holds as many
launches of each port kernel as the wrappers counted are its
``kernel_breakdown``'s. The peaks are NVIDIA's data sheet for the H100 SXM
(dense, no sparsity), as ``repro_torch.utils.roofline`` holds them.
"""
from __future__ import annotations

import bisect
import statistics
import subprocess
from dataclasses import dataclass, field

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# the port's kernels, by the name its wrapper counts under -> a part of the
# name the trace gives the kernel
PORT_KERNELS = {"bucket_topk": "bucket_topk",
                "bucket_scatter": "bucket_scatter_sum_kernel",
                "bucket_scatter_sum": "bucket_scatter_sum_kernel",
                "qsgd_pack": "qsgd_pack_grouped_kernel",
                "qsgd_unpack": "qsgd_unpack_grouped_kernel",
                "qsgd_unpack_grouped": "qsgd_unpack_grouped_kernel"}
SPIN = "spin"                       # torch.cuda._sleep's kernel
RANGES = ("bench.batch", "bench.step", "bench.sync")
WINDOW = "bench.window"


def time_ms(torch, fn, reps: int = 3) -> float:
    """Median over ``reps`` runs of CUDA-event time of fn() (after one
    warm-up run)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(merged, lo, hi):
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read ({exc})"
    return smi.stdout.strip().replace("\n", "; ") or "nvidia-smi: no output"


@dataclass
class Trace:
    """What a profiled window holds: its bounds (ns, the benchmark's
    ``bench.window`` range), the device's busy intervals in it (kernels,
    copies, sets, after the spin marker), the device time by kernel name,
    the port kernels' launches found, and the host's ranges and ops."""
    lo: float
    hi: float
    busy: list                       # merged [start, end] ns
    by_name: dict                    # kernel name -> [ns, count]
    port_found: dict                 # trace kernel name -> launches
    marker: bool
    host: list = field(default_factory=list)   # (start, end, name, depth)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return _length(self.busy, self.lo, self.hi) / 1e9

    def kernel_s(self, part: str) -> float:
        """Device seconds of the kernels whose name holds ``part``."""
        return sum(v[0] for k, v in self.by_name.items() if part in k) / 1e9

    def valid(self, launches: dict) -> bool:
        """The spin marker is there, and every port kernel's launches in
        the window equal its wrappers' count."""
        want: dict = {}
        for nm, c in launches.items():
            want[PORT_KERNELS[nm]] = want.get(PORT_KERNELS[nm], 0) + c
        return self.marker and all(self.port_found.get(k, 0) == c
                                   for k, c in want.items())

    def top_ops(self, n: int = 10) -> list:
        ranked = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])
        return [[k[:120], v[0] / 1e9] for k, v in ranked[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time in the window, summed by what the host was doing when
        each gap began: the benchmark's range and the innermost host op
        open then."""
        edges = [[self.lo, self.lo]] + self.busy + [[self.hi, self.hi]]
        ranges = [h for h in self.host if h[2] in RANGES]
        ops = [h for h in self.host if h[2] not in RANGES]
        by: dict = {}
        for (_, a), (b, _) in zip(edges, edges[1:]):
            a, b = max(a, self.lo), min(b, self.hi)
            if b <= a:
                continue
            label = f"{_open(ranges, a, 1)}/{_open(ops, a, 4000)}"[:120]
            by[label] = by.get(label, 0.0) + (b - a) / 1e9
        ranked = sorted(by.items(), key=lambda kv: -kv[1])
        return [[k, v] for k, v in ranked[:n]]


def _open(events: list, t: float, look: int) -> str:
    """The deepest of the last ``look`` events (sorted by start) that
    began by ``t`` and had not ended."""
    i = bisect.bisect_right(events, (t, float("inf")))
    best, depth = "idle host", -1
    for a, b, name, d in events[max(0, i - look):i]:
        if b >= t and d > depth:
            best, depth = name, d
    return best


def port_kernel_s(ctx):
    """The port's four SparCML kernels' device seconds in a run's traced
    window; None without a valid trace or without those kernels."""
    if ctx.trace is None or not ctx.trace_valid or ctx.steps == 0:
        return None
    s = sum(ctx.trace.kernel_s(k) for k in set(PORT_KERNELS.values()))
    return s if s > 0 else None


def read_trace(prof) -> Trace:
    """The profiler's events of the benchmark's window (device events by
    ``device_type``; host ops and the benchmark's own ranges)."""
    events = prof.profiler.kineto_results.events()
    host, device, lo, hi = [], [], None, None
    for e in events:
        start, dur, name = e.start_ns(), e.duration_ns(), e.name()
        if str(e.device_type()).endswith("CUDA"):
            # the benchmark's ranges appear on the device's timeline too
            if not e.is_user_annotation() and name not in RANGES + (WINDOW,):
                device.append((start, start + dur, name))
        elif name == WINDOW:
            lo, hi = start, start + dur
        else:
            host.append((start, start + dur, name))
    if lo is None:
        raise RuntimeError("the trace holds no bench.window range")
    spins = [b for a, b, n in device if SPIN in n and a >= lo]
    mark = max(spins, default=lo)
    by_name: dict = {}
    intervals = []
    for a, b, n in device:
        if a < mark or a > hi:
            continue
        intervals.append((a, b))
        c = by_name.setdefault(n, [0.0, 0])
        c[0] += b - a
        c[1] += 1
    found = {k: sum(v[1] for n, v in by_name.items() if k in n)
             for k in set(PORT_KERNELS.values())}
    host.sort()
    # nesting depth of each host event: how many open events contain it
    nested, open_ends = [], []
    for a, b, n in host:
        while open_ends and open_ends[-1] < a:
            open_ends.pop()
        nested.append((a, b, n, len(open_ends)))
        open_ends.append(b)
        open_ends.sort(reverse=True)
    return Trace(max(lo, mark), hi, _union(intervals), by_name, found,
                 bool(spins), nested)
