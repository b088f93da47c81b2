"""The port's ``sparcml.*`` spans in a traced window: the arithmetic the
span-read per-layer metrics share.

While a ``torch.profiler`` session records, the port's SparCML training
step (``repro_torch/train/train_step.py``) enters a profiler range for
each of its phases: ``sparcml.step`` around the step and, in it,
``sparcml.rank_grads``, ``sparcml.reduce_half`` (around the executor's
bucket loop, ``sparcml.reduce.buckets``) and ``sparcml.optimizer_half``;
a phase in which the CUDA allocator retried allocations closes with a
zero-length ``sparcml.alloc_retry`` range for each retry. The profiler
stamps them on the clock it lays the device's kernels on, so they are
read from the trace's host events as they are. A trace without them (a
program that records none), or with another number of ``sparcml.step``
ranges than the window's steps, reads nothing (None).
"""
from __future__ import annotations

from portbench.measure import _length, _open, _union

STEP = "sparcml.step"
PHASES = ("sparcml.rank_grads", "sparcml.reduce_half",
          "sparcml.optimizer_half")
OUTSIDE = "outside"                  # idle that began in no phase


def events(ctx, name: str):
    """The trace's host events named ``name``, (start, end, name, depth)
    in ns sorted by start; None without a trace or when the number of
    ``sparcml.step`` ranges is not the window's steps."""
    tr = ctx.trace
    if tr is None or not ctx.steps:
        return None
    if sum(h[2] == STEP for h in tr.host) != ctx.steps:
        return None
    return [h for h in tr.host if h[2] == name]


def host_ms(ctx, name: str):
    """Host time inside the ranges named ``name``, ms a step."""
    evs = events(ctx, name)
    if evs is None:
        return None
    inside = _union([(a, b) for a, b, _, _ in evs])
    return _length(inside, float("-inf"), float("inf")) / 1e6 / ctx.steps


def per_step(ctx, name: str):
    """The ranges named ``name`` a step."""
    evs = events(ctx, name)
    return None if evs is None else len(evs) / ctx.steps


def idle_by_phase(ctx):
    """Device idle in the window, in seconds, by the phase open on the
    host when each gap began (``idle_gaps``' rule; ``OUTSIDE`` when none
    was: the batch, the step's other lines, the final synchronise)."""
    found = [events(ctx, name) for name in PHASES]
    if None in found:
        return None
    phases = sorted(e for evs in found for e in evs)
    tr = ctx.trace
    edges = [[tr.lo, tr.lo]] + tr.busy + [[tr.hi, tr.hi]]
    by = dict.fromkeys(PHASES + (OUTSIDE,), 0.0)
    for (_, a), (b, _) in zip(edges, edges[1:]):
        a, b = max(a, tr.lo), min(b, tr.hi)
        if b <= a:
            continue
        label = _open(phases, a, len(phases))
        by[label if label in by else OUTSIDE] += (b - a) / 1e9
    return by


def idle_ms(ctx, name: str):
    """Device idle that began while phase ``name`` was open, ms a step."""
    by = idle_by_phase(ctx)
    return None if by is None else 1e3 * by[name] / ctx.steps
