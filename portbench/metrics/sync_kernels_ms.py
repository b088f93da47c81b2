"""sync_kernels_ms: profiler device time of the four SparCML kernels over
the traced window, a step; only from a trace whose launches of the port's
kernels equal the wrappers' counters."""
from portbench.measure import port_kernel_s


def read(ctx):
    s = port_kernel_s(ctx)
    return None if s is None else 1e3 * s / ctx.steps
