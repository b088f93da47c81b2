"""sync_kernels_roofline: the least time of the four SparCML kernels' work
(the bytes they must move, ``counts.sync_bytes``, over the card's memory
bandwidth; their FLOPs are a few a byte) over their profiler device time
in the traced window."""
from portbench.measure import PEAK_HBM_BYTES, port_kernel_s


def read(ctx):
    s = port_kernel_s(ctx)
    if s is None:
        return None
    least = sum(ctx.sync_bytes.values()) * ctx.steps / PEAK_HBM_BYTES
    return 100.0 * least / s
