"""step_mfu: the configuration's model FLOPs of every step in the traced
window over the window's seconds, as a share of the card's dense bf16
peak (``counts.step_flops``; ``measure.PEAK_BF16_FLOPS``)."""
from portbench.measure import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.trace is None or ctx.steps == 0:
        return None
    return (100.0 * ctx.flops_per_step * ctx.steps / ctx.trace.window_s
            / PEAK_BF16_FLOPS)
