"""optimizer_half_host_ms: host time inside the step's
``sparcml.optimizer_half`` range (the reduced buckets back into leaves,
the clip and the ZeRO-1 AdamW update), ms a step of the traced window
(``spans.py``)."""
from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "sparcml.optimizer_half")
