"""reduce_half_host_ms: host time inside the step's ``sparcml.reduce_half``
range (the executor: its bucket loop, then the grouped densify + sum, pack
and unpack), ms a step of the traced window (``spans.py``)."""
from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "sparcml.reduce_half")
