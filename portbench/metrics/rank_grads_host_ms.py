"""rank_grads_host_ms: host time inside the step's ``sparcml.rank_grads``
range (every rank's forward and backward over its microbatches, and the
loss over ranks), ms a step of the traced window (``spans.py``)."""
from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "sparcml.rank_grads")
