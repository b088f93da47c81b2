"""bucket_loop_host_ms: host time inside the executor's
``sparcml.reduce.buckets`` range (the loop over the plan's buckets: pack,
EF add, top-k, the residual), ms a step of the traced window
(``spans.py``)."""
from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "sparcml.reduce.buckets")
