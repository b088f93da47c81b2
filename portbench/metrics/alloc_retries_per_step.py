"""alloc_retries_per_step: the CUDA caching allocator's retries inside the
step's phases (each a synchronise and a flush of its cache), counted by
the step's ``sparcml.alloc_retry`` markers in the traced window, a step
(``spans.py``)."""
from portbench.spans import per_step


def read(ctx):
    return per_step(ctx, "sparcml.alloc_retry")
