"""optimizer_half_idle_ms: the card's idle time in the traced window whose
gap began while ``sparcml.optimizer_half`` was the step's open phase on
the host, ms a step (``spans.py``)."""
from portbench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "sparcml.optimizer_half")
