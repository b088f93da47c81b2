"""rank_grads_ms: CUDA-event time (median of 3) of one ``rank_grads`` call
(every rank's forward and backward over its microbatches) on the window's
last state and a fresh batch, after the window."""


def read(ctx):
    return ctx.probe_ms("rank_grads")
