"""reduce_half_ms: CUDA-event time (median of 3) of one ``reduce_half``
call (EF add, top-k, the sum over ranks, QSGD) on one ``rank_grads``
call's gradients and the window's last residuals, after the window."""


def read(ctx):
    return ctx.probe_ms("reduce_half")
