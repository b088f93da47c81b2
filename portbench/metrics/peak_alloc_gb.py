"""peak_alloc_gb: the CUDA caching allocator's peak of allocated bytes
(``torch.cuda.max_memory_allocated``), from the state's creation through
the window, in GB: the state, the activations and the sync's
temporaries, and the port's garbage that Python's collector has not
freed yet."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 1e9
