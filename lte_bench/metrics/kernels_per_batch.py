"""CUDA kernels launched per batch over the traced stretch (copies and
fills not counted): the host-dispatch cost of the entry point."""


def read(ctx):
    n = len(ctx.trace.kernels)
    return n / ctx.trace.batches if n else None
