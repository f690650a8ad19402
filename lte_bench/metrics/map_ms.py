"""Device milliseconds per batch of the MAP kernel (`map_window_kernel`)."""


def read(ctx):
    t = sum(b - a for name, a, b in ctx.trace.kernels if "map_window_kernel" in name)
    return t * 1e3 / ctx.trace.batches if t > 0 else None
