"""MAP kernel launches per batch, from the program's launch counter: two
per turbo iteration, so twice the iterations the slowest code block of the
batch needs."""


def read(ctx):
    return ctx.launches / ctx.trace.batches if ctx.launches else None
