"""Device milliseconds per batch of the cuFFT kernels (by name): the OFDM
and SC-FDMA demodulators of the front end."""


def read(ctx):
    t = sum(b - a for name, a, b in ctx.trace.kernels if "fft" in name.lower())
    return t * 1e3 / ctx.trace.batches if t > 0 else None
