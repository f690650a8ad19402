"""The share of the traced stretch in which no operation ran on the card,
in percent: 1 - the union of the device's operation intervals over the
stretch's length."""


def read(ctx):
    if not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
