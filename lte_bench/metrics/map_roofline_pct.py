"""The MAP kernel's share of its roofline: the least time of one pass over
the batch's code blocks (`yardstick.map_bound`: bytes over the card's
memory rate, add/max operations over its float32 rate, whichever is
larger) over the measured mean time of one launch, in percent."""

from .. import yardstick


def read(ctx):
    times = [b - a for name, a, b in ctx.trace.kernels if "map_window_kernel" in name]
    if not times:
        return None
    codeblocks, k = ctx.link.map_launch_shape(ctx.cfg, ctx.mix["batch"])
    bound_ms, _by = yardstick.map_bound(codeblocks, k)
    return 100.0 * bound_ms / (sum(times) / len(times) * 1e3)
