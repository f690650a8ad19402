"""The 4x4 MMSE kernel's share of its roofline: the least time of one
detection over the batch's REs (`mmse4_yardstick.mmse4_bound`: 208 bytes
an RE over the card's memory rate, its operations over the float32 rate,
whichever is larger) over the measured mean time of one launch of
`mmse4_kernel` (by name, from the device trace), in percent.  None where
the trace holds no such kernel."""

from .. import mmse4_yardstick


def read(ctx):
    times = [b - a for name, a, b in ctx.trace.kernels if "mmse4_kernel" in name]
    if not times:
        return None
    subframes, n_re = ctx.link.mmse_shape(ctx.cfg, ctx.mix["batch"])
    bound_ms, _by = mmse4_yardstick.mmse4_bound(subframes, n_re)
    return 100.0 * bound_ms / (sum(times) / len(times) * 1e3)
