"""Device milliseconds per batch of the turbo loop's own kernels: those
whose innermost program span is `tbd.turbo` (the set-up of the call and
its hard decision), `turbo.iter` (the interleaving gathers, the sums and
`where`s, the CRC test of each iteration) or `turbo.stop_read` (the
reduction read back), the MAP kernel (`map_window_kernel`, which `map_ms`
reads) left out.  Read from the readers' own stretch (`stages.of`)."""

from .. import stages

SPANS = ("tbd.turbo", "turbo.iter", "turbo.stop_read")


def read(ctx):
    st = stages.of(ctx)
    t = sum(s for span, name, s in st.kernels
            if span in SPANS and "map_window_kernel" not in name) if st else 0.0
    return t * 1e3 / st.batches if t > 0 else None
