"""Device milliseconds per batch of the kernels whose innermost program
span is TB decode's own (`tbd.rate_match`, `tbd.crc`): the layout,
de-rate-matching, the filler writes and the stacking of the code blocks,
the code-block and TB CRCs and the reassembly.  Read from the readers' own
stretch (`stages.of`)."""

from .. import stages

SPANS = ("tbd.rate_match", "tbd.crc")


def read(ctx):
    st = stages.of(ctx)
    t = sum(s for span, _name, s in st.kernels if span in SPANS) if st else 0.0
    return t * 1e3 / st.batches if t > 0 else None
