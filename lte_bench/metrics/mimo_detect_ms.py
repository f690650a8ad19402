"""Device milliseconds per batch of the kernels whose innermost program
span is `fe.mimo`: the precoder fold, the 2x2 MMSE solve with its CSI and
the layer demapping of the 2x2 decode, inside `fe.equalize`.  Read from
the readers' own stretch (`stages.of`); None for a program that has no
such span."""

from .. import stages


def read(ctx):
    st = stages.of(ctx)
    t = sum(s for span, _name, s in st.kernels if span == "fe.mimo") if st else 0.0
    return t * 1e3 / st.batches if t > 0 else None
