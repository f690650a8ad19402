"""Device milliseconds per batch of the kernels whose innermost program
span is a front-end stage (`fe.ofdm`, `fe.chest`, `fe.equalize`,
`fe.demap`): demodulation, channel estimation, the RE gathers, MRC and the
DFT de-spreading, the demapper, CSI weighting, descrambling and the UL
de-interleaving.  Read from the readers' own stretch (`stages.of`)."""

from .. import stages


def read(ctx):
    st = stages.of(ctx)
    t = sum(s for span, _name, s in st.kernels if span.startswith("fe.")) if st else 0.0
    return t * 1e3 / st.batches if t > 0 else None
