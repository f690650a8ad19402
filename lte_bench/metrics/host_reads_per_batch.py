"""The program's `host_reads` counter (`srsran_tpu_torch.runtime.trace`)
per batch over the untraced batches of the readers' own stretch
(`stages.of`): the times the host waited for the device inside a call,
each `turbo.stop_read` of the turbo loop among them."""

from .. import stages


def read(ctx):
    st = stages.of(ctx)
    return st.host_reads if st else None
