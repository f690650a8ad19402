"""4x4 MMSE detections per batch: the program's counter `mmse4_launches`
over its `entry_calls` (`srsran_tpu_torch.runtime.trace.counts`), over the
whole run, an entry call being one batch; a replayed CUDA graph counts the
launches it holds.  1.0 where every call detects through the kernel (a
little above: a capture call also runs its step once eagerly).  None for a
program without the counter."""


def read(ctx):
    from srsran_tpu_torch.runtime import trace

    counts = getattr(trace, "counts", None)
    got = counts() if counts else {}
    calls = got.get("entry_calls", 0)
    return got["mmse4_launches"] / calls if calls and got.get("mmse4_launches") else None
