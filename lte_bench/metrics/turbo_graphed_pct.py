"""Share of the turbo loop's iterations that a CUDA graph replayed, in %:
the program's counters `turbo_graph_replays` over `turbo_iterations`
(`srsran_tpu_torch.runtime.trace.counts`), over the whole run (warm calls,
window and the readers' stretch).  None for a program without these
counters."""


def read(ctx):
    from srsran_tpu_torch.runtime import trace

    counts = getattr(trace, "counts", None)
    got = counts() if counts else {}
    iterations = got.get("turbo_iterations", 0)
    return 100.0 * got.get("turbo_graph_replays", 0) / iterations if iterations else None
