"""Share of the entry point's calls that replayed CUDA graphs, in %: the
program's counters `entry_graph_replays` over `entry_calls`
(`srsran_tpu_torch.runtime.trace.counts`), over the whole run (warm calls,
window and the readers' stretch).  None for a program without these
counters."""


def read(ctx):
    from srsran_tpu_torch.runtime import trace

    counts = getattr(trace, "counts", None)
    got = counts() if counts else {}
    calls = got.get("entry_calls", 0)
    return 100.0 * got.get("entry_graph_replays", 0) / calls if calls else None
