"""The program's stages, from its own spans and counter.

`run.py` gives the readers a trace of the device alone, taken with the
program's tracer off.  The readers of the program's stages
(`frontend_ms`, `tb_decode_ms`, `turbo_loop_ms`, `host_reads_per_batch`)
take a stretch of their own once the window has closed, through `of(ctx)`:
the cell's entry is built again on the first CUDA device (the CPU where
there is none), a few batches of the cell's mix are made from the run's
`--seed`, and after two warm calls

- COUNTED batches run untraced while the program's `host_reads` counter
  (`srsran_tpu_torch.runtime.trace.counts`) is read around them;
- STRETCH batches run under `torch.profiler` recording the host and the
  device, with the program's tracer on, so that its spans
  (`record_function` ranges) lie on the timeline of the kernels they
  launched.  One batch runs after the profiler starts and before the
  stretch does: the profiler's first operation holds the host for
  milliseconds.

`by_span` gives each kernel to the innermost program span that launched
it.  The readers depend on the program's span names: `fe.ofdm`,
`fe.chest`, `fe.equalize`, `fe.demap` (front end); `tbd.rate_match`,
`tbd.crc` (TB decode); `tbd.turbo`, `turbo.iter`, `turbo.stop_read` (the
turbo loop).  A program without spans or counter gives None, and the
readers leave their metrics out.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from types import SimpleNamespace

from . import stimuli
from .tracing import SPANS

COUNTED, STRETCH = 20, 10
POOL_BATCHES = 8
# what a kernel launched outside every program span is given to
UNATTRIBUTED = "unattributed"


def of(ctx) -> SimpleNamespace | None:
    """The stretch of the run whose readers share `ctx`, taken on the first
    call: `kernels` [(span, name, seconds)], `totals` {span: seconds},
    `batches` (STRETCH) and `host_reads` (per batch, None without the
    counter); None for a program without spans."""
    if not hasattr(ctx, "stages"):
        ctx.stages = measure(ctx.cfg, ctx.mix, ctx.link, run_seed())
    return ctx.stages


def run_seed(argv=None) -> int:
    """The run's `--seed` (run.py's command line; 0 where there is none)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:] if argv is None else argv)[0].seed


def measure(cfg: dict, mix: dict, link, seed: int) -> SimpleNamespace | None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from srsran_tpu_torch.runtime import trace as program

    if not hasattr(program.tracer, "span"):
        return None
    counts = getattr(program, "counts", None)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cuda = dev.type == "cuda"
    sent = stimuli.draw_tbs(seed, mix["n_tbs"], cfg["grant"]["tbs"])
    clean = torch.from_numpy(stimuli.render(link, cfg, sent)).to(dev)
    pool = stimuli.build_pool(clean, dict(mix, pool_batches=POOL_BATCHES), seed)
    del clean
    fn = link.build_entry(cfg, [dev])
    out = fn(pool[0])
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda) for t in out]
    i = 0

    def step():
        nonlocal i
        for h, t in zip(host, fn(pool[i % len(pool)])):
            h.copy_(t)
        i += 1

    step()
    reads0 = counts().get("host_reads", 0) if counts else 0
    for _ in range(COUNTED):
        step()
    reads = (counts().get("host_reads", 0) - reads0) / COUNTED if counts else None
    act = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=act)
    prof.start()
    program.tracer.enable()
    try:
        step()
        ns0 = time.time_ns()
        for _ in range(STRETCH):
            step()
        ns1 = time.time_ns()
    finally:
        program.tracer.disable()
        program.tracer.clear()
        prof.stop()
    red = by_span(records(prof, ns0, ns1))
    return SimpleNamespace(kernels=red.kernels, totals=red.totals, batches=STRETCH,
                           host_reads=reads)


def _is_launch(name: str) -> bool:
    """A call into the CUDA runtime (`cudaLaunchKernel`, `cudaMemcpyAsync`)
    or driver (`cuLaunchKernel`), by its name."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def records(prof, lo_ns: int, hi_ns: int) -> list:
    """(kind, name, start_s, end_s, correlation id, linked correlation id)
    of every event that overlaps [lo_ns, hi_ns], in seconds from lo_ns.
    kind: "device" (work on the device; its shadows of host ranges are left
    out), "launch" (a call into the CUDA runtime or driver), "span" (a
    host range of `record_function`) or "op" (another host operation)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= lo_ns or a >= hi_ns:
            continue
        name, annotation = e.name(), bool(e.is_user_annotation())
        if str(e.device_type()).endswith("CUDA"):
            if annotation:
                continue
            kind = "device"
        else:
            kind = "span" if annotation else "launch" if _is_launch(name) else "op"
        out.append((kind, name, (a - lo_ns) * 1e-9, (b - lo_ns) * 1e-9, e.correlation_id(),
                    e.linked_correlation_id()))
    return out


def innermost(spans: list, t: float) -> str | None:
    """The name of the latest-opened of the (name, start_s, end_s) ranges
    around t: the innermost, for ranges that nest."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or a >= best[1]):
            best = (name, a)
    return best[0] if best else None


def by_span(records: list) -> SimpleNamespace:
    """The kernels of a stretch (`records`; copies and fills not counted)
    by the innermost program span that launched them: a kernel's launch is
    the runtime call of its correlation id or, failing that, the host
    operation its linked correlation id names; the program's spans are the
    host ranges that are not the benchmark's.  A kernel launched outside
    every program span goes to UNATTRIBUTED.  `kernels` [(span, name,
    seconds)], `totals` {span: seconds}."""
    spans = [(n, a, b) for kind, n, a, b, _c, _l in records if kind == "span" and n not in SPANS]
    launch = {c: a for kind, _n, a, _b, c, _l in records if kind == "launch"}
    host = {c: a for kind, _n, a, _b, c, _l in records if kind in ("op", "span")}
    kernels = []
    totals: dict[str, float] = defaultdict(float)
    for kind, n, a, b, corr, linked in records:
        if kind != "device" or n.startswith(("Memcpy", "Memset")):
            continue
        t = launch.get(corr, host.get(linked))
        owner = (innermost(spans, t) if t is not None else None) or UNATTRIBUTED
        kernels.append((owner, n, b - a))
        totals[owner] += b - a
    return SimpleNamespace(kernels=kernels, totals=dict(totals))
