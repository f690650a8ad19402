"""Reduction of `torch.profiler` traces of stretches of batches.

A traced run makes two stretches.  The first records the device alone
(CUDA activity), which slows the host least: the device's operations as
intervals, its busy time over the stretch, and the operations that took
most time.  The second also records the host's operations and the
benchmark's spans, to say what the host was doing in the longest idle
gaps.  Each stretch is bounded by host clock readings (`time.time_ns()`),
on which the profiler also stamps its events.
"""

from __future__ import annotations

from collections import defaultdict
from types import SimpleNamespace

from . import yardstick

SPANS = ("pool_step", "entry", "result_read")
# profiler bookkeeping on the host, not work of the run
NOT_WORK = ("Activity Buffer Request",)


def _events(prof, lo_ns: int, hi_ns: int):
    """(name, on the device, start_s, end_s, user annotation) of every event
    that overlaps [lo_ns, hi_ns], in seconds from lo_ns."""
    out = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if b > lo_ns and a < hi_ns:
            out.append((e.name(), str(e.device_type()).endswith("CUDA"), (a - lo_ns) * 1e-9,
                        (b - lo_ns) * 1e-9, bool(e.is_user_annotation())))
    return out


def _device(ev):
    # the spans' shadows on the device timeline are annotations, not work
    return [(n, a, b) for n, dev, a, b, u in ev if dev and not u and n not in SPANS]


def reduce(prof, batches: int, lo_ns: int, hi_ns: int) -> SimpleNamespace:
    """The device-only stretch [lo_ns, hi_ns] of `batches` batches:
    `kernels` [(name, start_s, end_s)] (CUDA kernels), `device` (every
    device operation, copies and fills too), `window_s`, `busy_s` and
    `device_ops` ([name, seconds], the 10 that took most time)."""
    hi = (hi_ns - lo_ns) * 1e-9
    device = _device(_events(prof, lo_ns, hi_ns))
    by_name: dict[str, float] = defaultdict(float)
    for n, a, b in device:
        by_name[n] += min(b, hi) - max(a, 0.0)
    return SimpleNamespace(
        batches=batches, window_s=hi, device=device,
        kernels=[d for d in device if not d[0].startswith(("Memcpy", "Memset"))],
        busy_s=yardstick.union_s([(a, b) for _n, a, b in device], 0.0, hi),
        device_ops=[[n[:200], t] for n, t in sorted(by_name.items(), key=lambda x: -x[1])[:10]])


def idle_gaps(prof, lo_ns: int, hi_ns: int) -> list:
    """The 10 longest stretches of [lo_ns, hi_ns] in which the device ran
    nothing, as [label, seconds]: the benchmark's span and the innermost
    host operation at the gap's middle."""
    ev = _events(prof, lo_ns, hi_ns)
    hi = (hi_ns - lo_ns) * 1e-9
    host = [(n, a, b) for n, dev, a, b, _u in ev if not dev and n not in NOT_WORK]

    def label(t: float) -> str:
        inside = [h for h in host if h[1] <= t <= h[2]]
        span = [h[0] for h in inside if h[0] in SPANS]
        ops = [h for h in inside if h[0] not in SPANS]
        name = span[0] if span else "between spans"
        if ops:
            name += ": " + max(ops, key=lambda h: h[1])[0]
        return name[:200]

    gaps = yardstick.gaps([(a, b) for _n, a, b in _device(ev)], 0.0, hi)
    return [[label(0.5 * (a + b)), b - a] for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]]
