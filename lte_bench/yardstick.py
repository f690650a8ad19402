"""The benchmark's fixed arithmetic: the card's published peaks, the least
time of one MAP pass, and the reduction of a profiler trace to device
intervals, busy time and idle gaps.  Frozen here, apart from the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_BYTES_S = 3.35e12  # HBM3
PEAK_FP32_S = 67e12  # float32 outside the tensor cores
# add/max operations one position of a code block needs in one max-log-MAP
# pass: an alpha step (26), the beta branches (18) and their maxima (8),
# and the posterior (16 + 14 + 1)
OPS_PER_POSITION = 83


def map_bound(codeblocks: int, k: int) -> tuple[float, str]:
    """(least ms, what bounds it) of one constituent MAP pass over
    `codeblocks` blocks of K: the larger of the bytes it must move (the
    systematic-plus-a-priori and parity LLRs and the 8 tail metrics read
    once, the posteriors written once, float32) over the memory rate and
    the add/max operations its positions need over the float32 rate."""
    nbytes = 4 * codeblocks * (3 * k + 8)
    ops = codeblocks * k * OPS_PER_POSITION
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def union_s(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by the union of the intervals (seconds)."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end and a <= hi:
            out.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out
