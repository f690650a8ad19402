"""The least time of one 4x4 MMSE detection (the program's `mmse4_kernel`)
over a batch: its bytes and its floating-point operations against the
card's published peaks (`yardstick.PEAK_BYTES_S`, `PEAK_FP32_S`).  Kept
with the benchmark, apart from the program."""

from __future__ import annotations

from .yardstick import PEAK_BYTES_S, PEAK_FP32_S

N = 4  # receive antennas, ports and layers
# complex64 operations in real floating-point operations
CMUL, CADD, NORM2 = 6, 2, 3
# an RE reads h (4 x 4) and y (4) complex64, writes x (4) complex64 and csi (4) float32
BYTES_PER_RE = 8 * N * N + 8 * N + 8 * N + 4 * N


def ops_per_re() -> int:
    """Real floating-point operations of one RE's detection, a square root
    or a reciprocal counted as one."""
    pairs = N * (N - 1) // 2
    # G = H W, row by row: each entry N products and N - 1 sums
    fold = N * N * (N * CMUL + (N - 1) * CADD)
    # A's diagonal |g|^2, its upper triangle conj(g_i) g_j and c = G^H y,
    # each summed over the N antennas
    gram = N * (N * NORM2 + pairs * CMUL + N * CMUL) + (N - 1) * (N + 2 * pairs + 2 * N)
    noise = N
    # Cholesky: column j's diagonal (its norms subtracted, a square root and
    # a reciprocal), then each entry below it (products subtracted, scaled)
    chol = 0
    for j in range(N):
        chol += j * (NORM2 + 1) + 2
        chol += (N - 1 - j) * (j * (CMUL + CADD) + 2)
    # forward and back substitution: row i takes i products and differences
    # and one scale, in each direction
    solve = 2 * sum(i * (CMUL + CADD) + 2 for i in range(N))
    # L^-1 below the diagonal: entry (i, col) sums i - col terms, the first
    # a scale, and one more scale; then each column's squared norms, summed,
    # and a reciprocal
    inv = sum(2 + (i - col - 1) * (CMUL + CADD) + 2 for col in range(N) for i in range(col + 1, N))
    csi = sum(1 + (N - 1 - col) * (NORM2 + 1) + 1 for col in range(N))
    return fold + gram + noise + chol + solve + inv + csi


def mmse4_bound(subframes: int, n_re: int) -> tuple[float, str]:
    """(least ms, what bounds it) of one detection over `subframes` of
    `n_re` REs: each input byte read once and each output byte written
    once over the memory rate, or the operations over the float32 rate,
    whichever is larger."""
    res = subframes * n_re
    t_bytes = res * BYTES_PER_RE / PEAK_BYTES_S * 1e3
    t_ops = res * ops_per_re() / PEAK_FP32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
