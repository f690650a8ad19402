"""The benchmark's fixed arithmetic."""

from __future__ import annotations

import pytest

from lte_bench import yardstick
from lte_bench.links import pdsch_siso, pusch
from lte_bench.tests.test_lte_bench_reference import CFG


@pytest.mark.parametrize("link, cfg, shape, mbytes", [
    (pdsch_siso, "lte20_fdd_dl_siso", (1408, 5632), 95.2),
    (pusch, "lte20_fdd_ul_pusch", (896, 5824), 62.6)])
def test_map_bound(link, cfg, shape, mbytes):
    """One pass over a batch of 128 TBs: 1408 x 5632 (DL) and 896 x 5824 (UL)
    code blocks, 95 MB and 63 MB, bound by bytes."""
    assert link.map_launch_shape(CFG[cfg], 128) == shape
    ms, by = yardstick.map_bound(*shape)
    assert by == "bytes"
    assert ms == pytest.approx(mbytes * 1e6 / yardstick.PEAK_BYTES_S * 1e3, rel=1e-3)


def test_union_and_gaps():
    iv = [(0.1, 0.3), (0.2, 0.4), (0.6, 0.7), (0.9, 1.2)]
    assert yardstick.union_s(iv, 0.0, 1.0) == pytest.approx(0.5)
    assert yardstick.gaps(iv, 0.0, 1.0) == pytest.approx([(0.0, 0.1), (0.4, 0.6), (0.7, 0.9)])
    assert yardstick.union_s([], 0.0, 1.0) == 0.0 and yardstick.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_kernel_readers_take_their_kernels_by_name():
    """Each reader of device time sums its own kernels per batch and reads
    nothing where the stretch holds none of them."""
    from types import SimpleNamespace

    from lte_bench.metrics import cgemm_ms, fft_ms, map_ms

    kernels = [("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nn_n_tilesize64x64x8", 0.0, 0.004),
               ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8", 0.004, 0.005),
               ("void regular_fft<1024u>", 0.005, 0.0052),
               ("void (anonymous namespace)::map_window_kernel<false>(float const*)", 0.006, 0.007)]
    ctx = SimpleNamespace(trace=SimpleNamespace(kernels=kernels, batches=2))
    assert cgemm_ms.read(ctx) == pytest.approx(2.0)
    assert fft_ms.read(ctx) == pytest.approx(0.1)
    assert map_ms.read(ctx) == pytest.approx(0.5)
    empty = SimpleNamespace(trace=SimpleNamespace(kernels=kernels[1:2], batches=2))
    assert cgemm_ms.read(empty) is None and fft_ms.read(empty) is None and map_ms.read(empty) is None
