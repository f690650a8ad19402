"""On the card only (`pytest lte_bench/tests -m card` on the chip): the
program's `host_reads` counter misses no sync of the benchmarked entries,
and the readers' own stretch finds the program's spans."""

from __future__ import annotations

import warnings

import pytest

from lte_bench import catalog, stages, stimuli
from lte_bench.tests.small import REPO


@pytest.mark.card
@pytest.mark.parametrize("cell", catalog.cells(REPO))
def test_host_reads_count_every_sync(cuda_device, cell):
    """One call of the cell's entry under `torch.cuda.set_sync_debug_mode`:
    every operation that makes the host wait for the device warns, and the
    program's `host_reads` counter rises by as many."""
    import torch

    from srsran_tpu_torch.runtime import trace

    _w, cfg, mix = catalog.cell(REPO, cell)
    link = catalog.link(cfg)
    sent = stimuli.draw_tbs(2**31 + 11, mix["n_tbs"], cfg["grant"]["tbs"])
    clean = torch.from_numpy(stimuli.render(link, cfg, sent)).to(cuda_device)
    x = stimuli.build_pool(clean, dict(mix, pool_batches=2), 2**31 + 11)[1]
    fn = link.build_entry(cfg, [cuda_device])
    fn(x)  # warm: tables, plans and the MAP kernel built outside the count
    torch.cuda.synchronize(cuda_device)
    reads0 = trace.counts().get("host_reads", 0)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reads = trace.counts()["host_reads"] - reads0
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == reads, syncs
    assert reads >= 2 and bool(out[1].any())


@pytest.mark.card
@pytest.mark.parametrize("cell", ["dl_siso-b128-n090", "ul_pusch-b128-n090"])
def test_stretch_finds_every_span(cuda_device, cell):
    """The readers' stretch gives kernels to every span of the benchmarked
    entries, and at most 5% of its kernel time to none."""
    _w, cfg, mix = catalog.cell(REPO, cell)
    st = stages.measure(cfg, mix, catalog.link(cfg), 2**31 + 13)
    spans = {"fe.ofdm", "fe.chest", "fe.equalize", "fe.demap", "tbd.rate_match", "tbd.turbo",
             "tbd.crc", "turbo.iter", "turbo.stop_read"}
    assert spans <= set(st.totals), sorted(st.totals)
    assert st.totals.get(stages.UNATTRIBUTED, 0.0) <= 0.05 * sum(st.totals.values())
