"""The DL entries' steps and their CUDA-graph machinery (`srsran_tpu_torch
.graphs`) on the CPU; `tests/test_torch_entry_graph_card.py` holds the
replays to the eager entries on the card.

- TB decode's stages composed by hand (`sch.dlsch_rate_match` per (K, CRC)
  group, `dlsch_turbo`, then `dlsch_crc`) give `dlsch_decode_multi_device`'s
  TB bits and CRC flags bit for bit, on the benchmark's codings (DL SISO,
  the 2x2's two codewords, the UL) and on a TB of two code-block sizes.
  Each batch holds a subframe that decodes after some iterations and one
  that fails.
- The DL entries run eagerly on the CPU: they count their calls in
  `entry_calls`, no replay, and keep no graphs; the UL entry counts its
  calls too.
- `graphs.Cache` makes nothing on a key's first call and keeps the keys
  used last; `_owned` copies a view without aliasing it; `device.pinned`
  collects the tables a step reads, which a graph of it holds.
"""

import numpy as np
import pytest
import torch

from srsran_tpu_torch import graphs, pipeline
from srsran_tpu_torch.device import pinned, table
from srsran_tpu_torch.phy.chest.chest_dl import ChestDlConfig, _device_tables
from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.phy.fec.turbo import turbo_decode
from srsran_tpu_torch.phy.modem import Mod
from srsran_tpu_torch.phy.ofdm import OfdmConfig, _window_index
from srsran_tpu_torch.phy.phch import ra, sch
from srsran_tpu_torch.phy.phch.pdsch import DlGrant, DlGrant2, pdsch_re_indices
from srsran_tpu_torch.phy.phch.pusch import UlGrant
from srsran_tpu_torch.runtime.trace import counts

torch.set_num_threads(1)

CELL = Cell(nof_prb=100, nof_ports=1, id=301)
N_RE = pdsch_re_indices(CELL, 2, 1, tuple(range(100))).size  # the DL cells' PDSCH REs
# (codings, noise sigma of each subframe): the first decodes, the second fails
CODINGS = {
    "dl_siso": ((sch.TbCoding(61664, N_RE * 6, 6),), (0.55, 0.8)),
    "dl_2x2": ((sch.TbCoding(61664, N_RE * 6, 6), sch.TbCoding(61664, N_RE * 6, 6)),
               (0.55, 0.8)),
    "ul": ((sch.TbCoding(40576, 12 * 96 * 12 * 4, 4),), (0.5, 0.8)),
    "two_sizes": ((sch.TbCoding(9024, 25 * 12 * 10 * 6, 6),), (0.7, 0.95)),
}


def _llrs(codings, sigmas, seed):
    """Per codeword, (B, g) LLRs of B = len(sigmas) random TBs at those
    noise levels (positive = bit 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for c in codings:
        rows = []
        for sig in sigmas:
            cw = sch.dlsch_encode_np(rng.integers(0, 2, c.tbs).astype(np.uint8), c)
            rows.append((2.0 * cw - 1.0) + rng.normal(0, sig, cw.shape))
        out.append(torch.from_numpy(np.stack(rows).astype(np.float32)))
    return out


@pytest.mark.parametrize("name", list(CODINGS))
def test_split_stages_compose_to_the_decode(name):
    codings, sigmas = CODINGS[name]
    llrs = _llrs(codings, sigmas, seed=len(name))
    groups, _where = sch._cb_groups(codings)
    assert len(groups) == (2 if name == "two_sizes" else 1)
    bits = []
    for gi in range(len(groups)):
        d = sch.dlsch_rate_match(llrs, codings, gi)
        assert d.shape == (len(sigmas) * len(groups[gi][1]), 3, groups[gi][0][0] + 4)
        bits.append(sch.dlsch_turbo(d, codings, gi, 6))
    composed = sch.dlsch_crc(bits, codings)
    want = sch.dlsch_decode_multi_device(llrs, list(codings), 6)
    assert len(composed) == len(want) == len(codings)
    for (tb, ok), (w_tb, w_ok) in zip(composed, want):
        assert tb.dtype == torch.uint8 and ok.dtype == torch.bool
        assert torch.equal(tb, w_tb) and torch.equal(ok, w_ok)
        assert ok.tolist() == [True, False]


def test_dlsch_turbo_is_the_grouped_turbo_decode():
    """The turbo stage of a group is `turbo_decode` at the group's K with
    its CRC matrix."""
    codings, sigmas = CODINGS["two_sizes"]
    llrs = _llrs(codings, sigmas, seed=3)
    for gi, ((k, poly), _members) in enumerate(sch._cb_groups(codings)[0]):
        d = sch.dlsch_rate_match(llrs, codings, gi)
        want, _post, _n = turbo_decode(d, k, 6, crc_table=sch.crc_table(poly, k, d.device))
        assert torch.equal(sch.dlsch_turbo(d, codings, gi, 6), want)


def _dl_entries():
    cell = Cell(nof_prb=6, nof_ports=2, id=7)
    prb = tuple(range(6))
    siso = pipeline.ue_dl_subframe(cell, 2, 1, DlGrant(prb=prb, mod=Mod.QPSK, tbs=504,
                                                       tx_scheme="diversity"), 4, device="cpu")
    mimo = pipeline.ue_dl_subframe_mimo(cell, 2, 1, DlGrant2(prb=prb, mod1=Mod.QPSK, tbs1=504,
                                                             mod2=Mod.QPSK, tbs2=504, pmi=1),
                                        4, device="cpu")
    x = torch.randn((2, 2, cell.sf_len), dtype=torch.complex64,
                    generator=torch.Generator().manual_seed(5))
    return [siso, mimo], x


def test_dl_entries_run_eagerly_on_the_cpu():
    entries, x = _dl_entries()
    for fn in entries:
        before = counts()
        first, second = fn(x), fn(x)
        after = counts()
        assert after["entry_calls"] - before.get("entry_calls", 0) == 2
        assert after.get("entry_graph_replays", 0) == before.get("entry_graph_replays", 0)
        flat = [torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(first),
                                                  torch.utils._pytree.tree_leaves(second))]
        assert flat and all(flat)
    assert torch.device("cpu") not in graphs.ENTRIES.by_device


def test_ul_entry_counts_its_calls():
    cell = Cell(nof_prb=6, id=301)
    grant = UlGrant(prb_start=1, nof_prb=4, mod=ra.ul_mcs_to_mod(6),
                    tbs=ra.tbs_lookup(ra.ul_mcs_to_itbs(6), 4), rnti=0x46)
    fn = pipeline.enb_ul_subframe(cell, 2, grant, 4, device="cpu")
    before = counts()
    fn(torch.zeros((1, 1, cell.sf_len), dtype=torch.complex64))
    after = counts()
    assert after["entry_calls"] - before.get("entry_calls", 0) == 1
    assert after.get("entry_graph_replays", 0) == before.get("entry_graph_replays", 0)


def test_cache_makes_on_the_second_call_and_keeps_the_last_used():
    cache = graphs.Cache(per_device=2, seen=3)
    dev = torch.device("cpu")
    made = []

    def make(key):
        return lambda: made.append(key) or f"held {key}"

    assert cache.get(dev, "a", make("a")) is None and not made
    assert cache.get(dev, "a", make("a")) == "held a" and made == ["a"]
    assert cache.get(dev, "a", make("a")) == "held a" and made == ["a"]
    for key in "bc":
        assert cache.get(dev, key, make(key)) is None
        assert cache.get(dev, key, make(key)) == f"held {key}"
    assert list(cache.by_device[dev]) == ["b", "c"]  # "a", used first, dropped
    assert cache.get(dev, "a", make("a")) is None  # seen anew after its drop
    for key in "defg":  # only the `seen` keys met last are remembered
        cache.get(dev, key, make(key))
    assert cache.get(dev, "d", make("d")) is None


def test_owned_copies_a_view_without_aliasing_it():
    base = torch.arange(24, dtype=torch.uint8).reshape(4, 6)
    view = base[:, :4]
    got = graphs._owned(view)
    assert torch.equal(got, view) and got.stride() == view.stride()
    assert got.untyped_storage().data_ptr() != base.untyped_storage().data_ptr()
    base.zero_()
    assert int(got.sum()) > 0
    plain = torch.ones(3)
    assert torch.equal(graphs._owned(plain), plain)


def test_pinned_collects_the_tables_a_step_reads():
    """`device.pinned` around the DL front end's steps collects the tables
    they fetch as they run, the OFDM window index and the CRS estimator's
    among them (the RE index, fetched when the steps are built, lives in
    them); a block inside another collects into its own list."""
    cell = Cell(nof_prb=6, id=7)
    cpu = torch.device("cpu")
    n_re, steps = pipeline._dl_front_end(cell, 2, 1, tuple(range(6)), 1, cpu)
    state = {"samples": torch.zeros((2, 1, cell.sf_len), dtype=torch.complex64)}
    window = table(_window_index, OfdmConfig.from_cell(cell, normalize=True), device=cpu)
    with pinned() as outer:
        idx = table(pdsch_re_indices, cell, 2, 1, tuple(range(6)), device=cpu,
                    dtype=torch.int64)
        with pinned() as inner:
            graphs.run(steps, state)
    assert idx.numel() == n_re and outer == [idx]
    crs = table(_device_tables, cell, 2, ChestDlConfig(), 0, None, device=cpu)
    assert any(t is window for t in inner) and any(t is crs for t in inner)
    with pinned() as none:
        pass
    assert none == []
    table(_window_index, OfdmConfig.from_cell(cell, normalize=True), device=cpu)
    assert outer == [idx]  # nothing collects outside a block
