#!/usr/bin/env python
"""Build the stimulus fixtures of the PyTorch port from the JAX reference,
on the CPU: the UE DL SISO one, the dynamic-grant one, the 2x2 MIMO, eNB UL
and dynamic eNB UL ones, and one stored window per windowed decode engine.

The configuration is the repo's headline row (`bench.py` `bench_ue_dl_siso`):
20 MHz (100 PRB), cell 301, subframe 2, CFI 1, MCS 26 QAM64, port 0.  The
transmit side is the reference's own (`pdsch_encode_np` → `put_crs_np` →
`ofdm_tx_sf`); two noisy copies (noise amplitude 0.09, ~18 dB chest SNR)
then go through the reference `ue_dl_subframe` (jitted, vmapped, 6
iterations).  Written to `srsran_tpu_torch/testdata/ue_dl_siso_20mhz.npz`:
the clean tx, the two noisy subframes, the packed TB bits, and the
reference's TB, crc_ok and snr_db for those two subframes, plus the
configuration.  `chip_smoke.py` decodes the noisy subframes with the port
and holds the result to the stored reference.

The dynamic-grant fixture (`ue_dl_dynamic_20mhz.npz`) holds a few grants of
the same 20 MHz cell (`DYN_GRANTS`: MCS, PRB allocation, subframe, noise
amplitude), each rendered by the reference's transmitter with a seeded TB
and seeded noise and decoded by the reference's `DynamicUeDl` (6
iterations): the noisy subframes and the reference's TB bits, crc_ok and
iteration count.  `chip_smoke.py` decodes them with the port's
`DynamicUeDl` and holds the result to the stored reference.

The MIMO fixture (`ue_dl_mimo_20mhz.npz`) is the `bench.py`
`bench_ue_dl_mimo` row: 100 PRB, 2 ports, two codewords of MCS 26 QAM64,
pmi 1, the bench's 2x2 channel, noise amplitude 0.045, two noisy subframes
through the reference `ue_dl_subframe_mimo`.  The UL fixture
(`enb_ul_20mhz.npz`) is the `bench_enb_ul` row: PRB 1..96 of 100, MCS 20
16QAM, rnti 0x46, noise amplitude 0.09, two noisy subframes through the
reference `enb_ul_subframe`.  The dynamic UL fixture
(`enb_ul_dynamic_20mhz.npz`) holds the grants of `UL_DYN_GRANTS`, decoded by
the reference's `DynamicEnbUl`.  Each stores the noisy subframes, the sent
TB bits and the reference's TB bits, crc_ok and snr_db or iteration count.

The window fixtures (`window_ue_dl_20mhz.npz`, `window_ue_dl_mimo_20mhz.npz`,
`window_enb_ul_20mhz.npz`) hold one W = 4 window each on the same 100 PRB
cell (`WIN_GRANTS`), decoded by the
reference's `WindowedUeDl`, `WindowedUeDlMimo` and `WindowedEnbUl` (6
iterations, int8 ingest).  The samples are stored as the int8 pairs and
per-TTI scales the ingest makes of them; the stimulus both packages decode
is `window_samples(q, scale)`, which quantises to the same bytes again.
Beside them: the sent TB bits and the reference's TB bits, CRC flags and
iteration counts.

The generate-window fixtures (`window_gen_enb_dl.npz`,
`window_gen_ue_ul.npz`, `window_gen_enb_dl_mimo.npz`) hold one W = 4 window
each of the reference's `WindowedEnbDl` (template "full" and a control
overlay), `WindowedUeUl` (with PUCCH blocks and one row whose PUSCH is
masked) and `WindowedEnbDlMimo` (PMIs 0-2 and one CDD TTI) on a 25 PRB cell
(`GEN_GRANTS`): the payload bits, the grants and the overlay or PUCCH
inputs, the reference's row codewords (its codeword core, packed) and its
samples (complex64).

The control-window fixtures (`window_ctrl_ue_dl.npz`,
`window_ctrl_enb_ul.npz`) hold one W = 4 window each on the 100 PRB cell
301 at CFI 2 (`CTRL_GRANTS`), rendered by the reference's host transmitters
and decoded by its control front ends (float32 ingest, 6 iterations).  The
DL one: per TTI a `Dci1A` DL assignment for RNTI 0x46 at aggregation 4 with
its PDSCH TB, a `Dci0` for RNTI 0x1234 at aggregation 2, one PHICH (group
0, n_seq 1) and the MIB on subframe 0 (`enb_dl_subframe`); stored are the
int8 samples and scales, the sent DCIs, the reference's control REs
(`realize`), its found DCIs (`window_blind_search` over both RNTIs), PHICH
decisions and the TBs of its data pass over the grants it found.  The UL
one: per TTI a PUSCH grant, a 2-bit format-1 ACK on n_pucch 2 and a 10-bit
format-2 report on n_pucch 40 (`ue_ul_encode`); stored are the samples, the
reference's band edges and PRB powers (`realize_pucch`), its format-1 batch
and format-2 decodes and the TBs of its data pass.

The received-frame fixture (`ue_dl_frame_100prb.npz`) is an air capture of
the DL receive chain: `FRAME_CONFIG`'s 100 PRB cell 301 (1 port, CFI 2)
renders 16 subframes through the reference's `enb_dl_subframe` (MIB, one
C-RNTI `Dci1A` grant of MCS 12 on all 100 PRB per subframe); the capture
starts 3 subframes and 12345 samples in, behind h = 0.9·e^{0.3j}, a CFO of
0.12 subcarriers and AWGN of amplitude 0.01.  It is stored as int8 I/Q
pairs with one scale (complex64 would take 3 MB); both packages decode
`frame_samples(q, scale)`.  Beside it the reference's results:
`cell_search` over the first 7 subframes (what `UeSync`'s FIND sees),
`mib_search` at the subframe 0 it implies, and the subframes a `UeSync`
pops when fed one subframe of samples a push, each through
`ue_dl_decode_subframe` (CFI from the PCFICH): indices, CFI, found DCIs,
TB bits, CRC and snr_db.  `ue_dl_frame_stimulus(nof_prb, n_sf)` makes the
same at another width (the CPU tests use 25 PRB).

The UL-subframe fixture (`enb_ul_100prb.npz`) holds `ENB_UL_CONFIG`'s four
subframes of the 100 PRB cell 301 (`enb_ul_capture`), rendered by the
reference's `ue_ul_encode` behind a flat gain per UE and AWGN of amplitude
0.05, stored as int8 I/Q with a scale each: a plain PUSCH (MCS 20 on PRB
2..97); the SRS subframe (the PUSCH shortened, with ACK, RI and the 30-bit
subband CQI, and the SRS over PRB 2..97); PUCCH formats 1a on the SR
resource 15, 2 on the CQI resource 20 and 3 on n_pucch 36 (at the full
stack's 26 it shares a PRB with format 2 and does not decode); preamble 17
48 samples late.  Beside them the reference's results (TBs, CRC, snr_db,
UCI, SRS ce and snr, PUCCH bits and metrics, PRACH metric/delay/detected)
and `refsignal_dl_sync_run` on the received-frame fixture with its
measured CFO taken out (`sync_samples`), under PCI 301 and the wrong 300.

Run from the repo root:  JAX_PLATFORMS=cpu python tools/make_torch_fixture.py
(`main`, `main_dynamic`, `main_mimo`, `main_ul`, `main_ul_dynamic` each
write one file, `main_windows` the three decode windows, `main_gen_windows`
the three generate windows, `main_ctrl_windows` the two control windows,
`main_ue_dl_frame` the received frame, `main_enb_ul` the UL subframes,
`main_stack` the stored attach.)

`main_stack` runs the reference's `EnbStack`/`UeStack` (100 PRB, cell
301, MCS 20, SRS and SR on, one UE, no noise, the HSS's RAND state fixed)
through `chip_smoke.StackRun`: the attach, then 4 DL packets of 1400 bytes
and 3 UL packets of 1000 bytes.  It writes, per TTI, both ends' stats, both
RRC states and the UE's NAS state, and at the end the UE's IP, the MME's
attached IMSIs and the packets the UE and the SGi received, as JSON
(`testdata/full_stack_attach_100prb.json`); `chip_smoke.py` phase 28 runs
the port through the same script on the card and requires every TTI equal.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

TESTDATA = Path(__file__).resolve().parents[1] / "srsran_tpu_torch" / "testdata"
OUT = TESTDATA / "ue_dl_siso_20mhz.npz"
OUT_DYN = TESTDATA / "ue_dl_dynamic_20mhz.npz"
CONFIG = dict(nof_prb=100, cell_id=301, sf_idx=2, cfi=1, mcs=26, noise_amp=0.09,
              max_iterations=6, seed=20261016)
# (mcs, first PRB, number of PRB, subframe, noise amplitude): 13 codeblocks
# of K=6144; K- and K+ codeblocks at 16QAM over the PSS/SSS subframe; one
# small QPSK codeblock with filler bits in subframe 0; a 64QAM TB in noise
# that it cannot decode in
DYN_GRANTS = ((28, 0, 100, 1, 0.07), (14, 20, 37, 5, 0.25), (3, 47, 6, 0, 0.6),
              (22, 30, 60, 7, 0.2))
OUT_MIMO = TESTDATA / "ue_dl_mimo_20mhz.npz"
OUT_UL = TESTDATA / "enb_ul_20mhz.npz"
OUT_UL_DYN = TESTDATA / "enb_ul_dynamic_20mhz.npz"
MIMO_CONFIG = dict(nof_prb=100, cell_id=301, sf_idx=2, cfi=1, mcs=26, pmi=1, noise_amp=0.045,
                   max_iterations=6, seed=20261018)
# the 2x2 channel of `bench.py` `bench_ue_dl_mimo`: rx antenna x tx port
MIMO_CHANNEL = np.array([[1.0 + 0.1j, 0.25 - 0.55j], [-0.45 + 0.3j, 0.95 + 0.05j]], np.complex64)
UL_CONFIG = dict(nof_prb=100, cell_id=301, sf_idx=2, mcs=20, prb_start=1, nof_prb_alloc=96,
                 rnti=0x46, noise_amp=0.09, max_iterations=6, seed=20261019)
# (mcs, first PRB, number of PRB, subframe, noise amplitude): the headline
# grant (7 codeblocks of K=5824, PRB bucket 100), and a 25 PRB QPSK grant in
# the 40 PRB bucket in noise that takes several iterations
UL_DYN_GRANTS = ((20, 1, 96, 2, 0.09), (10, 40, 25, 7, 0.45))
UL_DYN_CONFIG = dict(nof_prb=100, cell_id=301, rnti=0x46, max_iterations=6, seed=20261020)
DYN_CONFIG = dict(nof_prb=100, cell_id=301, cfi=1, rnti=0x46, max_iterations=6, seed=20261017)
# the stored windows: W TTIs on the 100 PRB cell, int8 ingest
WIN_CONFIG = dict(nof_prb=100, cell_id=301, cfi=1, rnti=0x46, max_iterations=6, w=4, seed=20261021)
OUT_WIN = {kind: TESTDATA / f"window_{kind}_20mhz.npz" for kind in ("ue_dl", "ue_dl_mimo", "enb_ul")}
WIN_GRANTS = {
    # (mcs, first PRB, number of PRB, subframe, noise amplitude): 11 codeblocks
    # of K=5632; a QPSK TB that repeats (rate below 1/3); one small codeblock
    # in subframe 0; a 64QAM TB in noise that it cannot decode in
    "ue_dl": ((26, 0, 100, 2, 0.09), (1, 10, 80, 5, 0.3), (9, 20, 6, 0, 0.15), (22, 30, 60, 7, 0.2)),
    # (mcs 1, mcs 2, first PRB, number of PRB, subframe, pmi (3 = large-delay
    # CDD), noise amplitude), behind MIMO_CHANNEL
    "ue_dl_mimo": ((20, 12, 0, 100, 1, 0, 0.045), (8, 16, 20, 50, 4, 1, 0.1),
                   (14, 6, 60, 40, 9, 2, 0.045), (10, 18, 5, 70, 6, 3, 0.08)),
    # (mcs, first PRB, number of PRB, subframe, noise amplitude)
    "enb_ul": ((20, 1, 96, 2, 0.09), (10, 40, 25, 7, 0.45), (3, 70, 9, 0, 0.05), (16, 0, 50, 5, 0.05)),
}
GEN_CONFIG = dict(nof_prb=25, cell_id=301, cfi=1, rnti=0x46, w=4, seed=20261022)
OUT_GEN = {kind: TESTDATA / f"window_gen_{kind}.npz" for kind in ("enb_dl", "ue_ul", "enb_dl_mimo")}
GEN_GRANTS = {
    # (mcs, first PRB, number of PRB, subframe): subframes 0 and 5 carry the
    # PSS and SSS of template "full"; a QPSK TB that repeats; 2 codeblocks
    "enb_dl": ((5, 0, 25, 0), (17, 3, 20, 5), (26, 0, 25, 2), (0, 10, 6, 7)),
    # (mcs, first PRB, number of PRB, subframe)
    "ue_ul": ((0, 0, 4, 1), (12, 4, 9, 3), (20, 0, 25, 6), (23, 15, 10, 8)),
    # (mcs 1, mcs 2, first PRB, number of PRB, subframe, pmi (3 = large-delay CDD))
    "enb_dl_mimo": ((4, 10, 0, 25, 1, 0), (15, 8, 5, 20, 4, 1), (12, 12, 2, 18, 6, 2),
                    (6, 14, 0, 25, 8, 3)),
}


def reference_config():
    """(cell, grant) of the fixture, as reference objects."""
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.modem import Mod
    from srsran_tpu.phy.phch.pdsch import DlGrant
    from srsran_tpu.phy.phch.ra import dl_tbs

    cell = Cell(nof_prb=CONFIG["nof_prb"], nof_ports=1, id=CONFIG["cell_id"])
    tbs = dl_tbs(CONFIG["mcs"], CONFIG["nof_prb"])
    grant = DlGrant(prb=tuple(range(CONFIG["nof_prb"])), mod=Mod.QAM64, tbs=tbs)
    return cell, grant


def clean_tx():
    """(tb bits (tbs,) uint8, clean tx subframe (sf_len,) complex64)."""
    import jax

    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import pdsch_encode_np

    cell, grant = reference_config()
    rng = np.random.default_rng(CONFIG["seed"])
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    with jax.default_device(jax.devices("cpu")[0]):
        grid = pdsch_encode_np(cell, CONFIG["sf_idx"], CONFIG["cfi"], grant, tb)
        put_crs_np(grid, cell, CONFIG["sf_idx"])
        tx = np.asarray(ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True), grid))[0]
    return tb, tx.astype(np.complex64)


def dynamic_grant(i: int):
    """(reference grant, tb bits, clean tx (sf_len,) complex64) of DYN_GRANTS[i]."""
    import jax

    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs

    mcs, s0, l, sf_idx, _amp = DYN_GRANTS[i]
    cell = Cell(nof_prb=DYN_CONFIG["nof_prb"], nof_ports=1, id=DYN_CONFIG["cell_id"])
    grant = DlGrant(prb=tuple(range(s0, s0 + l)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, l),
                    rnti=DYN_CONFIG["rnti"])
    rng = np.random.default_rng(DYN_CONFIG["seed"] + i)
    tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
    with jax.default_device(jax.devices("cpu")[0]):
        grid = pdsch_encode_np(cell, sf_idx, DYN_CONFIG["cfi"], grant, tb)
        put_crs_np(grid, cell, sf_idx)
        tx = np.asarray(ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True), grid))[0]
    return grant, tb, tx.astype(np.complex64)


def main_dynamic():
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.pipeline_dynamic import DynamicUeDl

    cell = Cell(nof_prb=DYN_CONFIG["nof_prb"], nof_ports=1, id=DYN_CONFIG["cell_id"])
    ue = DynamicUeDl(cell, cfi=DYN_CONFIG["cfi"], max_iterations=DYN_CONFIG["max_iterations"])
    rxs, tbs, ref_tb, ref_ok, ref_it = [], [], [], [], []
    for i, (_mcs, _s0, _l, sf_idx, amp) in enumerate(DYN_GRANTS):
        grant, tb, tx = dynamic_grant(i)
        rng = np.random.default_rng(DYN_CONFIG["seed"] + 100 + i)
        rx = (tx[None, :] + amp * (rng.standard_normal((1, tx.size))
                                   + 1j * rng.standard_normal((1, tx.size)))).astype(np.complex64)
        tb_hat, ok, _soft, n_it = ue.decode(rx, sf_idx, grant)
        print(f"grant {i}: tbs {grant.tbs}, crc_ok {ok}, iterations {n_it}, "
              f"TB equal {bool((tb_hat == tb).all())}")
        rxs.append(rx)
        tbs.append(grant.tbs)
        ref_tb.append(np.packbits(tb_hat))
        ref_ok.append(ok)
        ref_it.append(n_it)
    packed = np.zeros((len(ref_tb), max(len(p) for p in ref_tb)), np.uint8)
    for i, p in enumerate(ref_tb):
        packed[i, : len(p)] = p
    cols = np.asarray(DYN_GRANTS)
    np.savez(
        OUT_DYN, rx=np.stack(rxs), tbs=np.asarray(tbs), ref_tb_packed=packed,
        ref_crc_ok=np.asarray(ref_ok), ref_n_it=np.asarray(ref_it),
        mcs=cols[:, 0].astype(np.int64), prb_start=cols[:, 1].astype(np.int64),
        prb_len=cols[:, 2].astype(np.int64), sf_idx=cols[:, 3].astype(np.int64),
        noise_amp=cols[:, 4], **{k: np.asarray(v) for k, v in DYN_CONFIG.items()},
    )
    print(f"wrote {OUT_DYN}")

# the stored control windows: W TTIs on the 100 PRB cell at CFI 2, float32 ingest
CTRL_CONFIG = dict(nof_prb=100, cell_id=301, cfi=2, w=4, max_iterations=6, edge_prbs=4, rnti=0x46,
                   rnti_ul=0x1234, seed=20261023)
OUT_CTRL = {kind: TESTDATA / f"window_ctrl_{kind}.npz" for kind in ("ue_dl", "enb_ul")}
CTRL_GRANTS = {
    # (mcs, first PRB, number of PRB, subframe, noise amplitude) of the DL
    # assignment: subframe 0 carries the MIB; a 64QAM TB in noise that it
    # cannot decode in (its DCIs still decode)
    "ue_dl": ((20, 0, 100, 0, 0.05), (9, 10, 30, 1, 0.05), (26, 50, 50, 5, 0.05), (22, 0, 100, 6, 0.2)),
    # (mcs, first PRB, number of PRB, subframe, noise amplitude) of the PUSCH
    # grant inside the band edges
    "enb_ul": ((20, 4, 90, 2, 0.05), (10, 40, 25, 7, 0.05), (3, 70, 9, 0, 0.05), (16, 10, 50, 5, 0.25)),
}
# PUCCH resources of the UL control window: (n_pucch, payload bits)
CTRL_F1, CTRL_F2 = (2, 2), (40, 10)


def awgn(seed: int, x: np.ndarray, amp: float) -> np.ndarray:
    """x plus seeded complex noise of the given amplitude, complex64."""
    rng = np.random.default_rng(seed)
    return (x + amp * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)


def pack_rows(rows) -> np.ndarray:
    """Bit rows of unequal length, each packed, in one zero-padded array."""
    packed = [np.packbits(r) for r in rows]
    out = np.zeros((len(packed), max(len(p) for p in packed)), np.uint8)
    for i, p in enumerate(packed):
        out[i, : len(p)] = p
    return out


def mimo_clean_rx():
    """(reference cell, reference DlGrant2, tb1, tb2, noise-free received
    subframe (2, sf_len) complex64 behind MIMO_CHANNEL)."""
    import jax

    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.modem import Mod
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant2, pdsch_encode2_np
    from srsran_tpu.phy.phch.ra import dl_tbs

    c = MIMO_CONFIG
    cell = Cell(nof_prb=c["nof_prb"], nof_ports=2, id=c["cell_id"])
    tbs = dl_tbs(c["mcs"], c["nof_prb"])
    grant = DlGrant2(prb=tuple(range(c["nof_prb"])), mod1=Mod.QAM64, tbs1=tbs, mod2=Mod.QAM64,
                     tbs2=tbs, pmi=c["pmi"])
    rng = np.random.default_rng(c["seed"])
    tb1, tb2 = (rng.integers(0, 2, tbs).astype(np.uint8) for _ in range(2))
    with jax.default_device(jax.devices("cpu")[0]):
        grid = pdsch_encode2_np(cell, c["sf_idx"], c["cfi"], grant, tb1, tb2)
        put_crs_np(grid, cell, c["sf_idx"])
        tx = np.asarray(ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True), grid))
    return cell, grant, tb1, tb2, np.einsum("rp,pt->rt", MIMO_CHANNEL, tx).astype(np.complex64)


def main_mimo():
    import jax

    from srsran_tpu.pipeline import ue_dl_subframe_mimo

    c = MIMO_CONFIG
    cell, grant, tb1, tb2, clean = mimo_clean_rx()
    rx = awgn(c["seed"] + 1, np.tile(clean[None], (2, 1, 1)), c["noise_amp"])
    fn = jax.jit(jax.vmap(ue_dl_subframe_mimo(cell, c["sf_idx"], c["cfi"], grant,
                                              max_iterations=c["max_iterations"])))
    (r_tb1, r_ok1), (r_tb2, r_ok2), r_snr = fn(rx)
    ok = np.stack([np.asarray(r_ok1), np.asarray(r_ok2)], axis=1)  # (subframe, codeword)
    np.savez(
        OUT_MIMO, rx=rx, tb1_packed=np.packbits(tb1), tb2_packed=np.packbits(tb2),
        ref_tb1_packed=np.packbits(np.asarray(r_tb1), axis=-1),
        ref_tb2_packed=np.packbits(np.asarray(r_tb2), axis=-1), ref_crc_ok=ok,
        ref_snr_db=np.asarray(r_snr, np.float32), tbs=np.int64(grant.tbs1),
        **{k: np.asarray(v) for k, v in c.items()},
    )
    print(f"wrote {OUT_MIMO}: tbs 2 x {grant.tbs1}, crc_ok {ok.tolist()}, "
          f"snr_db {np.asarray(r_snr).tolist()}")


def ul_grant(mcs: int, prb_start: int, nof_prb: int, rnti: int):
    from srsran_tpu.phy.phch.pusch import UlGrant
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod

    return UlGrant(prb_start=prb_start, nof_prb=nof_prb, mod=ul_mcs_to_mod(mcs),
                   tbs=tbs_lookup(ul_mcs_to_itbs(mcs), nof_prb), rv=0, rnti=rnti)


def ul_clean_tx(seed: int, cell_id: int, nof_prb: int, sf_idx: int, grant):
    """(reference cell, tb bits, clean UL subframe (sf_len,) complex64)."""
    import jax

    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.ue.ue_ul import ue_ul_encode

    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=cell_id)
    tb = np.random.default_rng(seed).integers(0, 2, grant.tbs).astype(np.uint8)
    with jax.default_device(jax.devices("cpu")[0]):
        tx = np.asarray(ue_ul_encode(cell, sf_idx, pusch=(grant, tb)))
    return cell, tb, tx.astype(np.complex64)


def main_ul():
    import jax

    from srsran_tpu.pipeline import enb_ul_subframe

    c = UL_CONFIG
    grant = ul_grant(c["mcs"], c["prb_start"], c["nof_prb_alloc"], c["rnti"])
    cell, tb, tx = ul_clean_tx(c["seed"], c["cell_id"], c["nof_prb"], c["sf_idx"], grant)
    rx = awgn(c["seed"] + 1, np.tile(tx[None, None, :], (2, 1, 1)), c["noise_amp"])
    fn = jax.jit(jax.vmap(enb_ul_subframe(cell, c["sf_idx"], grant,
                                          max_iterations=c["max_iterations"])))
    ref_tb, ref_ok, ref_snr = (np.asarray(v) for v in fn(rx))
    np.savez(
        OUT_UL, rx=rx, tb_packed=np.packbits(tb), ref_tb_packed=np.packbits(ref_tb, axis=-1),
        ref_crc_ok=ref_ok, ref_snr_db=ref_snr.astype(np.float32), tbs=np.int64(grant.tbs),
        **{k: np.asarray(v) for k, v in c.items()},
    )
    print(f"wrote {OUT_UL}: tbs {grant.tbs}, crc_ok {ref_ok.tolist()}, snr_db {ref_snr.tolist()}, "
          f"TB equal {(ref_tb == tb).all(axis=1).tolist()}")


def ul_dynamic_grant(i: int):
    """(reference cell, grant, tb bits, noisy subframe (1, sf_len)) of UL_DYN_GRANTS[i]."""
    c = UL_DYN_CONFIG
    mcs, s0, l, sf_idx, amp = UL_DYN_GRANTS[i]
    grant = ul_grant(mcs, s0, l, c["rnti"])
    cell, tb, tx = ul_clean_tx(c["seed"] + i, c["cell_id"], c["nof_prb"], sf_idx, grant)
    return cell, grant, tb, awgn(c["seed"] + 100 + i, tx[None, :], amp)


def main_ul_dynamic():
    from srsran_tpu.pipeline_dynamic import DynamicEnbUl

    c = UL_DYN_CONFIG
    rxs, sizes, ref_tb, ref_ok, ref_it = [], [], [], [], []
    enb = None
    for i, (_mcs, _s0, _l, sf_idx, _amp) in enumerate(UL_DYN_GRANTS):
        cell, grant, tb, rx = ul_dynamic_grant(i)
        enb = enb or DynamicEnbUl(cell, max_iterations=c["max_iterations"])
        tb_hat, ok, _soft, n_it = enb.decode(rx, sf_idx, grant)
        print(f"UL grant {i}: tbs {grant.tbs}, crc_ok {ok}, iterations {n_it}, "
              f"TB equal {bool((tb_hat == tb).all())}")
        rxs.append(rx)
        sizes.append(grant.tbs)
        ref_tb.append(tb_hat)
        ref_ok.append(ok)
        ref_it.append(n_it)
    cols = np.asarray(UL_DYN_GRANTS)
    np.savez(
        OUT_UL_DYN, rx=np.stack(rxs), tbs=np.asarray(sizes), ref_tb_packed=pack_rows(ref_tb),
        ref_crc_ok=np.asarray(ref_ok), ref_n_it=np.asarray(ref_it),
        mcs=cols[:, 0].astype(np.int64), prb_start=cols[:, 1].astype(np.int64),
        prb_len=cols[:, 2].astype(np.int64), sf_idx=cols[:, 3].astype(np.int64),
        noise_amp=cols[:, 4], **{k: np.asarray(v) for k, v in c.items()},
    )
    print(f"wrote {OUT_UL_DYN}")


def window_samples(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """(W, nrx, sf_len) complex64 samples of stored int8 pairs (W, nrx,
    sf_len, 2) and per-TTI scales: what the ingest dequantises to."""
    ri = q.astype(np.float32) * scale[:, None, None, None]
    return (ri[..., 0] + 1j * ri[..., 1]).astype(np.complex64)


def window_stimulus(kind: str):
    """(reference cell, subframe indices, reference grants, sent TBs, int8
    samples (W, nrx, sf_len, 2), scales (W,)) of the stored window `kind`.  A
    sent TB of the MIMO window is the pair of its codewords' bits."""
    import jax

    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant, DlGrant2, pdsch_encode2_np, pdsch_encode_np
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu.phy.ue.ue_ul import ue_ul_encode
    from srsran_tpu.pipeline_window import _quantize_ingest

    c = WIN_CONFIG
    kinds = list(OUT_WIN)
    cell = Cell(nof_prb=c["nof_prb"], nof_ports=2 if kind == "ue_dl_mimo" else 1, id=c["cell_id"])
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    rng = np.random.default_rng(c["seed"] + kinds.index(kind))
    sfs, grants, tbs, rxs = [], [], [], []
    with jax.default_device(jax.devices("cpu")[0]):
        for row in WIN_GRANTS[kind]:
            if kind == "enb_ul":
                mcs, s0, l, sf_idx, amp = row
                grant = ul_grant(mcs, s0, l, c["rnti"])
                tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
                clean = np.asarray(ue_ul_encode(cell, sf_idx, pusch=(grant, tb)))[None, :]
            elif kind == "ue_dl":
                mcs, s0, l, sf_idx, amp = row
                grant = DlGrant(prb=tuple(range(s0, s0 + l)), mod=dl_mcs_to_mod(mcs),
                                tbs=dl_tbs(mcs, l), rnti=c["rnti"])
                tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
                grid = pdsch_encode_np(cell, sf_idx, c["cfi"], grant, tb)
                put_crs_np(grid, cell, sf_idx)
                clean = np.asarray(ofdm_tx_sf(ofdm, grid))
            else:
                mcs1, mcs2, s0, l, sf_idx, pmi, amp = row
                grant = DlGrant2(prb=tuple(range(s0, s0 + l)), mod1=dl_mcs_to_mod(mcs1),
                                 tbs1=dl_tbs(mcs1, l), mod2=dl_mcs_to_mod(mcs2), tbs2=dl_tbs(mcs2, l),
                                 pmi=pmi % 3, rnti=c["rnti"],
                                 tx_scheme="cdd" if pmi == 3 else "spatialmux")
                tb = tuple(rng.integers(0, 2, t).astype(np.uint8) for t in (grant.tbs1, grant.tbs2))
                grid = np.zeros((2, cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
                grid += pdsch_encode2_np(cell, sf_idx, c["cfi"], grant, *tb)
                put_crs_np(grid, cell, sf_idx)
                clean = np.einsum("rp,pt->rt", MIMO_CHANNEL, np.asarray(ofdm_tx_sf(ofdm, grid)))
            noise = rng.standard_normal(clean.shape) + 1j * rng.standard_normal(clean.shape)
            rxs.append((clean + amp * noise).astype(np.complex64))
            sfs.append(sf_idx)
            grants.append(grant)
            tbs.append(tb)
    q, scale = _quantize_ingest(np.stack(rxs), "int8")
    return cell, sfs, grants, tbs, q, scale


def main_windows():
    import srsran_tpu.pipeline_window as pw

    c = WIN_CONFIG
    for kind, out in OUT_WIN.items():
        cell, sfs, grants, tbs, q, scale = window_stimulus(kind)
        if kind == "enb_ul":
            eng = pw.WindowedEnbUl(cell, w=c["w"], max_iterations=c["max_iterations"])
        else:
            cls = pw.WindowedUeDlMimo if kind == "ue_dl_mimo" else pw.WindowedUeDl
            eng = cls(cell, cfi=c["cfi"], w=c["w"], max_iterations=c["max_iterations"])
        p = eng.dispatch_window(window_samples(q, scale), sfs, grants)
        res = eng.results(p)
        if kind == "ue_dl_mimo":
            rows = [r for (t1, ok1), (t2, ok2), _n in res for r in ((t1, ok1), (t2, ok2))]
            sent = [t for pair in tbs for t in pair]
            n_it = [n for _a, _b, n in res]
        else:
            rows = [(tb, ok) for tb, ok, _n in res]
            sent = tbs
            n_it = [n for _tb, _ok, n in res]
        ok = [r[1] for r in rows]
        np.savez(
            out, q=q, scale=scale, tb_packed=pack_rows(sent), ref_tb_packed=pack_rows([r[0] for r in rows]),
            tbs=np.asarray([t.size for t in sent]), ref_crc_ok=np.asarray(ok), ref_n_it=np.asarray(n_it),
            ref_key=np.asarray(p.pack.key), grant_rows=np.asarray(WIN_GRANTS[kind], np.float64),
            **{k: np.asarray(v) for k, v in c.items()},
        )
        equal = [bool((r[0] == t).all()) for r, t in zip(rows, sent)]
        print(f"wrote {out}: key {p.pack.key}, crc_ok {ok}, iterations {n_it}, TB equal {equal}")


def reference_codewords(specs, payloads) -> np.ndarray:
    """The reference's codeword core on one window's codeword rows (tbs, g,
    qm, rv) with the inputs its generators build: (R, G_MAX) uint8."""
    import jax
    import jax.numpy as jnp

    import srsran_tpu.pipeline_window as pw
    from srsran_tpu.phy.fec.cbsegm import cbsegm

    pack = pw.pack_window(specs)
    _r, n_slots, _cq, cf, e_cap, _jf, tb_cap = pack.key[:7]
    bw = tb_cap * 8 + 24
    s_src = np.zeros(n_slots, np.int32)
    for r, (tbs, *_rest) in enumerate(specs):
        segm, startb = cbsegm(tbs), 0
        for c, k in enumerate(segm.cb_sizes):
            take = k - (segm.F if c == 0 else 0) - (24 if segm.C > 1 else 0)
            s_src[pack.row_start[r] + c] = r * (pw.K_MAX + bw) + bw - (tbs + 24) + startb + take
            startb += take
    tx_tab, perq = pw.tx_class_tables(pack, e_cap)
    core = jax.jit(pw._make_codeword_core(len(specs), n_slots, cf, e_cap, tb_cap))
    pay = pw._upload_payload_dense(payloads, [s[0] for s in specs], tb_cap)
    return np.asarray(core(pay, jnp.asarray(np.concatenate([pack.params, s_src])), tx_tab, perq))


def gen_window_stimulus(kind: str):
    """(reference cell, subframe indices, reference grants, payload rows
    (two per TTI for the MIMO window), dispatch keywords, codeword rows
    (tbs, g, qm, rv)) of the stored generate window `kind`."""
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.phch.pdsch import DlGrant, DlGrant2
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu.pipeline_dynamic import _padded_re_indices

    c = GEN_CONFIG
    w = c["w"]
    cell = Cell(nof_prb=c["nof_prb"], nof_ports=2 if kind == "enb_dl_mimo" else 1, id=c["cell_id"])
    rng = np.random.default_rng(c["seed"] + list(OUT_GEN).index(kind))
    sfs, grants, specs = [], [], []
    for row in GEN_GRANTS[kind]:
        if kind == "ue_ul":
            mcs, s0, l, sf_idx = row
            g = ul_grant(mcs, s0, l, c["rnti"])
            specs.append((g.tbs, 12 * 12 * l * g.qm, g.qm, 0))
        elif kind == "enb_dl":
            mcs, s0, l, sf_idx = row
            g = DlGrant(prb=tuple(range(s0, s0 + l)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, l),
                        rnti=c["rnti"])
            n_re = _padded_re_indices(cell, sf_idx, c["cfi"], g.prb)[1]
            specs.append((g.tbs, n_re * g.qm, g.qm, 0))
        else:
            mcs1, mcs2, s0, l, sf_idx, pmi = row
            g = DlGrant2(prb=tuple(range(s0, s0 + l)), mod1=dl_mcs_to_mod(mcs1), tbs1=dl_tbs(mcs1, l),
                         mod2=dl_mcs_to_mod(mcs2), tbs2=dl_tbs(mcs2, l), pmi=pmi % 3, rnti=c["rnti"],
                         tx_scheme="cdd" if pmi == 3 else "spatialmux")
            n_re = _padded_re_indices(cell, sf_idx, c["cfi"], g.prb)[1]
            specs += [(g.tbs1, n_re * g.qm1, g.qm1, 0), (g.tbs2, n_re * g.qm2, g.qm2, 0)]
        sfs.append(sf_idx)
        grants.append(g)
    payloads = [rng.integers(0, 2, sp[0]).astype(np.uint8) for sp in specs]
    kw = {}
    if kind == "enb_dl":
        # control-region REs of the overlay: random values on distinct REs,
        # the last five of each row past the grid (pad, dropped)
        s = cell.nsymb_per_sf * cell.nof_re_per_symbol
        idx = np.stack([rng.choice(s, 60, replace=False) for _ in range(w)]).astype(np.int32)
        idx[:, -5:] = s + 3
        vals = (rng.standard_normal((w, 60)) + 1j * rng.standard_normal((w, 60))).astype(np.complex64)
        kw = dict(overlay=(idx, vals))
    elif kind == "ue_ul":
        prb = rng.integers(0, c["nof_prb"], (w, 2)).astype(np.int32)
        prb[0] = (0, c["nof_prb"] - 1)
        grids = (rng.standard_normal((w, 14, 12)) + 1j * rng.standard_normal((w, 14, 12))
                 ).astype(np.complex64)
        kw = dict(pucch=(prb, grids, np.array([True, True, False, True])))
    return cell, sfs, grants, payloads, kw, specs


def main_gen_windows():
    import srsran_tpu.pipeline_window as pw

    c = GEN_CONFIG
    for kind, out in OUT_GEN.items():
        cell, sfs, grants, payloads, kw, specs = gen_window_stimulus(kind)
        if kind == "enb_dl":
            eng = pw.WindowedEnbDl(cell, cfi=c["cfi"], w=c["w"], template="full")
        elif kind == "ue_ul":
            eng = pw.WindowedUeUl(cell, w=c["w"])
        else:
            eng = pw.WindowedEnbDlMimo(cell, cfi=c["cfi"], w=c["w"])
        pairs = list(zip(payloads[0::2], payloads[1::2])) if kind == "enb_dl_mimo" else payloads
        ri = np.asarray(eng.dispatch_window(pairs, sfs, grants, **kw))
        extra = {}
        if kind == "enb_dl":
            extra = dict(ov_idx=kw["overlay"][0], ov_vals=kw["overlay"][1])
        elif kind == "ue_ul":
            extra = dict(pucch_prb=kw["pucch"][0], pucch_grids=kw["pucch"][1], pucch_live=kw["pucch"][2])
        np.savez(
            out, tb_packed=pack_rows(payloads), tbs=np.asarray([p.size for p in payloads]),
            ref_cw_packed=np.packbits(reference_codewords(specs, payloads), axis=-1),
            ref_samples=(ri[..., 0] + 1j * ri[..., 1]).astype(np.complex64),
            grant_rows=np.asarray(GEN_GRANTS[kind], np.int64), **extra,
            **{k: np.asarray(v) for k, v in c.items()},
        )
        print(f"wrote {out}: {len(payloads)} codeword rows, samples {ri.shape[:-1]}")


def ctrl_window_stimulus(kind: str):
    """(reference cell, subframe indices, int8 samples (W, 1, sf_len, 2),
    scales (W,), extras) of the stored control window `kind`.  extras:
    "ue_dl": the reference grants and TBs, the sent DCIs per TTI [(rnti,
    bits, level, CCE)] (the DL assignment first), the PHICH ACKs, the MIB;
    "enb_ul": the reference grants and TBs, the format-1 ACK bits and
    format-2 payloads."""
    import jax

    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.enb.enb_dl import DlSched, enb_dl_subframe
    from srsran_tpu.phy.phch.dci import Dci0, Dci1A
    from srsran_tpu.phy.phch.pbch import Mib
    from srsran_tpu.phy.phch.pdcch import nof_cce, search_space_candidates
    from srsran_tpu.phy.phch.pdsch import DlGrant
    from srsran_tpu.phy.phch.pucch import PucchConfig
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs, riv_encode
    from srsran_tpu.phy.ue.ue_ul import ue_ul_encode
    from srsran_tpu.pipeline_window import _quantize_ingest

    c = CTRL_CONFIG
    n_prb = c["nof_prb"]
    cell = Cell(nof_prb=n_prb, nof_ports=1, id=c["cell_id"])
    rng = np.random.default_rng(c["seed"] + list(OUT_CTRL).index(kind))
    mib = Mib(nof_prb=n_prb, phich_length=cell.phich_length, phich_resources=cell.phich_resources)
    sfs, grants, tbs, rxs = [], [], [], []
    ex = dict(dcis=[], acks=[], f1=[], f2=[], mib=mib)
    with jax.default_device(jax.devices("cpu")[0]):
        for t, (mcs, s0, l, sf_idx, amp) in enumerate(CTRL_GRANTS[kind]):
            if kind == "ue_dl":
                g = DlGrant(prb=tuple(range(s0, s0 + l)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, l),
                            rnti=c["rnti"])
                tb = rng.integers(0, 2, g.tbs).astype(np.uint8)
                n_cce = nof_cce(cell, sf_idx, c["cfi"])
                c4 = search_space_candidates(c["rnti"], sf_idx, n_cce)[4][0]
                c2 = next(x for x in search_space_candidates(c["rnti_ul"], sf_idx, n_cce)[2]
                          if x + 2 <= c4 or x >= c4 + 4)
                d1a = Dci1A(riv=riv_encode(n_prb, s0, l), mcs=mcs, harq_pid=t, ndi=1, tpc=1)
                d0 = Dci0(riv=riv_encode(n_prb, 5, 20), mcs=10 + t, ndi=t & 1, tpc=2)
                dcis = [(np.asarray(d1a.pack(n_prb)), c["rnti"], 4, c4),
                        (np.asarray(d0.pack(n_prb)), c["rnti_ul"], 2, c2)]
                sched = DlSched(cfi=c["cfi"], dcis=list(dcis), grants=[(g, tb)], phich=[(0, 1, t & 1)])
                clean = np.asarray(enb_dl_subframe(cell, sf_idx, sched, mib=mib, sfn=0)[1])
                ex["dcis"].append(dcis)
                ex["acks"].append(t & 1)
            else:
                g = ul_grant(mcs, s0, l, c["rnti"])
                tb = rng.integers(0, 2, g.tbs).astype(np.uint8)
                ack = rng.integers(0, 2, CTRL_F1[1]).astype(np.uint8)
                cqi = rng.integers(0, 2, CTRL_F2[1]).astype(np.uint8)
                clean = np.asarray(ue_ul_encode(
                    cell, sf_idx, pusch=(g, tb), pucch1=(PucchConfig(n_pucch=CTRL_F1[0]), list(ack)),
                    pucch2=(PucchConfig(n_pucch=CTRL_F2[0]), cqi)))[None, :]
                ex["f1"].append(ack)
                ex["f2"].append(cqi)
            noise = rng.standard_normal(clean.shape) + 1j * rng.standard_normal(clean.shape)
            rxs.append((clean + amp * noise).astype(np.complex64))
            sfs.append(sf_idx)
            grants.append(g)
            tbs.append(tb)
    q, scale = _quantize_ingest(np.stack(rxs), "int8")
    ex.update(grants=grants, tbs=tbs)
    return cell, sfs, q, scale, ex


def main_ctrl_windows():
    import srsran_tpu.pipeline_ctrl as pc
    from srsran_tpu.phy.phch.dci import Dci1A
    from srsran_tpu.phy.phch.pucch import PucchConfig, _f1_covers, pucch_f1_prb

    c = CTRL_CONFIG
    for kind, out in OUT_CTRL.items():
        cell, sfs, q, scale, ex = ctrl_window_stimulus(kind)
        samples = window_samples(q, scale)
        w = c["w"]
        common = dict(q=q, scale=scale, sfs=np.asarray(sfs), grant_rows=np.asarray(CTRL_GRANTS[kind], np.float64),
                      tb_packed=pack_rows(ex["tbs"]), tbs=np.asarray([t.size for t in ex["tbs"]]),
                      **{k: np.asarray(v) for k, v in c.items()})
        if kind == "ue_dl":
            fe = pc.WindowedUeFrontEnd(cell, cfi=c["cfi"], w=w, ingest="float32",
                                       max_iterations=c["max_iterations"])
            pf = fe.dispatch(samples, sfs)
            ctrl, _rsrp, _noise = fe.realize(pf)
            dci_len = Dci1A.nof_bits(c["nof_prb"])
            rntis = (c["rnti"], c["rnti_ul"])
            found = pc.window_blind_search(ctrl, fe.layout, cell, sfs,
                                           [[(r, "1A", dci_len, True) for r in rntis]] * w)
            hits = [(t, r, b, l, cc) for t, f in enumerate(found) for r, _f, b, l, cc in f]
            for t, dcis in enumerate(ex["dcis"]):
                got = {(r, b.tobytes()) for tt, r, b, _l, _c in hits if tt == t}
                assert all((r, b.tobytes()) in got for b, r, _a, _cc in dcis), f"TTI {t}: a DCI was missed"
            grants = ex["grants"]  # the found DL assignments are the sent ones
            phich = [pc.phich_decode_np(ctrl[t, fe.layout.phich[0]], cell, sf, 1) for t, sf in enumerate(sfs)]
            res = fe.results(fe.dispatch_data(pf, grants))
            extra = dict(
                ref_ctrl=ctrl, rntis=np.asarray(rntis), dci_len=np.int64(dci_len),
                sent_rnti=np.asarray([[r for _b, r, _a, _c in d] for d in ex["dcis"]]),
                sent_bits=np.asarray([[b for b, _r, _a, _c in d] for d in ex["dcis"]], np.uint8),
                sent_acks=np.asarray(ex["acks"]),
                found_t=np.asarray([h[0] for h in hits]), found_rnti=np.asarray([h[1] for h in hits]),
                found_bits=np.asarray([h[2] for h in hits], np.uint8),
                found_lvl=np.asarray([h[3] for h in hits]), found_cce=np.asarray([h[4] for h in hits]),
                ref_phich=np.asarray([a for a, _m in phich]), ref_phich_metric=np.asarray([m for _a, m in phich]))
            summary = f"{len(hits)} DCIs found, PHICH {[bool(a) for a, _m in phich]}"
        else:
            fe = pc.WindowedEnbUlFrontEnd(cell, w=w, edge_prbs=c["edge_prbs"], max_iterations=c["max_iterations"])
            pf = fe.dispatch(samples, sfs)
            edge, prb_pow = fe.realize_pucch(pf)
            prbs = {n: np.asarray([[pucch_f1_prb(n, 2 * sf + slot, c["nof_prb"], 2, covers=_f1_covers(cell))
                                    for slot in range(2)] for sf in sfs]) for n in (CTRL_F1[0], CTRL_F2[0])}
            grids1 = np.stack([fe.pucch_prb_grid(edge, t, tuple(prbs[CTRL_F1[0]][t])) for t in range(w)])
            bits1, metric1 = pc.pucch_format1_decode_batch(grids1, cell, CTRL_F1[0], sfs, CTRL_F1[1])
            f2 = [pc.pucch_format2_decode_np(fe.pucch_prb_grid(edge, t, tuple(prbs[CTRL_F2[0]][t])), cell,
                                             PucchConfig(n_pucch=CTRL_F2[0]), sf, CTRL_F2[1])
                  for t, sf in enumerate(sfs)]
            res = fe.results(fe.dispatch_data(pf, ex["grants"]))
            extra = dict(
                ref_edge=edge, ref_prb_pow=prb_pow, f1_n_pucch=np.int64(CTRL_F1[0]),
                f1_nbits=np.int64(CTRL_F1[1]), f2_n_pucch=np.int64(CTRL_F2[0]), f2_nbits=np.int64(CTRL_F2[1]),
                f1_prb=prbs[CTRL_F1[0]], f2_prb=prbs[CTRL_F2[0]], sent_f1=np.asarray(ex["f1"]),
                sent_f2=np.asarray(ex["f2"]), ref_f1_bits=bits1, ref_f1_metric=np.asarray(metric1),
                ref_f2_bits=np.stack([np.asarray(b) for b, _m in f2]),
                ref_f2_metric=np.asarray([m for _b, m in f2]))
            summary = f"format 1 {bits1.tolist()} (sent {np.asarray(ex['f1']).tolist()})"
        ok = [bool(r[1]) for r in res]
        np.savez(out, ref_tb_packed=pack_rows([r[0] for r in res]), ref_crc_ok=np.asarray(ok),
                 ref_n_it=np.asarray([r[2] for r in res]), **common, **extra)
        equal = [bool(np.array_equal(r[0], t)) for r, t in zip(res, ex["tbs"])]
        print(f"wrote {out}: {summary}, crc_ok {ok}, iterations {[r[2] for r in res]}, TB equal {equal}")


FRAME_CONFIG = dict(nof_prb=100, cell_id=301, cfi=2, rnti=0x46, mcs=12, n_sf=16, skip_sf=3,
                    offset_2048=12345, cfo=0.12, h_abs=0.9, h_phase=0.3, amp=0.01,
                    max_iterations=5, seed=20261023)
OUT_FRAME = TESTDATA / "ue_dl_frame_100prb.npz"


def frame_samples(q: np.ndarray, scale) -> np.ndarray:
    """complex64 samples of stored int8 I/Q pairs (n, 2) and their scale."""
    ri = q.astype(np.float32) * np.float32(scale)
    return (ri[:, 0] + 1j * ri[:, 1]).astype(np.complex64)


def ue_dl_frame_capture(nof_prb: int = 100, n_sf: int = 16):
    """`FRAME_CONFIG`'s capture at `nof_prb` and `n_sf` rendered subframes:
    (configuration, int8 I/Q pairs (n, 2), scale, sent TBs)."""
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.enb.enb_dl import DlSched, enb_dl_subframe
    from srsran_tpu.phy.phch.dci import Dci1A
    from srsran_tpu.phy.phch.pbch import Mib
    from srsran_tpu.phy.phch.pdcch import nof_cce, search_space_candidates
    from srsran_tpu.phy.phch.pdsch import DlGrant
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs, riv_encode

    c = dict(FRAME_CONFIG, nof_prb=nof_prb, n_sf=n_sf)
    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=c["cell_id"])
    rng = np.random.default_rng(c["seed"])
    mib = Mib(nof_prb=nof_prb)
    tx, sent = [], []
    for t in range(n_sf):
        sf_idx = t % 10
        tbs = dl_tbs(c["mcs"], nof_prb)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        grant = DlGrant(prb=tuple(range(nof_prb)), mod=dl_mcs_to_mod(c["mcs"]), tbs=tbs,
                        rnti=c["rnti"])
        dci = Dci1A(riv=riv_encode(nof_prb, 0, nof_prb), mcs=c["mcs"], harq_pid=t % 8, ndi=t % 2)
        cands = search_space_candidates(c["rnti"], sf_idx, nof_cce(cell, sf_idx, c["cfi"]))
        sched = DlSched(cfi=c["cfi"], dcis=[(dci.pack(nof_prb), c["rnti"], 4, cands[4][0])],
                        grants=[(grant, tb)])
        tx.append(np.asarray(enb_dl_subframe(cell, sf_idx, sched, mib=mib, sfn=t // 10)[1][0]))
        sent.append(tb)
    start = c["skip_sf"] * cell.sf_len + c["offset_2048"] * cell.symbol_sz // 2048
    x = np.concatenate(tx)[start:]
    n = np.arange(len(x))
    h = c["h_abs"] * np.exp(1j * c["h_phase"])
    x = x * h * np.exp(2j * np.pi * c["cfo"] * n / cell.symbol_sz)
    x = x + c["amp"] * (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
    scale = np.float32(np.abs(np.stack([x.real, x.imag])).max() / 127.0)
    q = np.stack([np.round(x.real / scale), np.round(x.imag / scale)], -1).astype(np.int8)
    return c, q, scale, sent


def ue_dl_frame_stimulus(nof_prb: int = 100, n_sf: int = 16) -> dict:
    """`ue_dl_frame_capture` and the reference's results on it (see the
    module docstring)."""
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.ue.ue_dl import ue_dl_decode_subframe
    from srsran_tpu.phy.ue.ue_sync import UeSync, cell_search, mib_search

    c, q, scale, sent = ue_dl_frame_capture(nof_prb, n_sf)
    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=c["cell_id"])
    samples = frame_samples(q, scale)

    cs = cell_search(samples[: 7 * cell.sf_len], nof_prb)
    pss_sf = cs.peak_offset - (cell.sf_len // 2 - cell.symbol_sz)
    sf0 = pss_sf + (5 * cell.sf_len if cs.sf_idx == 5 else 0)
    mib_res = mib_search(samples, Cell(nof_prb=nof_prb, nof_ports=1, id=cs.cell_id), sf0, cs.cfo)
    m, nports, frame_off = mib_res
    sync = UeSync(nof_prb=nof_prb)
    out = dict(sf=[], cfi=[], n_dci=[], dci_bits=[], dci_agg=[], dci_cce=[], tb=[], crc=[], snr=[])
    for p in range(0, len(samples), cell.sf_len):
        sync.push(samples[p : p + cell.sf_len])
        while (got := sync.pop_subframe()) is not None:
            sf, idx = got
            res = ue_dl_decode_subframe(sync.cell, sf[None], idx, c["rnti"],
                                        max_iterations=c["max_iterations"])
            out["sf"].append(idx)
            out["cfi"].append(res.cfi)
            out["n_dci"].append(len(res.dcis))
            for bits, agg, cce in res.dcis:
                out["dci_bits"].append(np.asarray(bits, np.uint8))
                out["dci_agg"].append(agg)
                out["dci_cce"].append(cce)
            tb, ok = res.tbs[0] if res.tbs else (np.zeros(0, np.uint8), False)
            out["tb"].append(np.asarray(tb, np.uint8))
            out["crc"].append(bool(ok))
            out["snr"].append(res.snr_db)
    assert sync.state == UeSync.TRACK and all(out["crc"]), out["crc"]
    return dict(
        q=q, scale=scale, sent_packed=pack_rows(sent), tbs=np.int64(sent[0].size),
        ref_cs=np.asarray([cs.cell_id, cs.peak_offset, cs.sf_idx, cs.frame_type == "tdd"]),
        ref_cfo=np.float64(cs.cfo), ref_psr=np.float64(cs.psr), ref_sf0=np.int64(sf0),
        ref_mib=np.asarray([m.nof_prb, m.phich_length, m.phich_resources, m.sfn, nports, frame_off]),
        ref_sf=np.asarray(out["sf"]), ref_cfi=np.asarray(out["cfi"]), ref_n_dci=np.asarray(out["n_dci"]),
        ref_dci_bits=np.asarray(out["dci_bits"], np.uint8), ref_dci_agg=np.asarray(out["dci_agg"]),
        ref_dci_cce=np.asarray(out["dci_cce"]), ref_tb_packed=pack_rows(out["tb"]),
        ref_crc_ok=np.asarray(out["crc"]), ref_snr_db=np.asarray(out["snr"], np.float64),
        **{k: np.asarray(v) for k, v in c.items()})


def main_ue_dl_frame():
    fx = ue_dl_frame_stimulus()
    np.savez(OUT_FRAME, **fx)
    print(f"wrote {OUT_FRAME}: cell search {fx['ref_cs'].tolist()} cfo {float(fx['ref_cfo']):.5f}, "
          f"MIB {fx['ref_mib'].tolist()}, subframes {fx['ref_sf'].tolist()}, "
          f"crc {fx['ref_crc_ok'].tolist()}")


ENB_UL_CONFIG = dict(nof_prb=100, cell_id=301, rnti=0x46, mcs=20, prb_start=2, sf_plain=2,
                     sf_srs=3, sf_pucch=7, sf_prach=1, n_pucch=(15, 20, 36), rnti_f3=0x49,
                     pucch_bits=(1, 4, 4), preamble=17, prach_delay=48, prach_freq_offset=2,
                     amp=0.05, max_iterations=5, wrong_pci=300, seed=20261024)
# per UE (PUSCH, PUCCH formats 1a / 2 / 3): the flat channel of the stored subframes
ENB_UL_GAINS = (0.9 * np.exp(0.4j), 0.8 * np.exp(-0.7j), 0.7 * np.exp(1.2j), 0.85 * np.exp(2.0j))
OUT_ENB_UL = TESTDATA / "enb_ul_100prb.npz"


def ul_width(nof_prb: int, prb_start: int) -> int:
    """The widest PUSCH from `prb_start` that leaves the two band-edge PUCCH
    PRBs of each side free and factors into 2, 3 and 5."""
    from srsran_tpu.phy.dft_precoding import valid_nof_prb

    return max(n for n in range(1, nof_prb - 1 - prb_start) if valid_nof_prb(n))


def quantise(x: np.ndarray):
    """int8 I/Q pairs (..., 2) and the one scale of complex samples."""
    scale = np.float32(np.abs(np.stack([x.real, x.imag])).max() / 127.0)
    return np.stack([np.round(x.real / scale), np.round(x.imag / scale)], -1).astype(np.int8), scale


def sync_samples(fx) -> np.ndarray:
    """The stored received frame with the CFO its cell search measured taken
    out (float64 phase): what `refsignal_dl_sync_run` validates."""
    from srsran_tpu.phy.common import symbol_sz

    x = frame_samples(fx["q"], fx["scale"])
    sz = symbol_sz(int(fx["nof_prb"]))
    n = np.arange(len(x))
    return (x * np.exp(-2j * np.pi * float(fx["ref_cfo"]) * n / sz)).astype(np.complex64)


def enb_ul_capture():
    """`ENB_UL_CONFIG`'s four stored UL subframes (plain PUSCH, SRS subframe
    with the shortened PUSCH and UCI, the three PUCCH formats, PRACH), as int8
    pairs (4, sf_len, 2) with one scale each, and what was sent."""
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.phch.prach import PrachConfig, prach_generate_np
    from srsran_tpu.phy.phch.pucch import PucchConfig
    from srsran_tpu.phy.phch.pusch import UciCfg
    from srsran_tpu.phy.phch.uci import cqi_hl_nof_subbands, cqi_hl_subband_pack
    from srsran_tpu.phy.ue.ue_ul import ue_ul_encode

    c = ENB_UL_CONFIG
    cell = Cell(nof_prb=c["nof_prb"], nof_ports=1, id=c["cell_id"])
    rng = np.random.default_rng(c["seed"])
    w = ul_width(c["nof_prb"], c["prb_start"])
    grant = ul_grant(c["mcs"], c["prb_start"], w, c["rnti"])
    tbs = [rng.integers(0, 2, grant.tbs).astype(np.uint8) for _ in range(2)]
    nsub = cqi_hl_nof_subbands(c["nof_prb"])
    cqi = np.asarray(cqi_hl_subband_pack(11, rng.integers(0, 4, nsub)), np.uint8)
    uci = UciCfg(cqi_bits=tuple(int(b) for b in cqi), ack=(1,), ri=(1,))
    pucch = [rng.integers(0, 2, n).astype(np.uint8) for n in c["pucch_bits"]]
    h_a, h_b, h_c, h_d = ENB_UL_GAINS
    sfs = [h_a * np.asarray(ue_ul_encode(cell, c["sf_plain"], pusch=(grant, tbs[0]))),
           h_a * np.asarray(ue_ul_encode(cell, c["sf_srs"], pusch=(grant, tbs[1]), uci=uci,
                                         srs=(c["prb_start"], w)))]
    cfgs = [PucchConfig(n_pucch=n) for n in c["n_pucch"]]
    sf = c["sf_pucch"]
    sfs.append(h_b * np.asarray(ue_ul_encode(cell, sf, pucch1=(cfgs[0], list(pucch[0]))))
               + h_c * np.asarray(ue_ul_encode(cell, sf, pucch2=(cfgs[1], pucch[1])))
               + h_d * np.asarray(ue_ul_encode(cell, sf, pucch3=(cfgs[2], pucch[2], c["rnti_f3"]))))
    p = prach_generate_np(cell, PrachConfig(freq_offset=c["prach_freq_offset"]), c["preamble"])
    x = np.zeros(cell.sf_len, np.complex64)
    x[c["prach_delay"] : c["prach_delay"] + len(p)] = p
    sfs.append(x)
    qs = [quantise(awgn(c["seed"] + i, s, c["amp"])) for i, s in enumerate(sfs)]
    sent = dict(tbs=tbs, cqi=cqi, pucch=pucch, w=w)
    return c, np.stack([q for q, _ in qs]), np.asarray([s for _, s in qs], np.float32), sent


def enb_ul_stimulus() -> dict:
    """`enb_ul_capture` and the reference's results on it; beside them
    `refsignal_dl_sync_run` on the stored received frame (`OUT_FRAME`) under
    its own PCI and a wrong one."""
    from srsran_tpu.phy.chest.srs import srs_estimate
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.enb.enb_ul import enb_ul_decode_pucch, enb_ul_decode_pusch, enb_ul_fft
    from srsran_tpu.phy.phch.prach import PrachConfig, prach_cp_len, prach_detect, prach_nfft
    from srsran_tpu.phy.phch.pucch import PucchConfig
    from srsran_tpu.phy.phch.pusch import UciCfg
    from srsran_tpu.phy.sync.refsignal_dl_sync import refsignal_dl_sync_run

    c, q, scale, sent = enb_ul_capture()
    cell = Cell(nof_prb=c["nof_prb"], nof_ports=1, id=c["cell_id"])
    x = [frame_samples(q[i], scale[i]) for i in range(4)]
    grids = [np.asarray(enb_ul_fft(cell, s[None])) for s in x]
    grant = ul_grant(c["mcs"], c["prb_start"], sent["w"], c["rnti"])
    tb0, ok0, _, snr0 = enb_ul_decode_pusch(cell, c["sf_plain"], grids[0], grant, c["max_iterations"])
    uci_exp = UciCfg(cqi_bits=(0,) * len(sent["cqi"]), ack=(0,), ri=(0,))
    tb1, ok1, _, snr1, uci = enb_ul_decode_pusch(cell, c["sf_srs"], grids[1], grant,
                                                 c["max_iterations"], uci=uci_exp, shortened=True)
    ce, snr_srs = (np.asarray(v) for v in srs_estimate(grids[1], cell, c["prb_start"], sent["w"]))
    pucch = [enb_ul_decode_pucch(cell, c["sf_pucch"], grids[2], PucchConfig(n_pucch=n), f, nb,
                                 rnti=c["rnti_f3"] if f == "3" else 0)
             for n, f, nb in zip(c["n_pucch"], "123", c["pucch_bits"])]
    cp, nfft = prach_cp_len(cell), prach_nfft(cell)
    metric, delay, det = (np.asarray(v) for v in prach_detect(
        cell, PrachConfig(freq_offset=c["prach_freq_offset"]), x[3][cp : cp + nfft]))
    frame = np.load(OUT_FRAME)
    rs = [refsignal_dl_sync_run(sync_samples(frame), Cell(nof_prb=int(frame["nof_prb"]), nof_ports=1,
                                                            id=pci))
          for pci in (int(frame["cell_id"]), c["wrong_pci"])]
    assert ok0 and ok1 and np.array_equal(tb0, sent["tbs"][0]) and np.array_equal(tb1, sent["tbs"][1])
    assert uci == dict(cqi_bits=tuple(int(b) for b in sent["cqi"]), ack=(1,), ri=(1,)), uci
    assert det[c["preamble"]] and det.sum() == 1 and rs[0].found and not rs[1].found
    return dict(
        q=q, scale=scale, w=np.int64(sent["w"]), tbs=np.int64(grant.tbs),
        sent_packed=pack_rows(sent["tbs"]), sent_cqi=sent["cqi"], sent_pucch=pack_rows(sent["pucch"]),
        ref_tb_packed=pack_rows([tb0, tb1]), ref_crc_ok=np.asarray([ok0, ok1]),
        ref_snr_db=np.asarray([snr0, snr1], np.float64),
        ref_uci_cqi=np.asarray(uci["cqi_bits"], np.uint8), ref_uci_ack=np.asarray(uci["ack"]),
        ref_uci_ri=np.asarray(uci["ri"]), ref_srs_ce=ce, ref_srs_snr=snr_srs,
        ref_pucch_packed=pack_rows([np.asarray(b, np.uint8) for b, _ in pucch]),
        ref_pucch_metric=np.asarray([float(np.asarray(m)) for _, m in pucch], np.float64),
        ref_prach_metric=metric, ref_prach_delay=delay, ref_prach_det=det,
        ref_rs=np.asarray([[r.found, r.false_alarm, r.peak_index, r.rsrp_dbfs, r.rssi_dbfs,
                            r.cfo_hz, r.psr] for r in rs], np.float64),
        **{k: np.asarray(v) for k, v in c.items()})


def main_enb_ul():
    fx = enb_ul_stimulus()
    np.savez(OUT_ENB_UL, **fx)
    print(f"wrote {OUT_ENB_UL}: crc {fx['ref_crc_ok'].tolist()} snr_db {fx['ref_snr_db'].tolist()}, "
          f"PUCCH metrics {fx['ref_pucch_metric'].tolist()}, PRACH delay "
          f"{int(fx['ref_prach_delay'][int(fx['preamble'])])}, refsignal {fx['ref_rs'].tolist()}")


OUT_STACK = TESTDATA / "full_stack_attach_100prb.json"
STACK_KW = dict(srs_enabled=True, sr_enabled=True)


def reference_stack_modules():
    """The reference's stack classes, as `chip_smoke.stack_pair` takes them."""
    from types import SimpleNamespace

    from srsran_tpu.apps.full_stack import EnbStack, UeStack
    from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.stack.nas_ue import Usim
    from srsran_tpu.stack.security import compute_opc

    return SimpleNamespace(EnbStack=EnbStack, UeStack=UeStack, Cell=Cell, Hss=Hss, Mme=Mme,
                           Spgw=Spgw, Subscriber=Subscriber, Usim=Usim, compute_opc=compute_opc)


def main_stack(nof_prb: int = 100):
    import json
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    s = chip_smoke.stack_pair(reference_stack_modules(), nof_prb, enb_kw=STACK_KW, ue_kw=[STACK_KW])
    run = chip_smoke.StackRun(s.enb, s.ues[0], s.mme, s.spgw).run()
    run.check_traffic("reference stack")
    fx = dict(nof_prb=nof_prb, enb_kw=STACK_KW, ue_kw=STACK_KW, stack=chip_smoke.STACK,
              records=run.records, result=run.result())
    OUT_STACK.write_text(json.dumps(fx, indent=None, separators=(",", ":"), default=list) + "\n")
    print(f"wrote {OUT_STACK}: {run.tti} TTIs, registered at TTI {run.reg_tti}, IP {run.ue.ue_ip}, "
          f"eNB {run.records[-1]['enb']}, UE {run.records[-1]['ue']}")


def main():
    import jax

    from srsran_tpu.pipeline import ue_dl_subframe

    cell, grant = reference_config()
    tb, tx = clean_tx()
    rng = np.random.default_rng(CONFIG["seed"] + 1)
    shape = (2, 1, tx.size)
    rx = (tx[None, None, :] + CONFIG["noise_amp"] * (
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)
    fn = jax.jit(jax.vmap(ue_dl_subframe(cell, CONFIG["sf_idx"], CONFIG["cfi"], grant,
                                         max_iterations=CONFIG["max_iterations"])))
    ref_tb, ref_ok, ref_snr = (np.asarray(v) for v in fn(rx))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        OUT, tx=tx, rx=rx, tb_packed=np.packbits(tb),
        ref_tb_packed=np.packbits(ref_tb, axis=-1), ref_crc_ok=ref_ok,
        ref_snr_db=ref_snr.astype(np.float32), tbs=np.int64(grant.tbs),
        **{k: np.asarray(v) for k, v in CONFIG.items()},
    )
    print(f"wrote {OUT}: tbs {grant.tbs}, crc_ok {ref_ok.tolist()}, "
          f"snr_db {ref_snr.tolist()}, TB equal {(ref_tb == tb).all(axis=1).tolist()}")


if __name__ == "__main__":
    main()
    main_dynamic()
    main_mimo()
    main_ul()
    main_ul_dynamic()
    main_windows()
    main_gen_windows()
    main_ctrl_windows()
    main_ue_dl_frame()
    main_enb_ul()
    main_stack()
