#!/usr/bin/env python
"""Build the UE DL SISO stimulus fixture of the PyTorch port from the JAX
reference, on the CPU.

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

Run from the repo root:  JAX_PLATFORMS=cpu python tools/make_torch_fixture.py
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parents[1] / "srsran_tpu_torch" / "testdata" / "ue_dl_siso_20mhz.npz"
CONFIG = dict(nof_prb=100, cell_id=301, sf_idx=2, cfi=1, mcs=26, noise_amp=0.09,
              max_iterations=6, seed=20261016)


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
