"""The committed stimulus fixture of the port is what
`tools/make_torch_fixture.py` builds from the JAX reference, and the port
decodes its two stored noisy subframes (100 PRB MCS 26) as the reference
did."""

import importlib.util
from pathlib import Path

import numpy as np
import torch

from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.phy.modem import Mod
from srsran_tpu_torch.phy.phch.pdsch import DlGrant
from srsran_tpu_torch.pipeline import ue_dl_subframe

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def load_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixture", ROOT / "tools" / "make_torch_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_is_current():
    tool = load_tool()
    fx = np.load(tool.OUT)
    for key, val in tool.CONFIG.items():
        assert fx[key] == val, key
    tb, tx = tool.clean_tx()
    assert int(fx["tbs"]) == tb.size == 61664
    np.testing.assert_array_equal(np.unpackbits(fx["tb_packed"], count=tb.size), tb)
    # the reference's IFFT in complex64: equal up to its float32 rounding
    assert fx["tx"].dtype == np.complex64 and fx["tx"].shape == tx.shape == (30720,)
    np.testing.assert_allclose(fx["tx"], tx, rtol=0, atol=1e-6)
    assert fx["rx"].shape == (2, 1, 30720) and fx["ref_crc_ok"].shape == (2,)


def test_port_decodes_fixture_like_reference():
    fx = np.load(ROOT / "srsran_tpu_torch" / "testdata" / "ue_dl_siso_20mhz.npz")
    tbs = int(fx["tbs"])
    cell = Cell(nof_prb=int(fx["nof_prb"]), nof_ports=1, id=int(fx["cell_id"]))
    grant = DlGrant(prb=tuple(range(cell.nof_prb)), mod=Mod.QAM64, tbs=tbs)
    fn = ue_dl_subframe(cell, int(fx["sf_idx"]), int(fx["cfi"]), grant,
                        int(fx["max_iterations"]), device="cpu")
    tb, ok, snr_db = fn(torch.from_numpy(fx["rx"]))
    np.testing.assert_array_equal(
        tb.numpy(), np.unpackbits(fx["ref_tb_packed"], axis=-1, count=tbs))
    np.testing.assert_array_equal(ok.numpy(), fx["ref_crc_ok"])
    np.testing.assert_allclose(snr_db.numpy(), fx["ref_snr_db"], atol=1e-3)
