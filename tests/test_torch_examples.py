"""The port's example scripts (`srsran_tpu_torch/examples/`) on the CPU
(`--device cpu`), against the reference's `examples/` where they share an
output.

- The twin of `tests/test_e2e_apps.py::test_examples_pdsch_pair` at 6 PRB:
  `pdsch_enodeb` writes a cf32 file (within 2e-6 of the reference script's
  file, sample by sample), `cell_search` finds PCI 2 and the MIB, `pdsch_ue`
  decodes every TB and draws the scope; `cell_search` once more through
  `python -m` in a child process.
- The `pdsch_ue` CFO repair: at 0.2 of a subcarrier injected into the file,
  the reference script (which rotates by -cfo, doubling the offset) decodes
  no TB and exits 1; the port's decodes all 20.
- Each other script at a small size: `synch_file` on the file, `bler_sweep`
  at high SNR (no block lost), `dynamic_grants` per TTI and windowed,
  `windowed_link`, and `remote_rx` recording UDP datagrams.
- The card by default: without `--device` a script raises where there is no
  card.
"""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from srsran_tpu_torch.examples import (
    bler_sweep, cell_search, dynamic_grants, pdsch_enodeb, pdsch_ue, remote_rx, synch_file,
    windowed_link)
from srsran_tpu_torch.io import NetSink

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DEV = ["--device", "cpu"]
SAMPLE_ATOL = 2e-6
CFO = 0.2  # subcarriers


def run(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def load_reference(name: str):
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dl_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("examples") / "dl.cf32"
    rc, out = run(pdsch_enodeb.main, ["-o", str(path), "-p", "6", "-m", "4", "-n", "3", "-c", "2"] + DEV)
    assert rc == 0 and out.count("19200 samples") == 3
    return path


def test_pdsch_pair(dl_file, tmp_path):
    ref_path = tmp_path / "ref.cf32"
    load_reference("pdsch_enodeb").main(["-o", str(ref_path), "-p", "6", "-m", "4", "-n", "3", "-c", "2"])
    got, want = np.fromfile(dl_file, np.complex64), np.fromfile(ref_path, np.complex64)
    assert got.shape == want.shape == (3 * 19200,)
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_ATOL)
    rc, out = run(cell_search.main, ["-i", str(dl_file), "-p", "6"] + DEV)
    assert rc == 0 and "PCI=2" in out and "nof_prb=6" in out
    rc, out = run(pdsch_ue.main, ["-i", str(dl_file), "-p", "6", "--scope", str(tmp_path)] + DEV)
    assert rc == 0 and "total: 20/20 transport blocks CRC-OK" in out
    assert (tmp_path / "pdsch_const.png").exists()


def test_cell_search_as_a_module(dl_file):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "srsran_tpu_torch.examples.cell_search", "-i", str(dl_file),
                        "-p", "6"] + DEV, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "PCI=2" in p.stdout and "MIB: nof_prb=6 nof_ports=1 sfn=0" in p.stdout


def test_pdsch_ue_cfo_repair(dl_file, tmp_path):
    """The reference script doubles the offset it means to remove; the
    port's removes it (ROADMAP Queue 3)."""
    x = np.fromfile(dl_file, np.complex64)
    rotated = tmp_path / "cfo.cf32"
    (x * np.exp(2j * np.pi * CFO * np.arange(len(x)) / 128)).astype(np.complex64).tofile(rotated)
    ref_ue = load_reference("pdsch_ue")
    rc_ref, out_ref = run(ref_ue.main, ["-i", str(rotated), "-p", "6"])
    rc, out = run(pdsch_ue.main, ["-i", str(rotated), "-p", "6"] + DEV)
    assert rc_ref == 1 and "total: 0/" in out_ref
    assert rc == 0 and "total: 20/20 transport blocks CRC-OK" in out


def test_synch_file(dl_file):
    rc, out = run(synch_file.main, ["-i", str(dl_file), "-l", "9600", "-n", "6"] + DEV)
    assert rc == 0 and "6/6 frames above threshold" in out
    # each half frame holds one PSS (N_id_2 = 2 for PCI 2) at one offset
    peaks = re.findall(r"N_id_2 (\d)  peak @ +(\d+)", out)
    assert len(peaks) == 6 and {r for r, _ in peaks} == {"2"} and len({p for _, p in peaks}) == 1


def test_bler_sweep():
    rc, out = run(bler_sweep.main, ["--prb", "6", "--mcs", "7", "--snr", "20:24:4", "--batch", "4"] + DEV)
    rows = [line.split() for line in out.splitlines() if not line.startswith("#")]
    assert rc == 0 and len(rows) == 2
    assert all(r[1] == "0.0000" and r[2] == "4/4" for r in rows), out


@pytest.mark.parametrize("window", [0, 2])
def test_dynamic_grants(window):
    rc, out = run(dynamic_grants.main, ["--prb", "6", "--ttis", "4", "--window", str(window)] + DEV)
    assert rc == 0
    assert re.search(r"\n4/4 grants decoded", out), out


def test_windowed_link():
    rc, out = run(windowed_link.main, ["--prb", "6", "-w", "2", "--seed", "3"] + DEV)
    assert rc == 0 and "DL: 2/2 TBs" in out and "UL: 2/2 TBs" in out


def test_remote_rx(tmp_path):
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    chunk = (np.arange(1024) * (1 + 1j)).astype(np.complex64)
    out_path = tmp_path / "cap.cf32"
    res = {}
    th = threading.Thread(target=lambda: res.update(rc=run(remote_rx.main, [
        "--listen", str(port), "-o", str(out_path), "-n", "4096"] + DEV)))
    th.start()
    sink = NetSink("127.0.0.1", port)
    while th.is_alive():
        sink.write(np.tile(chunk, 4))  # datagrams of one chunk each: any start is aligned
        time.sleep(0.05)
    sink.close()
    rc, out = res["rc"]
    assert rc == 0 and "received 4096 samples" in out
    np.testing.assert_array_equal(np.fromfile(out_path, np.complex64), np.tile(chunk, 4))


def test_scripts_take_the_card_by_default(dl_file):
    for main, argv in ((cell_search.main, ["-i", str(dl_file)]), (bler_sweep.main, []),
                       (remote_rx.main, ["--listen", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def test_phase_37_runs(tmp_path):
    """`chip_smoke.py` phase 37's runs on the CPU at a small size, with
    their gates: the scripts at 6 PRB (MCS 4: at MCS 20 subframe 0 of a 6
    PRB cell, with PSS, SSS and PBCH, is coded above rate 1 and both
    packages' `pdsch_ue` lose it), the estimators at 25 PRB (both
    channels), the resamplers on one 30.72 Msps frame."""
    import chip_smoke

    ex = chip_smoke.examples_run("cpu", tmp_path, prb=6, mcs=4, frames=3, bler_batch=4,
                                 bler_snr="20:30:5")
    assert ex["pdsch_ue"]["tbs"] == ex["pdsch_ue child"]["tbs"] == 20
    assert [r["bler"] for r in ex["bler_sweep"]["rows"]][-1] == 0.0
    est = chip_smoke.estimators_run("cpu", nof_prb=25)
    assert est["dispersive"]["wiener"]["mse"] < est["dispersive"]["interpolate"]["mse"]
    assert all(v["card_vs_cpu"] == 0.0 for row in est.values() for v in row.values())
    res = chip_smoke.resampling_run("cpu")
    assert [v["n_out"] for v in res.values()] == [230400, 19200, 245760]
