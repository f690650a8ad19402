"""The 4x4 TM4 cell (`links/pdsch_tm4_4x4.py`, `ref/tx_mimo4.py`,
`ref/rx_mimo4.py`, `mmse4_yardstick.py`, `metrics/mmse4_roofline_pct.py`,
`metrics/mmse4_launches.py`) on the CPU at 6 PRB (`small_mimo4.py`): the
reference decodes its own transmitter's subframes and gives the program's
results, the program's run is correct, and the control, a stale result,
swapped codewords, a flipped bit and a detector in half precision or
without its noise term are not; the readers.  On the card
(`-m card`): a short traced run of the real cell."""

from __future__ import annotations

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lte_bench import catalog, control, mmse4_yardstick, run, stimuli
from lte_bench.metrics import mmse4_launches, mmse4_roofline_pct
from lte_bench.ref import tx_mimo
from lte_bench.tests.small import REPO
from lte_bench.tests.small_mimo4 import CELL, make_root

CELL_REAL = "dl_mimo4x4-b128-hisnr"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


def _run(root, entry=None, seed=2**31 + 126):
    result, lines = run.run_cell(CELL, seed, 0.6, False, root=root, device="cpu", entry=entry)
    assert list(result)[-1] == "checks" and lines[-1].startswith("check ")
    return result


def _broken(fault):
    """An entry that wraps the program's with one fault."""

    def build(cfg, link, devices):
        fn = link.build_entry(cfg, devices)
        last = []

        def stale(x):
            # the previous call's results
            out = fn(x)
            prev = last[0] if last else out
            last[:] = [out]
            return prev

        def swapped(x):
            # codeword 1's results given as codeword 0's, and back
            tb, ok, snr, layers = fn(x)
            return tb.flip(1), ok.flip(1), snr, layers

        def altered(x):
            # one bit of codeword 1's TB flipped where it is produced
            tb, ok, snr, layers = fn(x)
            tb = tb.clone()
            tb[0, 1, 0] ^= 1
            return tb, ok, snr, layers

        return {"stale": stale, "swapped": swapped, "altered": altered}[fault]

    return build


def test_reference_decodes_its_transmitter_and_gives_the_programs_results(root):
    """Both codewords of every subframe pass and carry the TBs sent on them;
    the program's CRC flags and TB bits are the reference's, its snr_db
    within 1e-5 dB."""
    _w, cfg, mix = catalog.cell(root, CELL)
    link = catalog.link(cfg)
    sent = stimuli.draw_tbs(4, mix["n_tbs"], cfg["grant"]["tbs"])
    pool = stimuli.build_pool(torch.from_numpy(stimuli.render(link, cfg, sent)), mix, 4)
    assert tuple(pool.shape[1:3]) == (mix["batch"], 4)
    r_tb, r_ok, r_snr, r_x = link.reference(pool[0], cfg)
    want = np.stack([sent, tx_mimo.second_tb(cfg, sent)], 1)[stimuli.tb_index(mix)[0]]
    assert bool(r_ok.all()) and torch.equal(r_tb, torch.from_numpy(want))
    tb, ok, snr, x = link.build_entry(cfg, ["cpu"])(pool[0])
    assert torch.equal(ok, r_ok) and torch.equal(tb, r_tb)
    assert float((snr - r_snr).abs().max()) <= 1e-5
    assert x.shape == r_x.shape == (4, 768) and x.dtype == r_x.dtype == torch.complex64
    assert float((x - r_x).abs().max()) <= cfg["limits"]["mmse_gap"] * float(r_x.abs().max())
    assert link.tally((tb, ok, snr, x), cfg) == (mix["batch"],
                                                 2 * mix["batch"] * cfg["grant"]["tbs"])
    assert link.map_launch_shape(cfg, 128) == (2 * 2 * 128, 3648)
    assert link.mmse_shape(cfg, 128) == (128, 768)


def test_program_is_correct(root):
    result = _run(root)
    assert result["correct"] and result["failed"] == 0
    assert result["metrics"]["tb_mbps"]["value"] > 0


def test_control_is_not_correct(root):
    _w, cfg, _mix = catalog.cell(root, CELL)
    result = _run(root, control.entry(cfg["control"]))
    assert not result["correct"]
    assert result["checks"]["snr_gap_db"]["value"] > result["checks"]["snr_gap_db"]["limit"]
    assert result["checks"]["mmse_gap"]["value"] > result["checks"]["mmse_gap"]["limit"]


@pytest.mark.parametrize("fault", ["stale", "swapped", "altered"])
def test_fault_is_not_correct(root, fault):
    result = _run(root, _broken(fault))
    assert not result["correct"]
    assert result["checks"]["tb_wrong"]["value"] > result["checks"]["tb_wrong"]["limit"]


@pytest.mark.parametrize("detector", ["zero_forcing", "bf16", "fp16"])
def test_detector_fault_is_not_correct(root, monkeypatch, detector):
    """The program's 4x4 MMSE without its noise term, or with its output
    rounded to half precision, decodes the same bits and snr_db at this
    SNR: only `mmse_gap` sees it."""
    from srsran_tpu_torch import pipeline

    exact = pipeline.mmse4

    def faulty(y, h, w, noise):
        if detector == "zero_forcing":
            return exact(y, h, w, torch.full_like(noise, 1e-12))
        x, csi = exact(y, h, w, noise)
        low = getattr(torch, {"bf16": "bfloat16", "fp16": "float16"}[detector])
        return torch.complex(x.real.to(low).float(), x.imag.to(low).float()), csi

    monkeypatch.setattr(pipeline, "mmse4", faulty)
    result = _run(root)
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert not result["correct"]
    assert checks["mmse_gap"] > 2 * result["checks"]["mmse_gap"]["limit"]
    assert checks["tb_wrong"] == checks["crc_diff"] == 0


def test_traced_run_on_the_cpu_reads_the_counters(root, monkeypatch):
    """A traced run on the CPU (no device trace there): one 4x4 detection
    per entry call (the counters of this run alone), and no roofline
    without the kernel's trace."""
    from srsran_tpu_torch.runtime import trace

    monkeypatch.setattr(trace, "COUNTS", {})
    result, _lines = run.run_cell(CELL, 2**31 + 8, 0.2, True, root=root, device="cpu")
    assert result["correct"]
    assert result["metrics"]["mmse4_launches"]["value"] == pytest.approx(1.0)
    assert "mmse4_roofline_pct" not in result["metrics"]


def test_the_two_layer_tbs():
    """Each codeword of the configuration is a TB on two layers: for N_PRB
    <= 55 the one-layer table at 2 N_PRB (TS 36.213 7.1.7.2.2), in the
    program's table; its MCS gives the modulation."""
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_itbs, dl_mcs_to_mod, tbs_lookup

    g = catalog.config(REPO, "lte10_fdd_dl_tm4_4x4")["grant"]
    assert g["nof_layers"] == 4 and g["nof_codewords"] == 2 and g["nof_prb"] <= 55
    assert tbs_lookup(dl_mcs_to_itbs(g["mcs"]), 2 * g["nof_prb"]) == g["tbs"] == 61664
    assert dl_mcs_to_mod(g["mcs"]).name == g["mod"]


def test_mmse4_yardstick():
    """208 bytes an RE bind: 0.054 ms at 128 x 6800 REs."""
    assert mmse4_yardstick.BYTES_PER_RE == 208
    ms, by = mmse4_yardstick.mmse4_bound(128, 6800)
    assert by == "bytes" and ms == pytest.approx(128 * 6800 * 208 / 3.35e12 * 1e3)
    assert 800 < mmse4_yardstick.ops_per_re() < 1600


def test_mmse4_readers_on_synthetic_inputs(monkeypatch):
    """The roofline over the mean launch of `mmse4_kernel` (by name); None
    without it.  The launches over the entry calls; None without them."""
    kernels = [("void (anonymous namespace)::mmse4_kernel(float2 const*)", 0.0, 1e-4),
               ("void (anonymous namespace)::mmse4_kernel(float2 const*)", 1.0, 1.0 + 3e-4),
               ("other", 0.0, 0.5)]
    link = catalog.link(catalog.config(REPO, "lte10_fdd_dl_tm4_4x4"))
    ctx = SimpleNamespace(trace=SimpleNamespace(kernels=kernels), link=link,
                          cfg=catalog.config(REPO, "lte10_fdd_dl_tm4_4x4"), mix={"batch": 128})
    bound, _by = mmse4_yardstick.mmse4_bound(128, 6800)
    assert mmse4_roofline_pct.read(ctx) == pytest.approx(100.0 * bound / 0.2)
    ctx.trace.kernels = kernels[2:]
    assert mmse4_roofline_pct.read(ctx) is None

    from srsran_tpu_torch.runtime import trace

    monkeypatch.setattr(trace, "counts", lambda: {"entry_calls": 40, "mmse4_launches": 42})
    assert mmse4_launches.read(ctx) == pytest.approx(1.05)
    monkeypatch.setattr(trace, "counts", lambda: {"entry_calls": 40})
    assert mmse4_launches.read(ctx) is None


def test_the_4x4_reference_imports_nothing_of_the_program():
    code = ("import lte_bench.ref.rx_mimo4, lte_bench.ref.tx_mimo4, lte_bench.links.pdsch_tm4_4x4\n"
            "import lte_bench.mmse4_yardstick\n"
            "import sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    names = set(subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                               text=True, check=True,
                               env=dict(os.environ, PYTHONPATH=str(REPO))).stdout.split())
    assert "lte_bench" in names
    assert not names & {"jax", "jaxlib", "flax", "srsran_tpu", "srsran_tpu_torch"}


@pytest.mark.card
def test_cell_traced_on_the_card(cuda_device):
    """A short traced run of the real cell: correct, every metric of the
    cell read, the kernel on the path once a call, its share of its
    roofline at most 100%, the entry replayed.  A 2-s traced run makes ~70
    entry calls, 4 of which run eagerly or capture (the run's entry and the
    readers' own, two calls each): `entry_graphed_pct` reads ~94 there and
    99.95 in a 51-s run."""
    result, _lines = run.run_cell(CELL_REAL, 2**31 + 27, 2.0, True, device=cuda_device)
    assert result["correct"] and result["device"]["platform"] == "gpu"
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(m) == {x["name"] for x in catalog.per_layer(REPO, CELL_REAL)}
    assert m["mimo_detect_ms"] > 0 and m["frontend_ms"] >= m["fft_ms"] + m["mimo_detect_ms"]
    assert 1.0 <= m["mmse4_launches"] < 1.1 and 0 < m["mmse4_roofline_pct"] <= 100.0
    assert m["entry_graphed_pct"] >= 90.0
