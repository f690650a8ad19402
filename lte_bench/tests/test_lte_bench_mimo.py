"""The 2x2 TM4 cell (`links/pdsch_tm4.py`, `ref/tx_mimo.py`,
`ref/rx_mimo.py`, `metrics/mimo_detect_ms.py`) on the CPU at 25 PRB and
QAM16 (`small_mimo.py`): the reference gives the program's results, the
program's run is correct, and the control and a broken program are not;
the `fe.mimo` reader.  On the card (`-m card`): a short traced run of the
real cell."""

from __future__ import annotations

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lte_bench import catalog, control, run, stages, stimuli
from lte_bench.metrics import frontend_ms, mimo_detect_ms
from lte_bench.ref import tx_mimo
from lte_bench.tests.small import REPO
from lte_bench.tests.small_mimo import CELL, make_root

CELL_REAL = "dl_mimo2x2-b64-n045"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


def _run(root, entry=None, seed=2**31 + 99):
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
            tb, ok, snr = fn(x)
            return tb.flip(1), ok.flip(1), snr

        def altered(x):
            # one bit of codeword 1's TB flipped where it is produced
            tb, ok, snr = fn(x)
            tb = tb.clone()
            tb[0, 1, 0] ^= 1
            return tb, ok, snr

        return {"stale": stale, "swapped": swapped, "altered": altered}[fault]

    return build


def test_reference_gives_the_programs_results(root):
    """Both codewords' CRC flags and TB bits equal the program's, every TB
    is the one sent on its codeword, and snr_db lies within 1e-5 dB."""
    _w, cfg, mix = catalog.cell(root, CELL)
    link = catalog.link(cfg)
    sent = stimuli.draw_tbs(3, mix["n_tbs"], cfg["grant"]["tbs"])
    pool = stimuli.build_pool(torch.from_numpy(stimuli.render(link, cfg, sent)), mix, 3)
    tb, ok, snr = link.build_entry(cfg, ["cpu"])(pool[0])
    r_tb, r_ok, r_snr = link.reference(pool[0], cfg)
    assert tb.shape == (mix["batch"], 2, cfg["grant"]["tbs"]) and ok.shape == (mix["batch"], 2)
    assert ok.all() and torch.equal(ok, r_ok) and torch.equal(tb, r_tb)
    want = np.stack([sent, tx_mimo.second_tb(cfg, sent)], 1)[stimuli.tb_index(mix)[0]]
    assert torch.equal(tb, torch.from_numpy(want))
    assert float((snr - r_snr).abs().max()) <= 1e-5
    assert link.tally((tb, ok, snr), cfg) == (mix["batch"], 2 * mix["batch"] * cfg["grant"]["tbs"])
    ok[0, 1] = False
    assert link.tally((tb, ok, snr), cfg) == (mix["batch"] - 1,
                                              (2 * mix["batch"] - 1) * cfg["grant"]["tbs"])


def test_program_is_correct(root):
    result = _run(root)
    assert result["correct"] and result["failed"] == 0
    assert result["metrics"]["tb_mbps"]["value"] > 0


def test_control_is_not_correct(root):
    _w, cfg, _mix = catalog.cell(root, CELL)
    result = _run(root, control.entry(cfg["control"]))
    assert not result["correct"]
    assert result["checks"]["snr_gap_db"]["value"] > result["checks"]["snr_gap_db"]["limit"]


@pytest.mark.parametrize("fault", ["stale", "swapped", "altered"])
def test_fault_is_not_correct(root, fault):
    result = _run(root, _broken(fault))
    assert not result["correct"]
    assert result["checks"]["tb_wrong"]["value"] > result["checks"]["tb_wrong"]["limit"]


def test_traced_run_on_the_cpu_reads_the_counter(root):
    """A traced run on the CPU (no device trace there): the readers'
    stretch reads `host_reads`, the turbo loop's reads alone (at least two),
    and the device readers, `mimo_detect_ms` among them, find no kernels."""
    result, _lines = run.run_cell(CELL, 2**31 + 7, 0.2, True, root=root, device="cpu")
    assert result["correct"]
    assert result["metrics"]["host_reads_per_batch"]["value"] >= 2
    assert not {"frontend_ms", "mimo_detect_ms"} & set(result["metrics"])


def test_mimo_reader_takes_the_fe_mimo_kernels():
    """On a synthetic stretch: `fe.mimo` kernels are `mimo_detect_ms`'s and
    also the front end's; a stretch without the span reads None."""
    events = [("span", "fe.equalize", 0.0, 1.0, 1, 0), ("span", "fe.mimo", 0.2, 0.8, 2, 0),
              ("op", "aten::index", 0.1, 0.15, 3, 0), ("op", "aten::mul", 0.3, 0.4, 4, 0),
              ("launch", "cudaLaunchKernel", 0.12, 0.13, 101, 3),
              ("launch", "cudaLaunchKernel", 0.35, 0.36, 102, 4),
              ("device", "index_elementwise_kernel", 0.2, 0.22, 101, 3),
              ("device", "vectorized_elementwise_kernel", 0.4, 0.46, 102, 4)]
    red = stages.by_span(events)
    ctx = SimpleNamespace(stages=SimpleNamespace(kernels=red.kernels, totals=red.totals,
                                                 batches=2, host_reads=None))
    assert mimo_detect_ms.read(ctx) == pytest.approx(30.0)  # 0.06 s over 2 batches
    assert frontend_ms.read(ctx) == pytest.approx(40.0)
    red = stages.by_span([e for e in events if e[1] != "fe.mimo"])
    ctx.stages = SimpleNamespace(kernels=red.kernels, totals=red.totals, batches=2, host_reads=None)
    assert mimo_detect_ms.read(ctx) is None
    assert mimo_detect_ms.read(SimpleNamespace(stages=None)) is None


def test_the_2x2_reference_imports_nothing_of_the_program():
    code = ("import lte_bench.ref.rx_mimo, lte_bench.ref.tx_mimo, lte_bench.links.pdsch_tm4\n"
            "import sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    names = set(subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                               text=True, check=True,
                               env=dict(os.environ, PYTHONPATH=str(REPO))).stdout.split())
    assert "lte_bench" in names
    assert not names & {"jax", "jaxlib", "flax", "srsran_tpu", "srsran_tpu_torch"}


@pytest.mark.card
def test_cell_traced_on_the_card(cuda_device):
    """A short traced run of the real cell: correct, with the 2x2 front
    end's metric, inside the front end's."""
    result, _lines = run.run_cell(CELL_REAL, 2**31 + 21, 2.0, True, device=cuda_device)
    assert result["correct"] and result["device"]["platform"] == "gpu"
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(m) == {x["name"] for x in catalog.per_layer(REPO, CELL_REAL)}
    assert m["mimo_detect_ms"] > 0 and m["frontend_ms"] >= m["fft_ms"] + m["mimo_detect_ms"]
    assert m["map_roofline_pct"] <= 100.0
