"""On the card only; skipped without a CUDA device.  Run on the chip with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mmse4_card.py

(`--noconftest`: the suite's conftest imports JAX, which that machine
lacks).  The 4x4 cell `dl_mimo4x4-b128-hisnr` on batches made as
`lte_bench/stimuli.py` makes them:

- the `mmse4` kernel against its plain form `mmse4_plain` on the front
  end's y, h and noise of a pool batch (128 subframes x 6800 REs): x within
  X_TOL of its largest magnitude, the CSI within CSI_TOL relative.  Both
  run the same operations in float32 in the same order; the kernel's
  compiler fuses products and sums (FMA), the plain form rounds each
  product, so they differ by a few units in the last place of the sums,
  amplified by the solve (A's condition number ~10 on this channel): 6.8e-7
  (x) and 9.2e-7 (csi) on the H100 at seed 2^31 + 2600;
- the graphed 4x4 entry (`graphs.Graphed`, from a shape's third call)
  against its eager first call, on two batches in turn: identical TB bits,
  CRC flags and snr_db, and one `mmse4_launches` a call;
- the cell's run is correct, and the bf16 control (the plain reference
  one precision down) fails at least one of its three limits.
"""

from pathlib import Path

import pytest
import torch

from lte_bench import catalog, control, run, stimuli
from srsran_tpu_torch import graphs
from srsran_tpu_torch.device import table
from srsran_tpu_torch.graphs import run as run_steps
from srsran_tpu_torch.phy import mimo_cuda
from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.phy.mimo import _codebook_4
from srsran_tpu_torch.pipeline import _dl_front_end
from srsran_tpu_torch.runtime.trace import counts

pytestmark = pytest.mark.card

REPO = Path(__file__).resolve().parents[1]
CELL = "dl_mimo4x4-b128-hisnr"
SEED = 2**31 + 2604
X_TOL, CSI_TOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def cell_pool():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the chip "
                    "(python -m pytest --noconftest tests/test_torch_mmse4_card.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _w, cfg, mix = catalog.cell(REPO, CELL)
    link = catalog.link(cfg)
    sent = stimuli.draw_tbs(SEED, mix["n_tbs"], cfg["grant"]["tbs"])
    clean = torch.from_numpy(stimuli.render(link, cfg, sent)).to(dev)
    return dev, cfg, link, stimuli.build_pool(clean, dict(mix, pool_batches=2), SEED)


def test_kernel_matches_its_plain_form(cell_pool):
    dev, cfg, _link, pool = cell_pool
    c = cfg["cell"]
    cell = Cell(nof_prb=c["nof_prb"], nof_ports=4, id=c["cell_id"])
    prb = tuple(range(cfg["grant"]["nof_prb"]))
    _n_re, front_end = _dl_front_end(cell, c["sf_idx"], c["cfi"], prb, 4, dev)
    s = run_steps(front_end, {"samples": pool[0]})
    y, h, noise = s["y"], s["h"], s["noise"].reshape(-1)
    assert tuple(h.shape) == (128, 4, 4, 6800)
    w = table(_codebook_4, cfg["grant"]["pmi"], 4, device=dev)
    x, csi = mimo_cuda.mmse4(y, h, w, noise)
    px, pcsi = mimo_cuda.mmse4_plain(y, h, w, noise)
    torch.cuda.synchronize()
    assert float((x - px).abs().max()) <= X_TOL * float(px.abs().max())
    assert float(((csi - pcsi) / pcsi).abs().max()) <= CSI_TOL


def test_graphed_entry_is_the_eager_entry(cell_pool):
    dev, cfg, link, pool = cell_pool
    graphs.ENTRIES.by_device.clear()
    graphs.ENTRIES.seen.clear()
    eager = [[t.cpu() for t in link.build_entry(cfg, [dev])(x)] for x in pool]
    assert all(bool(e[1].all()) for e in eager)
    fn = link.build_entry(cfg, [dev])
    for n, j in enumerate([0, 1, 0, 1]):
        before = counts()
        got = [t.cpu() for t in fn(pool[j])]
        after = counts()
        for a, b in zip(got, eager[j]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        launches = after.get("mmse4_launches", 0) - before.get("mmse4_launches", 0)
        # the capture call (the second) also runs its step once eagerly
        assert launches == (2 if n == 1 else 1)
        if n >= 2:
            assert after["entry_graph_replays"] == before.get("entry_graph_replays", 0) + 1
    graphs.ENTRIES.by_device.clear()
    graphs.ENTRIES.seen.clear()


def test_cell_is_correct_and_the_control_is_not(cell_pool):
    dev, cfg, _link, _pool = cell_pool
    result, _lines = run.run_cell(CELL, SEED, 2.0, False, device=dev)
    assert result["correct"], result["checks"]
    result, _lines = run.run_cell(CELL, SEED, 2.0, False, device=dev,
                                  entry=control.entry(cfg["control"]))
    assert not result["correct"], result["checks"]
