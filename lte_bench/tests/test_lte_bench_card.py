"""On the card only (`pytest lte_bench/tests -m card` on the chip): one
short run of every cell is correct and prints its metrics."""

from __future__ import annotations

import pytest

from lte_bench import catalog, run
from lte_bench.tests.small import REPO


@pytest.mark.card
@pytest.mark.parametrize("cell", catalog.cells(REPO))
def test_cell_runs_on_the_card(cuda_device, cell):
    result, _lines = run.run_cell(cell, 2**31 + 5, 1.0, False, device=cuda_device)
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {m["name"] for m in catalog.end_to_end(REPO, cell)}
