"""`correct` on small cells on the CPU: the program's run is correct; the
control (the reference at the configuration's lower precision in the
program's place) and the program with its timed path broken underneath
are not.  The look for a card is skipped (`run_cell(device="cpu")`); the
rest of a run is the one the benchmark makes."""

from __future__ import annotations

import pytest
import torch

from lte_bench import catalog, control, run
from lte_bench.tests.small import make_root

CELLS = ("dl_small", "ul_small")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


def _run(root, cell, entry=None, seed=2**31 + 99):
    result, lines = run.run_cell(cell, seed, 0.6, False, root=root, device="cpu", entry=entry)
    assert list(result)[-1] == "checks" and lines[-1].startswith("check ")
    return result


def _broken(fault):
    """An entry that wraps the program's with one fault."""

    def build(cfg, link, devices):
        fn = link.build_entry(cfg, devices)
        last = []

        def stale(x):
            # returns the previous call's results: a step that leaves its
            # state unchanged
            out = fn(x)
            prev = last[0] if last else out
            last[:] = [out]
            return prev

        def half(x):
            # decodes half the batch; the other half is left out, failed,
            # with the mean snr_db of the rest
            tb, ok, snr = fn(x[: len(x) // 2])
            return (torch.cat([tb, torch.zeros_like(tb)]), torch.cat([ok, torch.zeros_like(ok)]),
                    torch.cat([snr, snr.mean().expand(len(snr))]))

        def altered(x):
            # one bit of a TB flipped where it is produced
            tb, ok, snr = fn(x)
            tb = tb.clone()
            tb[0, 0] ^= 1
            return tb, ok, snr

        return {"stale": stale, "half": half, "altered": altered}[fault]

    return build


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(root, cell):
    result = _run(root, cell)
    assert result["correct"] and result["failed"] == 0
    assert result["metrics"]["tb_mbps"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    _w, cfg, _mix = catalog.cell(root, cell)
    result = _run(root, cell, control.entry(cfg["control"]))
    assert not result["correct"]
    assert result["checks"]["snr_gap_db"]["value"] > result["checks"]["snr_gap_db"]["limit"]


@pytest.mark.parametrize("fault, caught_by", [("stale", "tb_wrong"), ("half", "crc_diff"),
                                              ("altered", "tb_wrong")])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(root, cell, fault, caught_by):
    result = _run(root, cell, _broken(fault))
    assert not result["correct"]
    assert result["checks"][caught_by]["value"] > result["checks"][caught_by]["limit"]
