"""A checkout-shaped directory with a small 4x4 TM4 cell for the CPU tests,
beside `small_mimo.py`'s: the real files, and the configuration
`lte10_fdd_dl_tm4_4x4` cut to 6 PRB (768 PDSCH REs; MCS 26 with the
two-layer TBS at 12 PRB, 7224 bits, two code blocks a codeword; its limits
kept) under a mix of 4 subframes a batch, as the cell `tm4x4_small`."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from lte_bench.tests.small import REPO

MIX = dict(name="b4-n020", batch=4, noise_amp=0.02, n_tbs=4, pool_batches=2)
CELL = "tm4x4_small"
NOF_PRB, TBS = 6, 7224


def make_root(tmp: Path) -> Path:
    (tmp / "lte_bench").mkdir(parents=True, exist_ok=True)
    for sub in ("configs", "traffic"):
        shutil.copytree(REPO / "lte_bench" / sub, tmp / "lte_bench" / sub, dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "lte_bench/configs/lte10_fdd_dl_tm4_4x4.json").read_text())
    cfg["name"] = "small_tm4x4"
    cfg["cell"]["nof_prb"] = NOF_PRB
    cfg["grant"].update(nof_prb=NOF_PRB, tbs=TBS)
    (tmp / "lte_bench/configs/small_tm4x4.json").write_text(json.dumps(cfg))
    (tmp / "lte_bench/traffic/b4-n020.json").write_text(json.dumps(MIX))
    bench["workloads"].append(dict(name=CELL, config="small_tm4x4", traffic="b4-n020", chips=1,
                                   why="test"))
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + [CELL]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
