"""A checkout-shaped directory with a small 2x2 TM4 cell for the CPU
tests, beside `small.py`'s: the real files, and the configuration
`lte20_fdd_dl_tm4_2x2` cut to 25 PRB and QAM16 (its limits kept) under a
mix of 4 subframes a batch, as the cell `tm4_small`."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from lte_bench.tests.small import REPO

MIX = dict(name="b4-n090", batch=4, noise_amp=0.09, n_tbs=4, pool_batches=2)
CELL = "tm4_small"


def make_root(tmp: Path) -> Path:
    (tmp / "lte_bench").mkdir(parents=True, exist_ok=True)
    for sub in ("configs", "traffic"):
        shutil.copytree(REPO / "lte_bench" / sub, tmp / "lte_bench" / sub, dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "lte_bench/configs/lte20_fdd_dl_tm4_2x2.json").read_text())
    cfg["name"] = "small_tm4"
    cfg["cell"]["nof_prb"] = 25
    cfg["grant"].update(nof_prb=25, mod="QAM16", tbs=9144)
    (tmp / "lte_bench/configs/small_tm4.json").write_text(json.dumps(cfg))
    (tmp / "lte_bench/traffic/b4-n090.json").write_text(json.dumps(MIX))
    bench["workloads"].append(dict(name=CELL, config="small_tm4", traffic="b4-n090", chips=1,
                                   why="test"))
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + [CELL]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
