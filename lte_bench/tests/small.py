"""A checkout-shaped directory with small cells for the CPU tests: the
real configurations cut to 25 PRB (their limits kept), and a mix of 4
subframes a batch."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SMALL_MIX = dict(name="b4-n090", batch=4, noise_amp=0.09, n_tbs=4, pool_batches=2)


def make_root(tmp: Path) -> Path:
    """tmp/BENCHMARK.json and tmp/lte_bench/{configs,traffic}: the real
    files, and two small cells, `dl_small` and `ul_small`."""
    (tmp / "lte_bench").mkdir(parents=True, exist_ok=True)
    for sub in ("configs", "traffic"):
        shutil.copytree(REPO / "lte_bench" / sub, tmp / "lte_bench" / sub, dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    dl = json.loads((REPO / "lte_bench/configs/lte20_fdd_dl_siso.json").read_text())
    dl["name"] = "small_dl"
    dl["cell"]["nof_prb"] = 25
    dl["grant"].update(nof_prb=25, mod="QAM16", tbs=9144)
    ul = json.loads((REPO / "lte_bench/configs/lte20_fdd_ul_pusch.json").read_text())
    ul["name"] = "small_ul"
    ul["cell"]["nof_prb"] = 25
    ul["grant"].update(nof_prb=24, mod="QPSK", tbs=4008)
    for c in (dl, ul):
        (tmp / "lte_bench/configs" / f"{c['name']}.json").write_text(json.dumps(c))
    (tmp / "lte_bench/traffic/b4-n090.json").write_text(json.dumps(SMALL_MIX))
    cells = [dict(name="dl_small", config="small_dl", traffic="b4-n090", chips=1, why="test"),
             dict(name="ul_small", config="small_ul", traffic="b4-n090", chips=1, why="test")]
    bench["workloads"] += cells
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + [c["name"] for c in cells]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
