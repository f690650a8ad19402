"""The benchmark's files: BENCHMARK.json against the contract's shape,
every configuration, mix and metric found by name, and a new cell made of
new files alone."""

from __future__ import annotations

import json
import re

import pytest

from lte_bench import catalog
from lte_bench.tests.small import REPO, make_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lte_bench"] and BENCH["command"] == ["python3", "lte_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer") for m in BENCH[k])
    assert len({x["name"] for x in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(cell):
    w, cfg, mix = catalog.cell(REPO, cell)
    assert cfg["name"] == w["config"] and mix["name"] == w["traffic"]
    assert catalog.link(cfg).build_entry
    for key in ("source", "link", "entry", "cell", "grant", "max_iterations", "limits",
                "assumed", "reduced", "control"):
        assert key in cfg
    assert set(cfg["limits"]) == set(catalog.link(cfg).CHECKS)
    if "tb_wrong" in cfg["limits"]:
        assert cfg["limits"]["tb_wrong"] == 0
    if "crc_diff" in cfg["limits"]:
        assert cfg["limits"]["crc_diff"] < mix["batch"]
    assert set(mix) == {"name", "batch", "noise_amp", "n_tbs", "pool_batches"}
    for m in catalog.per_layer(REPO, cell):
        assert callable(catalog.reader(m["name"]))


def test_config_grants_match_the_program_tables():
    """Each configuration's TBS and modulation are those its MCS gives."""
    from srsran_tpu_torch.phy.phch.ra import (
        dl_mcs_to_mod, dl_tbs, tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod)

    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        g = cfg["grant"]
        if cfg["link"] == "pusch":
            assert (ul_mcs_to_mod(g["mcs"]).name, tbs_lookup(ul_mcs_to_itbs(g["mcs"]), g["nof_prb"])) \
                == (g["mod"], g["tbs"])
        else:
            assert (dl_mcs_to_mod(g["mcs"]).name, dl_tbs(g["mcs"], g["nof_prb"])) == (g["mod"], g["tbs"])


def test_new_cell_from_new_files_only(tmp_path):
    """A cell made of a new mix file and a new BENCHMARK.json entry is found
    and listed, with its per-layer metrics, and no code is touched."""
    root = make_root(tmp_path)
    mix = dict(name="b32-n050", batch=32, noise_amp=0.05, n_tbs=8, pool_batches=4)
    (root / "lte_bench/traffic/b32-n050.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="dl_siso-b32-n050", config="lte20_fdd_dl_siso",
                                   traffic="b32-n050", chips=1, why="a throwaway cell"))
    bench["per_layer"][0]["workloads"].append("dl_siso-b32-n050")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert "dl_siso-b32-n050" in catalog.cells(root)
    w, cfg, found = catalog.cell(root, "dl_siso-b32-n050")
    assert found == mix and cfg["name"] == "lte20_fdd_dl_siso"
    assert [m["name"] for m in catalog.per_layer(root, "dl_siso-b32-n050")] == [
        bench["per_layer"][0]["name"]]
    with pytest.raises(KeyError):
        catalog.cell(root, "no-such-cell")
