"""Finds a cell's parts by name: `BENCHMARK.json` at the checkout's root
names each cell's configuration and traffic mix, whose files are
`lte_bench/configs/<config>.json` and `lte_bench/traffic/<mix>.json`; a
per-layer metric's reader is `lte_bench/metrics/<metric>.py`, and a
configuration's `link` names its module in `lte_bench/links/`.  Adding a
cell, a configuration, a mix or a metric adds files and entries, and edits
no code.
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def config(root: Path, name: str) -> dict:
    cfg = load_json(Path(root) / "lte_bench" / "configs" / f"{check_name(name, 'config')}.json")
    if cfg.get("name") != name:
        raise ValueError(f"configuration file {name}.json names itself {cfg.get('name')!r}")
    return cfg


def traffic(root: Path, name: str) -> dict:
    mix = load_json(Path(root) / "lte_bench" / "traffic" / f"{check_name(name, 'traffic')}.json")
    if mix.get("name") != name:
        raise ValueError(f"traffic file {name}.json names itself {mix.get('name')!r}")
    return mix


def cell(root: Path, name: str) -> tuple[dict, dict, dict]:
    """(the cell's BENCHMARK.json entry, its configuration, its mix)."""
    for w in benchmark(root)["workloads"]:
        if w["name"] == name:
            return w, config(root, w["config"]), traffic(root, w["traffic"])
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def cells(root: Path) -> list[str]:
    return [w["name"] for w in benchmark(root)["workloads"]]


def per_layer(root: Path, cell_name: str) -> list[dict]:
    """The per-layer metrics that the cell reports: those without a
    `workloads` list and those whose list names it."""
    return [m for m in benchmark(root)["per_layer"]
            if "workloads" not in m or cell_name in m["workloads"]]


def end_to_end(root: Path, cell_name: str) -> list[dict]:
    return [m for m in benchmark(root)["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def link(cfg: dict):
    """The module that drives the configuration's entry point."""
    return importlib.import_module(f"lte_bench.links.{check_name(cfg['link'], 'link')}")


def reader(metric: str):
    """The `read(ctx)` function of a per-layer metric."""
    return importlib.import_module(f"lte_bench.metrics.{check_name(metric, 'metric').replace('.', '_')}").read
