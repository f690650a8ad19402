"""What the harness and the reference load, and the run without a card."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from lte_bench.tests.small import REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "srsran_tpu")


def _loaded(code: str) -> set[str]:
    """Top-level names of every module loaded by `code` in a fresh process."""
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
                          "{m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    return set(out.stdout.split())


def test_harness_imports_no_jax():
    """run.py with everything it loads of the program (the entry points,
    the launch counter), the links, metrics and tools: no top-level `jax`,
    `jaxlib`, `flax` or `srsran_tpu`, compared whole."""
    names = _loaded("import lte_bench.run, lte_bench.tracing, lte_bench.control\n"
                    "import lte_bench.links.pdsch_siso, lte_bench.links.pusch\n"
                    "import srsran_tpu_torch.pipeline, srsran_tpu_torch.phy.fec.turbo_cuda\n"
                    "from lte_bench import catalog\n"
                    "[catalog.reader(m) for m in ('kernels_per_batch', 'fft_ms', 'map_launches',"
                    " 'map_ms', 'map_roofline_pct', 'device_idle_pct')]")
    assert "srsran_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    names = _loaded("import lte_bench.ref.rx, lte_bench.ref.tx, lte_bench.ref.tables")
    assert not names & (set(FORBIDDEN) | {"srsran_tpu_torch"})


def test_no_old_records_read():
    """Nothing of the benchmark names the JAX package's TPU harness or its
    records."""
    for path in (REPO / "lte_bench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for name in ("bench.py", "BENCH_r", "MULTICHIP_", "bench_full", "BASELINE.json",
                     "import srsran_tpu\n", "from srsran_tpu import", "from srsran_tpu."):
            assert name not in text, (path, name)


def test_run_without_a_card_exits_non_zero():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "lte_bench/run.py", "--workload", "dl_siso-b128-n090",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA device" in out.stderr and out.stdout.strip() == ""


def test_run_outside_a_checkout_with_the_program_fails(tmp_path):
    """Only BENCHMARK.json and lte_bench/: the program is missing, the run
    fails and prints no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "lte_bench", tmp_path / "lte_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run([sys.executable, "lte_bench/run.py", "--workload", "dl_siso-b128-n090",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
