"""The readers of the program's stages (`stages.py`): the reduction by
span on synthetic event lists, and the readers' own stretch on the CPU."""

from __future__ import annotations

import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from lte_bench import catalog, run, stages
from lte_bench.metrics import frontend_ms, host_reads_per_batch, tb_decode_ms, turbo_loop_ms
from lte_bench.tests.small import REPO, make_root

MAP = "void (anonymous namespace)::map_window_kernel<false>(float const*)"
READERS = (frontend_ms, tb_decode_ms, turbo_loop_ms, host_reads_per_batch)


def _stretch():
    """Events of a stretch: (kind, name, start_s, end_s, correlation id,
    linked correlation id).  Host ranges nest: entry > fe.ofdm; entry >
    tbd.turbo > turbo.iter; a kernel launched in entry outside every
    program span; a copy, which is no kernel."""
    host = [("span", "entry", 0.0, 1.0, 1, 0), ("span", "fe.ofdm", 0.1, 0.2, 2, 0),
            ("op", "aten::fft_c2c", 0.11, 0.15, 3, 0),
            ("span", "tbd.turbo", 0.3, 0.8, 4, 0), ("span", "turbo.iter", 0.4, 0.6, 5, 0),
            ("op", "aten::index", 0.41, 0.42, 6, 0), ("span", "tbd.crc", 0.85, 0.9, 7, 0),
            ("op", "aten::log10", 0.95, 0.96, 8, 0)]
    launches = [("launch", "cudaLaunchKernel", 0.12, 0.13, 101, 3),
                ("launch", "cudaLaunchKernel", 0.415, 0.416, 102, 6),
                ("launch", "cuLaunchKernel", 0.5, 0.51, 103, 5),
                ("launch", "cudaLaunchKernel", 0.955, 0.956, 105, 8),
                ("launch", "cudaMemcpyAsync", 0.97, 0.98, 106, 0)]
    device = [("device", "regular_fft", 0.2, 0.25, 101, 3),
              ("device", "index_elementwise_kernel", 0.45, 0.47, 102, 6),
              ("device", MAP, 0.52, 0.6, 103, 5),
              # no runtime call of its own in the stretch: its linked host op
              ("device", "reduce_kernel", 0.86, 0.87, 999, 7),
              ("device", "vectorized_elementwise_kernel", 0.96, 0.965, 105, 8),
              ("device", "Memcpy DtoH (Device -> Pinned)", 0.98, 0.99, 106, 0)]
    return host + launches + device


def _ctx(red, host_reads=None):
    st = SimpleNamespace(kernels=red.kernels, totals=red.totals, batches=2,
                         host_reads=host_reads)
    return SimpleNamespace(stages=st)


def test_innermost_span_takes_the_kernel():
    owners = {name: span for span, name, _s in stages.by_span(_stretch()).kernels}
    assert owners == {"regular_fft": "fe.ofdm", "index_elementwise_kernel": "turbo.iter",
                      MAP: "turbo.iter", "reduce_kernel": "tbd.crc",
                      "vectorized_elementwise_kernel": stages.UNATTRIBUTED}


def test_span_totals_and_unattributed_make_the_kernel_time():
    records = _stretch()
    red = stages.by_span(records)
    kernel_s = sum(b - a for kind, n, a, b, _c, _l in records
                   if kind == "device" and not n.startswith("Memcpy"))
    assert sum(red.totals.values()) == pytest.approx(kernel_s)
    assert red.totals[stages.UNATTRIBUTED] == pytest.approx(0.005)
    ctx = _ctx(red, host_reads=4.5)
    assert frontend_ms.read(ctx) == pytest.approx(25.0)  # 0.05 s over 2 batches
    assert tb_decode_ms.read(ctx) == pytest.approx(5.0)
    assert turbo_loop_ms.read(ctx) == pytest.approx(10.0)  # the MAP kernel left out
    assert host_reads_per_batch.read(ctx) == 4.5


def test_the_benchmarks_spans_are_not_the_programs():
    """With the benchmark's own span alone every kernel is unattributed and
    the span readers read nothing; a program without spans reads nothing
    at all."""
    red = stages.by_span([r for r in _stretch() if r[0] != "span" or r[1] == "entry"])
    assert set(red.totals) == {stages.UNATTRIBUTED}
    for reader in READERS[:3]:
        assert reader.read(_ctx(red)) is None
    for reader in READERS:
        assert reader.read(SimpleNamespace(stages=None)) is None


def test_innermost_of_nested_ranges():
    ranges = [("entry", 0.0, 1.0), ("tbd.turbo", 0.3, 0.8), ("turbo.iter", 0.4, 0.6)]
    assert stages.innermost(ranges, 0.5) == "turbo.iter"
    assert stages.innermost(ranges, 0.7) == "tbd.turbo"
    assert stages.innermost(ranges, 1.5) is None


def test_run_seed_is_the_runs():
    argv = ["--workload", "x", "--seed", str(2**31 + 3), "--seconds", "51", "--trace", "1"]
    assert stages.run_seed(argv) == 2**31 + 3
    assert stages.run_seed(["-q", "lte_bench/tests"]) == 0


def test_a_program_without_spans_gives_nothing(monkeypatch):
    from srsran_tpu_torch.runtime import trace

    monkeypatch.setattr(trace, "tracer", SimpleNamespace(enabled=False))
    assert stages.measure({}, {}, None, 1) is None


@pytest.mark.parametrize("cell", ["dl_small", "ul_small"])
def test_traced_run_on_the_cpu_reads_the_counter(tmp_path, cell):
    """A traced run of a small cell on the CPU (no device trace there): the
    readers' stretch reads `host_reads` (at least the two reads of a turbo
    loop that stops after one iteration, three on the UL), the device
    readers find no kernels, and the program's tracer is off after."""
    from srsran_tpu_torch.runtime.trace import tracer

    result, _lines = run.run_cell(cell, 2**31 + 7, 0.2, True, root=make_root(tmp_path),
                                  device="cpu")
    assert result["correct"]
    reads = result["metrics"]["host_reads_per_batch"]["value"]
    assert reads >= (3 if cell == "ul_small" else 2)
    assert not {"frontend_ms", "tb_decode_ms", "turbo_loop_ms"} & set(result["metrics"])
    assert not tracer.enabled and not tracer._events


def test_readers_import_no_jax():
    names = subprocess.run(
        [sys.executable, "-c", "from lte_bench import catalog, stages\n"
         "[catalog.reader(m['name']) for m in catalog.benchmark('.')['per_layer']]\n"
         "import srsran_tpu_torch.runtime.trace, sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(REPO))).stdout.split()
    assert "srsran_tpu_torch" in names
    assert not set(names) & {"jax", "jaxlib", "flax", "srsran_tpu"}
    assert {m["name"] for m in catalog.benchmark(REPO)["per_layer"]} >= {
        "frontend_ms", "tb_decode_ms", "turbo_loop_ms", "host_reads_per_batch"}
