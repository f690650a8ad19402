"""The port's spans and counters (`srsran_tpu_torch/runtime/trace.py`) on
the CPU: `span` with the tracer off and on, the spans and the `host_reads`
counter of the two batched entry points, `ue_dl_subframe` and
`enb_ul_subframe`, and those of `turbo_decode_dyn`'s loop, under a CPU
`torch.profiler` run."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from srsran_tpu_torch.phy.common import LTE_CRC24A, Cell
from srsran_tpu_torch.phy.crc import crc_attach_np
from srsran_tpu_torch.phy.fec.cbsegm import qpp_interleaver_np
from srsran_tpu_torch.phy.fec.turbo import turbo_encode_np
from srsran_tpu_torch.phy.fec.turbo_dyn import crc_table_ab, turbo_decode_dyn
from srsran_tpu_torch.phy.modem import Mod
from srsran_tpu_torch.phy.phch import ra
from srsran_tpu_torch.phy.phch.pdsch import DlGrant
from srsran_tpu_torch.phy.phch.pusch import UlGrant
from srsran_tpu_torch.phy.ue.ue_ul import ue_ul_encode
from srsran_tpu_torch.pipeline import enb_dl_subframe_encode, enb_ul_subframe, ue_dl_subframe
from srsran_tpu_torch.runtime import trace
from srsran_tpu_torch.runtime.trace import EventTracer

torch.set_num_threads(1)

# span -> the span it lies in (None: directly in the entry's call)
NESTING = {"fe.ofdm": None, "fe.chest": None, "fe.equalize": None, "fe.demap": None,
           "tbd.rate_match": None, "tbd.turbo": None, "tbd.crc": None,
           "turbo.iter": "tbd.turbo", "turbo.stop_read": "tbd.turbo"}


def _annotations(prof) -> list[tuple[str, int, int]]:
    """(name, start_ns, end_ns) of the host's `record_function` ranges."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and str(e.device_type()).endswith("CPU")]


def _parent(ranges, name, a, b):
    """The innermost other range around [a, b]."""
    around = [r for r in ranges if r[1] <= a and b <= r[2] and r != (name, a, b)]
    return max(around, key=lambda r: r[1])[0] if around else None


def test_span_off_is_one_shared_no_op():
    tr = EventTracer()
    first = tr.span("fe.ofdm")
    assert tr.span("tbd.turbo") is first and trace.span("turbo.iter") is trace.span("x")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("fe.ofdm"):
            torch.ones(4).sum()
    assert not tr._events
    assert "fe.ofdm" not in [n for n, _a, _b in _annotations(prof)]


def test_span_on_writes_an_event_and_a_profiler_range(tmp_path):
    tr = EventTracer()
    tr.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("tbd.crc"):
            torch.ones(4).sum()
    with tr.duration("tbd.crc"):
        pass
    tr.disable()
    assert tr.span("tbd.crc") is tr.span("fe.demap")
    tr.save(str(tmp_path / "t.json"))
    ev = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert [(e["name"], e["ph"], e["cat"]) for e in ev] == [("tbd.crc", "X", "phy")] * 2
    # the span's event is `duration`'s, field for field
    span_ev, dur_ev = ev
    assert span_ev["dur"] >= 0 and span_ev["pid"] == os.getpid()
    assert {k: v for k, v in span_ev.items() if k not in ("ts", "dur")} == {
        k: v for k, v in dur_ev.items() if k not in ("ts", "dur")}
    assert [n for n, _a, _b in _annotations(prof)] == ["tbd.crc"]


def test_counts_add_up_and_are_copied():
    before = trace.counts().get("test.count", 0)
    trace.count("test.count")
    trace.count("test.count", 3)
    got = trace.counts()
    assert got["test.count"] == before + 4
    got["test.count"] = -1
    assert trace.counts()["test.count"] == before + 4


def _dl_call():
    cell = Cell(nof_prb=6, id=7)
    grant = DlGrant(prb=tuple(range(6)), mod=Mod.QPSK, tbs=504)
    tb = torch.from_numpy(np.random.default_rng(6).integers(0, 2, (2, 504)).astype(np.uint8))
    samples = enb_dl_subframe_encode(cell, 2, 1, grant, device="cpu")(tb)
    noise = torch.randn(samples.shape, dtype=torch.complex64,
                        generator=torch.Generator().manual_seed(6))
    fn = ue_dl_subframe(cell, 2, 1, grant, 6, device="cpu")
    return lambda: fn(samples + 0.1 * noise), tb


def _ul_call():
    cell = Cell(nof_prb=6, id=301)
    grant = UlGrant(prb_start=1, nof_prb=4, mod=ra.ul_mcs_to_mod(6),
                    tbs=ra.tbs_lookup(ra.ul_mcs_to_itbs(6), 4), rnti=0x46)
    rng = np.random.default_rng(7)
    tb = rng.integers(0, 2, (2, grant.tbs)).astype(np.uint8)
    samples = torch.stack([ue_ul_encode(cell, 2, pusch=(grant, t), device="cpu") for t in tb])
    noise = torch.randn(samples.shape, dtype=torch.complex64,
                        generator=torch.Generator().manual_seed(7))
    fn = enb_ul_subframe(cell, 2, grant, 6, device="cpu")
    return lambda: fn((samples + 0.1 * noise)[:, None]), torch.from_numpy(tb)


@pytest.mark.parametrize("make, other_reads", [(_dl_call, 0), (_ul_call, 1)],
                         ids=["ue_dl_subframe", "enb_ul_subframe"])
def test_entry_spans_nest_and_host_reads_count_the_loop(make, other_reads):
    """Every span of the two entries, each in the span it belongs to, and
    `host_reads` risen by the turbo loop's reads (one before each iteration
    and one more that finds every code block passed, none at the cap) and,
    on the UL, the DM-RS gather's index copy in `chest_ul`."""
    call, sent = make()
    call()  # warm: tables built outside the profiled call
    reads0 = trace.counts().get("host_reads", 0)
    trace.tracer.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tb, ok, _snr = call()
    finally:
        trace.tracer.disable()
        trace.tracer.clear()
    reads = trace.counts()["host_reads"] - reads0
    assert bool(ok.all()) and torch.equal(tb, sent)
    ranges = _annotations(prof)
    assert {n for n, _a, _b in ranges} == set(NESTING)
    for name, a, b in ranges:
        assert _parent(ranges, name, a, b) == NESTING[name], name
    names = [n for n, _a, _b in ranges]
    iters, stop_reads = names.count("turbo.iter"), names.count("turbo.stop_read")
    assert 1 <= iters < 6 and stop_reads == iters + 1
    assert reads == stop_reads + other_reads


def test_turbo_decode_dyn_reads_and_iterations_are_spanned_and_counted():
    """`turbo_decode_dyn` runs the static decoder's loop: a `turbo.stop_read`
    before each `turbo.iter` and one more that finds every row passed, each
    read counted in `host_reads` and each iteration in `turbo_iterations`."""
    k_max, ks = 512, (512, 128, 40)
    rng = np.random.default_rng(10)  # rows pass at iterations 3, 2, 1
    d = np.zeros((len(ks), 3, k_max + 4), np.float32)
    per = np.tile(np.arange(k_max), (len(ks), 1))
    inv = per.copy()
    msgs = []
    for i, k in enumerate(ks):
        msgs.append(crc_attach_np(rng.integers(0, 2, k - 24).astype(np.uint8), LTE_CRC24A))
        enc = turbo_encode_np(msgs[-1]).astype(np.float32)
        d[i, :, : k + 4] = (2 * enc - 1) * 0.9 + rng.normal(0, 1, enc.shape)
        per[i, :k] = qpp_interleaver_np(k)
        inv[i, per[i, :k]] = np.arange(k)
    args = (torch.from_numpy(d), torch.tensor(ks), torch.from_numpy(per), torch.from_numpy(inv),
            torch.ones(len(ks), dtype=torch.bool), k_max, 6)
    kw = dict(crc_table=torch.from_numpy(crc_table_ab(k_max)),
              crc_is_b=torch.zeros(len(ks), dtype=torch.bool))
    before = trace.counts()
    trace.tracer.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            bits, _post, it_vec = turbo_decode_dyn(*args, **kw)
    finally:
        trace.tracer.disable()
        trace.tracer.clear()
    after = trace.counts()
    assert all(np.array_equal(bits[i, :k].numpy(), msgs[i]) for i, k in enumerate(ks))
    names = [n for n, _a, _b in _annotations(prof)]
    iters, stop_reads = names.count("turbo.iter"), names.count("turbo.stop_read")
    assert it_vec.tolist() == [3, 2, 1] and iters == 3 and stop_reads == iters + 1
    assert after["host_reads"] - before.get("host_reads", 0) == stop_reads
    assert after["turbo_iterations"] - before.get("turbo_iterations", 0) == iters
