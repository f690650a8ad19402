"""The spans and the `host_reads` counter of the 2x2 two-codeword decode,
`ue_dl_subframe_mimo`, under a CPU `torch.profiler` run, as
`test_torch_trace.py` checks the SISO entries'; and the span sequence of
`ue_dl_subframe`, which shares its front end, on the three transmit
schemes."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from srsran_tpu_torch.phy.chest.refsignal_dl import put_crs_np
from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.phy.modem import Mod
from srsran_tpu_torch.phy.ofdm import OfdmConfig, ofdm_tx_sf
from srsran_tpu_torch.phy.phch.pdsch import DlGrant, DlGrant2, pdsch_encode2_np, pdsch_encode_np
from srsran_tpu_torch.pipeline import ue_dl_subframe, ue_dl_subframe_mimo
from srsran_tpu_torch.runtime import trace

torch.set_num_threads(1)

H_2X2 = np.array([[1.0 + 0.1j, 0.25 - 0.55j], [-0.45 + 0.3j, 0.95 + 0.05j]], np.complex64)
# span -> the span it lies in (None: directly in the entry's call)
NESTING = {"fe.ofdm": None, "fe.chest": None, "fe.equalize": None, "fe.mimo": "fe.equalize",
           "fe.demap": None, "tbd.rate_match": None, "tbd.turbo": None, "tbd.crc": None,
           "turbo.iter": "tbd.turbo", "turbo.stop_read": "tbd.turbo"}
# the front end's spans in the order they open, per entry
FRONT = ["fe.ofdm", "fe.chest", "fe.equalize", "fe.demap"]


def _annotations(prof):
    """(name, start_ns, end_ns) of the host's `record_function` ranges, in
    the order they open."""
    ev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.is_user_annotation() and str(e.device_type()).endswith("CPU")]
    return sorted(ev, key=lambda r: (r[1], -r[2]))


def _parent(ranges, name, a, b):
    around = [r for r in ranges if r[1] <= a and b <= r[2] and r != (name, a, b)]
    return max(around, key=lambda r: r[1])[0] if around else None


def _traced(call):
    """(results, ranges, host_reads) of one call under the profiler with the
    program's tracer on, after a warm call."""
    call()
    reads0 = trace.counts().get("host_reads", 0)
    trace.tracer.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = call()
    finally:
        trace.tracer.disable()
        trace.tracer.clear()
    return out, _annotations(prof), trace.counts()["host_reads"] - reads0


def _rx(cell, grid, seed):
    """Two noisy subframes of a 2-port grid (CRS put in) behind H_2X2."""
    tx = ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True),
                    torch.from_numpy(put_crs_np(grid, cell, 2))).numpy()
    clean = np.einsum("rp,pt->rt", H_2X2, tx)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((2,) + clean.shape) + 1j * rng.standard_normal((2,) + clean.shape)
    return torch.from_numpy((clean[None] + 0.02 * noise).astype(np.complex64))


def test_mimo_spans_nest_and_host_reads_count_the_loop():
    """Every span of the 2x2 entry in the span it belongs to, `fe.mimo`
    once inside `fe.equalize`, and `host_reads` risen by the turbo loop's
    reads alone: one before each iteration and one more."""
    cell = Cell(nof_prb=6, nof_ports=2, id=7)
    grant = DlGrant2(prb=tuple(range(6)), mod1=Mod.QPSK, tbs1=504, mod2=Mod.QPSK, tbs2=504,
                     pmi=1)
    rng = np.random.default_rng(8)
    tb1, tb2 = (rng.integers(0, 2, 504).astype(np.uint8) for _ in range(2))
    x = _rx(cell, pdsch_encode2_np(cell, 2, 1, grant, tb1, tb2), 9)
    fn = ue_dl_subframe_mimo(cell, 2, 1, grant, 6, device="cpu")
    ((t1, ok1), (t2, ok2), _snr), ranges, reads = _traced(lambda: fn(x))
    assert bool(ok1.all() and ok2.all())
    assert np.array_equal(t1.numpy(), np.stack([tb1] * 2))
    assert np.array_equal(t2.numpy(), np.stack([tb2] * 2))
    names = [n for n, _a, _b in ranges]
    assert set(names) == set(NESTING)
    for name, a, b in ranges:
        assert _parent(ranges, name, a, b) == NESTING[name], name
    assert [n for n in names if n.startswith("fe.")] == FRONT[:3] + ["fe.mimo", "fe.demap"]
    iters, stop_reads = names.count("turbo.iter"), names.count("turbo.stop_read")
    assert 1 <= iters < 6 and stop_reads == iters + 1
    assert reads == iters + 1


@pytest.mark.parametrize("scheme", ["port0", "diversity", "spatialmux"])
def test_siso_entry_span_sequence(scheme):
    """`ue_dl_subframe` opens the four front-end spans once each, in order,
    then TB decode's; `fe.mimo` only in the spatial-multiplexing branch,
    inside `fe.equalize`."""
    nof_ports = 1 if scheme == "port0" else 2
    cell = Cell(nof_prb=6, nof_ports=nof_ports, id=7)
    grant = DlGrant(prb=tuple(range(6)), mod=Mod.QPSK, tbs=504 if scheme != "spatialmux" else 1032,
                    tx_scheme=scheme, nof_layers=2 if scheme == "spatialmux" else 1,
                    pmi=1 if scheme == "spatialmux" else 0)
    tb = np.random.default_rng(10).integers(0, 2, grant.tbs).astype(np.uint8)
    grid = pdsch_encode_np(cell, 2, 1, grant, tb)
    if nof_ports == 1:
        tx = ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True),
                        torch.from_numpy(put_crs_np(grid, cell, 2))).numpy()
        x = torch.from_numpy(np.tile(tx, (2, 1, 1)).astype(np.complex64))
    else:
        x = _rx(cell, grid, 11)
    fn = ue_dl_subframe(cell, 2, 1, grant, 6, device="cpu")
    (got, ok, _snr), ranges, reads = _traced(lambda: fn(x))
    assert bool(ok.all()) and np.array_equal(got.numpy(), np.stack([tb] * 2))
    names = [n for n, _a, _b in ranges]
    want = FRONT[:3] + (["fe.mimo"] if scheme == "spatialmux" else []) + ["fe.demap"]
    assert [n for n in names if n.startswith("fe.")] == want
    assert names[: len(want)] == want and names[len(want)] == "tbd.rate_match"
    for name, a, b in ranges:
        assert _parent(ranges, name, a, b) == NESTING[name], name
    assert reads == names.count("turbo.stop_read")
