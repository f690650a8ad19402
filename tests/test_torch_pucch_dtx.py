"""Format-1 PUCCH DTX detection with two UEs on the band-edge PRB: the
port's `full_stack._pucch1_decodes` against the reference's rule (each
resource's `enb_ul_decode_pucch` metric over 0.25) on the same subframes.

Each subframe is a U subframe of a 15 PRB cell (STACK's PCI) on which UE 1
sends a HARQ ACK (format 1a) and UE 0 sends an ACK, an SR, or nothing (a
DCI it missed), each through its own EPA 5 Hz channel, UE 0 `gap` dB under
UE 1, with phase 29's AWGN (amplitude 0.01).  The eNB expects an ACK from
each UE and it is an SR occasion of both, as on subframe 7 of the TDD link.
Per seed the UEs' ACK resources are drawn from the PRB's dynamic range.
- The port's raw metric is the reference's on the same subframe.
- Leakage: what a resource of the PRB that no UE sent on reads, over what
  UE 1's resource reads, for every pair: under half `PUCCH_LEAK`.
- Misses: UE 0's ACK or SR read as DTX at the link's 11 dB gap: none in
  the port, where the reference misses most ACKs.
- False alarms: an ACK or SR read on a resource of a UE that did not send
  it: none in the port, none in the reference.
- An SR resource that is also another UE's ACK resource (the dynamic
  resources reach the SR ones on wide cells) reads as no SR in the port.

Run as a script (`PYTHONPATH=. python tests/test_torch_pucch_dtx.py`), it prints the
leakage at 15 and 100 PRB and the miss and false-alarm rates of both rules
over more seeds and gaps.
"""

import numpy as np
import torch

from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.enb import enb_ul as r_enb_ul
from srsran_tpu.phy.phch.pucch import PucchConfig as RPucchConfig
from srsran_tpu_torch.apps.full_stack import PUCCH_LEAK, _pucch1_decodes, _sr_resource
from srsran_tpu_torch.convert import from_reference
from srsran_tpu_torch.phy.channel.channel import Channel, ChannelConfig
from srsran_tpu_torch.phy.channel.fading import FadingConfig
from srsran_tpu_torch.phy.enb.enb_ul import enb_ul_decode_pucch, enb_ul_fft
from srsran_tpu_torch.phy.phch.pucch import PucchConfig
from srsran_tpu_torch.phy.ue.ue_ul import ue_ul_encode

torch.set_num_threads(1)

CPU = "cpu"
SF = 7  # the SR subframe, U in TDD configurations 1 and 2
RNTIS = (70, 71)  # UE 0's and UE 1's: SR resources 16 and 17
N_DYN = 15  # the ACK resources below the SR ones
PER_PRB = 18  # format-1 resources of a PRB: 6 cyclic shifts x 3 covers
DTX_THRESHOLD = 0.25
AMP = 0.01
GAP_DB = 11.0  # UE 0 under UE 1 on the TDD link's uplink
SEEDS = 24
METRIC_RTOL = 1e-4
LEAK_MARGIN = 2


def cell_of(nof_prb: int) -> tuple[Cell, Cell]:
    ref = Cell(nof_prb=nof_prb, nof_ports=1, id=301)
    return ref, from_reference(ref)


def subframe(cell, seed: int, ue0, gap_db: float):
    """The eNB's UL samples (numpy) of one subframe: UE 1's ACK on its
    resource, and UE 0's `ue0` ("ack", "sr" or None) `gap_db` under it.
    Returns (samples, {UE: (ACK resource, SR resource)})."""
    rng = np.random.default_rng(seed)
    n0, n1 = (int(n) for n in rng.choice(N_DYN, 2, replace=False))
    res = {0: (n0, _sr_resource(RNTIS[0])), 1: (n1, _sr_resource(RNTIS[1]))}
    sends = {1: (n1, [1])}
    if ue0 == "ack":
        sends[0] = (n0, [1])
    elif ue0 == "sr":
        sends[0] = (res[0][1], [])
    y = torch.zeros(cell.sf_len, dtype=torch.complex64)
    for ue, (n, bits) in sends.items():
        x = ue_ul_encode(cell, SF, pucch1=(PucchConfig(n_pucch=n), bits), device=CPU)
        ch_seed = 2 * seed + ue
        chan = Channel(ChannelConfig(fading=FadingConfig("epa", 5.0, cell.srate, ch_seed),
                                     srate=cell.srate, seed=ch_seed), device=CPU)
        y = y + chan.run(x) * (10 ** (-gap_db / 20) if ue == 0 else 1.0)
    noise = AMP * (rng.standard_normal(cell.sf_len) + 1j * rng.standard_normal(cell.sf_len))
    return (y.numpy() + noise).astype(np.complex64), res


def raw_metrics(cell, grid) -> np.ndarray:
    """The port's metric of every format-1 resource of the band-edge PRB."""
    return np.array([float(enb_ul_decode_pucch(cell, SF, grid, PucchConfig(n_pucch=n), "1", 1,
                                               device=CPU)[1]) for n in range(PER_PRB)])


def judge(cell, samples, res) -> dict:
    """{rule: {(UE, "ack" | "sr"): metric}} for the port's rule and the
    reference's (each detected above `DTX_THRESHOLD`), and the raw metrics
    of the PRB."""
    grid = enb_ul_fft(cell, torch.from_numpy(samples)[None], device=CPU)
    wanted = {RNTIS[u]: {(ack, 1), (sr, 0)} for u, (ack, sr) in res.items()}
    port = _pucch1_decodes(cell, SF, grid, wanted, CPU)
    raw = raw_metrics(cell, grid)
    out = {"port": {}, "reference": {}}
    for u, (ack, sr) in res.items():
        for kind, n, nbits in (("ack", ack, 1), ("sr", sr, 0)):
            out["port"][u, kind] = port[RNTIS[u], n, nbits][1]
            out["reference"][u, kind] = raw[n]
    return out, raw


def rates(cell, seeds, gap_db: float) -> dict:
    """Over `seeds`, per rule: UE 0's misses of its ACK and SR, and the
    false alarms on both UEs' resources (an ACK or SR read where the UE
    did not send one), each as (count, occasions); and the largest metric
    such a resource read."""
    out = {rule: dict(miss_ack=[0, 0], miss_sr=[0, 0], false_alarm=[0, 0], silent_max=0.0)
           for rule in ("port", "reference")}
    for ue0 in ("ack", "sr", None):
        for seed in seeds:
            samples, res = subframe(cell, seed, ue0, gap_db)
            got, _raw = judge(cell, samples, res)
            sent = {(1, "ack"), (0, ue0)}
            for rule, metric in got.items():
                r = out[rule]
                if ue0 is not None:
                    r[f"miss_{ue0}"][0] += metric[0, ue0] <= DTX_THRESHOLD
                    r[f"miss_{ue0}"][1] += 1
                for key, m in metric.items():
                    if key not in sent:
                        r["false_alarm"][0] += m > DTX_THRESHOLD
                        r["false_alarm"][1] += 1
                        r["silent_max"] = max(r["silent_max"], m)
    return out


def leakage(cell, seeds) -> float:
    """The largest metric that a resource no UE sent on reads, over UE
    1's, with UE 1 alone on the PRB (every pair of resources across the
    seeds)."""
    worst = 0.0
    for seed in seeds:
        samples, res = subframe(cell, seed, None, 0.0)
        grid = enb_ul_fft(cell, torch.from_numpy(samples)[None], device=CPU)
        raw = raw_metrics(cell, grid)
        n1 = res[1][0]
        worst = max(worst, float(np.delete(raw, n1).max() / raw[n1]))
    return worst


def test_port_metric_is_the_references():
    """Every resource's raw metric, port against reference, on subframes
    with both UEs sending and with UE 0 silent."""
    rcell, cell = cell_of(15)
    for seed, ue0 in ((0, "ack"), (1, "sr"), (2, None)):
        samples, _res = subframe(cell, seed, ue0, GAP_DB)
        rgrid = r_enb_ul.enb_ul_fft(rcell, samples[None])
        want = np.array([float(r_enb_ul.enb_ul_decode_pucch(
            rcell, SF, rgrid, RPucchConfig(n_pucch=n), "1", 1)[1]) for n in range(PER_PRB)])
        got = raw_metrics(cell, enb_ul_fft(cell, torch.from_numpy(samples)[None], device=CPU))
        np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, atol=1e-9)


def test_leakage_stays_under_the_bound():
    """The largest leakage over the seeds holds `PUCCH_LEAK` with a margin
    of `LEAK_MARGIN`."""
    _r, cell = cell_of(15)
    worst = leakage(cell, range(SEEDS))
    assert 0 < worst * LEAK_MARGIN < PUCCH_LEAK, worst


def test_ue_11_db_under_another_is_heard_and_a_silent_one_is_not():
    """At the link's 11 dB gap: the port reads every ACK and SR of UE 0
    and no ACK or SR that was not sent (UE 0 silent beside UE 1 among
    them), each such resource under half the DTX threshold, as
    `PUCCH_LEAK`'s floor keeps it; the reference, judging each metric
    against the whole PRB's energy, misses most of UE 0's ACKs (the fault)
    and raises no false alarm either."""
    _r, cell = cell_of(15)
    r = rates(cell, range(SEEDS), GAP_DB)
    assert r["port"].pop("silent_max") < DTX_THRESHOLD / 2
    assert r["port"] == dict(miss_ack=[0, SEEDS], miss_sr=[0, SEEDS], false_alarm=[0, 7 * SEEDS])
    assert r["reference"]["false_alarm"][0] == 0
    assert r["reference"]["miss_ack"][0] > SEEDS // 2


def test_silent_ue_beside_one_ue_at_equal_power_reads_dtx():
    """No gap: UE 0 silent beside UE 1, then UE 0 sending; both rules
    agree, without misses or false alarms."""
    _r, cell = cell_of(15)
    r = rates(cell, range(SEEDS // 2), 0.0)
    assert max(r["port"].pop("silent_max"), r["reference"].pop("silent_max")) < DTX_THRESHOLD / 2
    assert r["port"] == r["reference"] == dict(
        miss_ack=[0, SEEDS // 2], miss_sr=[0, SEEDS // 2], false_alarm=[0, 7 * (SEEDS // 2)])


def test_sr_resource_that_carries_another_ues_ack_reads_no_sr():
    """The dynamic ACK resources reach the SR resources on wide cells.  UE
    0's SR resource carries UE 1's ACK (resource 16 its channel-selection
    candidate): the port reads UE 1's ACK and no SR of UE 0, where the
    reference's rule reads an SR UE 0 did not send.  Where it carries UE
    0's own ACK, both read UE 0's SR, as before."""
    _r, cell = cell_of(15)
    n_sr = _sr_resource(RNTIS[0])
    for seed, sender in ((0, 1), (1, 0), (2, 1), (3, 0)):
        rng = np.random.default_rng(seed)
        x = ue_ul_encode(cell, SF, pucch1=(PucchConfig(n_pucch=n_sr), [1, 0]), device=CPU)
        chan = Channel(ChannelConfig(fading=FadingConfig("epa", 5.0, cell.srate, seed),
                                     srate=cell.srate, seed=seed), device=CPU)
        noise = AMP * (rng.standard_normal(cell.sf_len) + 1j * rng.standard_normal(cell.sf_len))
        samples = (chan.run(x).numpy() + noise).astype(np.complex64)
        wanted = {RNTIS[0]: {(n_sr, 0)}, RNTIS[1]: {(_sr_resource(RNTIS[1]), 0)}}
        wanted[RNTIS[sender]] |= {(n_sr, 2)}
        grid = enb_ul_fft(cell, torch.from_numpy(samples)[None], device=CPU)
        got = _pucch1_decodes(cell, SF, grid, wanted, CPU)
        assert got[RNTIS[sender], n_sr, 2][1] > DTX_THRESHOLD
        assert raw_metrics(cell, grid)[n_sr] > DTX_THRESHOLD
        if sender == 1:
            assert got[RNTIS[0], n_sr, 0][1] == 0.0
        else:
            assert got[RNTIS[0], n_sr, 0][1] > DTX_THRESHOLD


if __name__ == "__main__":
    n = 400
    for prb in (15, 100):
        print(f"leakage at {prb} PRB over {n} subframes: {leakage(cell_of(prb)[1], range(n)):.3e} "
              f"(PUCCH_LEAK {PUCCH_LEAK:.3e})")
    cell = cell_of(15)[1]
    for gap in (0.0, 6.0, 11.0, 16.0, 21.0, 26.0):
        r = rates(cell, range(n), gap)
        print(f"gap {gap:4.1f} dB, 15 PRB, {n} seeds: " + "; ".join(
            f"{rule}: " + ", ".join(f"{k} {c}/{t}" for k, (c, t) in v.items() if k != "silent_max")
            + f", largest metric where none was sent {v['silent_max']:.3f}" for rule, v in r.items()))
