"""`chip_smoke.py` phase 31's run (`stack_window_run`) on the CPU at the
reference test's cell (25 PRB, W = 12): the windowed control-plane stack
over its device loopback attaches, the bench's load (48 DL packets of 400 B
and one UL packet of 400 B every 64 TTIs) runs for two warm and two timed
windows, and after the offer stops every packet arrives once and in order
(the run's gates); the record carries what phase 31 prints."""

import torch

import chip_smoke

torch.set_num_threads(1)


def test_stack_window_run_at_25_prb():
    w = 12
    rec = chip_smoke.stack_window_run("cpu", 25, w=w, warm_ttis=2 * w, timed_ttis=2 * w)
    assert 0 < rec["attach_tti"] <= chip_smoke.STACK_WINDOW["max_attach"]
    assert rec["dl_packets"] == 2 * chip_smoke.STACK_WINDOW["dl"][0] and rec["ul_packets"] == 2
    assert rec["ctrl_windows"] > 0 and rec["ctrl_windows_timed"] == 2
    assert rec["dl_tbs_ok"] > 0 and rec["ul_crc_ok"] > 0
    assert rec["map_static_timed"] == 0
    assert rec["viterbi_calls_per_window"] >= 1
    assert rec["ms_per_tti"] > 0 and rec["rtf"] > 0 and rec["event_ms_per_tti"] is None
    assert rec["drain_ttis"] <= chip_smoke.STACK_WINDOW["max_drain_windows"] * w
    for end in ("enb", "ue"):
        assert rec["fenced"][end]["quiet_ms"] > 0
        assert set(rec["fenced"][end]["boundary_ms"]) == {0, 3, 4, 7, 8, w - 1}
