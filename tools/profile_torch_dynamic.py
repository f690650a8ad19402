#!/usr/bin/env python
"""Where the port's decode paths spend their time, on one NVIDIA GPU.

`--path siso` (the default), `mimo` or `ul` picks the pair of paths;
`--path window`, `window_mimo` or `window_ul` profiles one windowed engine
instead, `--path loopback`, `loopback_ul` or `loopback_mimo` one loopback
window, `--path ctrl_dl` or `ctrl_ul` one control loopback window, `--path
ue_dl` one TRACK subframe of the 20 MHz link, `--path ul_link` the 20 MHz
UL link (see the end of this text).

First the static entry point at full width, with the inputs of `chip_smoke.py`:
`ue_dl_subframe` at 100 PRB, MCS 26, B=128 subframes a call (siso);
`ue_dl_subframe_mimo` at 100 PRB, 2 x MCS 26 behind the 2x2 channel, B=64
(mimo); `enb_ul_subframe` at PRB 1..96 of 100, MCS 20, B=128 (ul).  It
prints ms per call by CUDA events and on the host clock (medians of 8 runs
of 5 calls) and, from `torch.profiler` over 5 calls, kernels per call,
device busy time per call, its share of the host wall, and the kernels that
take most device time.

Then one TTI of the dynamic-grant decode.  One `DynamicUeDl` (siso: MCS 28
on 100 PRB, 13 codeblocks of K=6144, and MCS 5 on 6 PRB, one small
codeblock; mimo: a 2-layer spatial-multiplexing MCS 20 grant on 50 PRB and a
transmit-diversity MCS 9 grant on 30 PRB, behind the 2x2 channel) or one
`DynamicEnbUl` (ul: MCS 20 on PRB 1..96 and MCS 10 on 25 PRB) on a 100 PRB
cell decodes two grants again and again, both rendered by the port's host
transmitter from a seed.  For each grant it prints
  * ms per TTI by CUDA events and on the host clock;
  * the share of each stage and of stage C's parts, timed on the host clock
    with a synchronize before and after each (so the parts do not overlap
    and their sum exceeds the free-running time);
  * from `torch.profiler` over 10 TTIs: kernels launched per TTI, device
    busy time per TTI and its share of the wall time, and the kernels that
    take most device time.

The windowed paths decode one full-width window of `chip_smoke.py`, again
and again: `WindowedUeDl` (100 PRB, W = 128, the 16-grant mix at noise
0.09), `WindowedUeDlMimo` (W = 64, 2x2) or `WindowedEnbUl` (W = 64).  They
print ms per window and per TTI by CUDA events and on the host clock, the
stages' times, the ingest quantisation alone, kernels per window and the
device's busy share (`chip_smoke.window_times`, which also profiles the
kernels printed last); then the host spans of one window, each
fenced by a synchronize before and after: the plan (with the ingest
quantisation, the upload, `pack_window`, `class_tables` and the softbuffer
inside it), stages A, B, C (with `turbo_decode_dyn` and the codeblock CRC
inside C) and the result read; then the kernels that take most device time.

The loopback paths run one loopback window of `chip_smoke.py` phase 18 again
and again: the generator (`WindowedEnbDl`, `WindowedUeUl` or
`WindowedEnbDlMimo`), `window_channel` and the decode engine, W fresh grants
at 100 PRB.  They print the same times and counts (`chip_smoke.time_window`),
then the host spans of one window, each fenced by a synchronize before and
after: the generator's plan (with `pack_window`, `_slot_sources`, the dense
payload and the TX class tables inside it), its codeword and sample stages,
the channel, the decoder's plan (with `class_tables` and the softbuffer),
stages A, B, C (with `turbo_decode_dyn`) and the result read.

The control paths run one control loopback window of `chip_smoke.py`
phases 19 and 20 again and again at 100 PRB, W = 64: ctrl_dl the eNB
generator with the control overlay, `window_channel`, `WindowedUeFrontEnd`,
the blind search over four RNTIs and the data pass over the grants it
found; ctrl_ul `WindowedUeUl` with PUCCH ACKs, `WindowedEnbUlFrontEnd`, the
format-1 decodes and the data pass.  They print the receive side's times
and counts (`chip_smoke.time_window`), the fenced host spans of the
window's steps (`chip_smoke.ctrl_dl_steps` / `ctrl_ul_steps`: front end,
blind search host part, Viterbi, collect, data, results; medians of 5), and
the kernels and device time of each step from `torch.profiler`.

The ue_dl path runs `chip_smoke.py` phase 24's link (`EnbApp` → channel →
`UeApp`, 100 PRB, MCS 26, CFI 2) for three frames with its checks, keeps a
TRACK subframe, and splits its receive chain into the fenced steps of
`chip_smoke.ue_dl_steps` (OFDM + chest, PCFICH, blind search host part,
Viterbi, collect, PDSCH; medians of 5, host ms and CUDA-event ms), then
from `torch.profiler` the kernels and device ms of each step and the
kernels by name of the whole `ue_dl_decode_subframe`.

The ul_link path runs `chip_smoke.py` phase 27 alone in its own process:
the 20 MHz multi-UE UL link over four frames with its gates, ms per UL
subframe, and for four kept subframes (PRACH, RM CQI, SRS, Viterbi CQI)
the fenced steps of `chip_smoke.enb_ul_steps` with their kernels and
device ms.

The last line is all of it as one JSON object.

Run from the repo root on a machine with a card:
    python3 tools/profile_torch_dynamic.py [--path siso|mimo|ul|window|window_mimo|window_ul|
                                                   loopback|loopback_ul|loopback_mimo|ctrl_dl|ctrl_ul|
                                                   ue_dl|ul_link]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (render, cuda_ms, wall_ms)
import srsran_tpu_torch.pipeline_dynamic as pd  # noqa: E402
from srsran_tpu_torch.phy.common import Cell  # noqa: E402
from srsran_tpu_torch.phy.fec import turbo_cuda  # noqa: E402
from srsran_tpu_torch.phy.ofdm import OfdmConfig  # noqa: E402
from srsran_tpu_torch.phy.phch.pdsch import DlGrant, pdsch_encode_np  # noqa: E402
from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs  # noqa: E402
from srsran_tpu_torch.phy.ue.ue_ul import ue_ul_encode  # noqa: E402

N = 10
N_STATIC = 5
SPANS: dict[str, float] = defaultdict(float)


def timed(name, fn):
    """fn with a synchronize before and after, its host time added to SPANS."""
    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        SPANS[name] += (time.perf_counter() - t0) * 1e3
        return out
    return wrapper


def device_kernels(prof):
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def static_call(path: str):
    """(label, batch, bits per CRC-passing TB, call) of the static entry point
    of `path`; call() decodes the batch and returns the crc_ok tensor."""
    dev = torch.device("cuda:0")
    if path == "siso":
        _, _, grant, fn, samples = chip_smoke.load_slice(dev)
        return "ue_dl_subframe, 100 PRB MCS 26", chip_smoke.B, grant.tbs, lambda: fn(samples)[1]
    if path == "mimo":
        _, _, grant, fn, samples, _ = chip_smoke.load_mimo(dev)

        def call():
            (_, ok1), (_, ok2), _ = fn(samples)
            return torch.cat([ok1, ok2])

        return "ue_dl_subframe_mimo, 100 PRB 2x2 2 x MCS 26", chip_smoke.B_MIMO, grant.tbs1, call
    _, _, grant, fn, samples, _ = chip_smoke.load_ul(dev)
    return "enb_ul_subframe, PRB 1+96 of 100 MCS 20", chip_smoke.B, grant.tbs, lambda: fn(samples)[1]


def profile_static(report, path: str):
    """The static entry point: times of one call and one profiled window."""
    label, batch, tbs, call = static_call(path)
    n_ok = int(call().sum())
    for _ in range(2):
        call()
    before = turbo_cuda.LAUNCHES
    dev_runs = sorted(chip_smoke.cuda_ms(call, N_STATIC) for _ in range(8))
    map_per_call = (turbo_cuda.LAUNCHES - before) / (8 * N_STATIC)
    host_runs = sorted(chip_smoke.wall_ms(call, N_STATIC) for _ in range(8))
    dev_ms, host_ms = (0.5 * (r[3] + r[4]) for r in (dev_runs, host_runs))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = chip_smoke.wall_ms(call, N_STATIC)
    kernels = device_kernels(prof)
    total = sum(e.device_time_total for e in kernels)
    busy_ms = total / 1e3 / N_STATIC
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    entry = {
        "path": label, "batch": batch, "tbs": tbs, "crc_ok": n_ok,
        "ms_per_call_cuda_events": dev_ms, "ms_per_call_cuda_events_min_max": [dev_runs[0], dev_runs[-1]],
        "ms_per_call_host_wall": host_ms, "ms_per_call_under_profiler": prof_wall_ms,
        "map_launches_per_call": map_per_call,
        "device_busy_ms_per_call": busy_ms, "device_busy_share_of_host_wall": busy_ms / host_ms,
        "kernels_per_call": sum(e.count for e in kernels) / N_STATIC,
        "top_kernels": [{"name": e.key[:60], "count_per_call": e.count / N_STATIC,
                         "device_ms_per_call": e.device_time_total / 1e3 / N_STATIC,
                         "share_of_device_time": e.device_time_total / total} for e in top],
    }
    report["static_slice"] = entry
    print(f"static path {label} B={batch} ({n_ok} TBs pass CRC): {dev_ms:.3f} ms "
          f"per call by CUDA events ({dev_runs[0]:.3f}-{dev_runs[-1]:.3f}), {host_ms:.3f} ms host "
          f"wall, {map_per_call:g} map launches per call")
    print(f"  profiler: {entry['kernels_per_call']:.0f} kernels per call, device busy "
          f"{busy_ms:.3f} ms per call ({100 * busy_ms / host_ms:.1f}% of the host wall), "
          f"{prof_wall_ms:.3f} ms per call under the profiler")
    for e in entry["top_kernels"]:
        print(f"    {e['device_ms_per_call']:.4f} ms  {100 * e['share_of_device_time']:5.2f}%  "
              f"x{e['count_per_call']:g}  {e['name']}")


def dynamic_grants(path: str, rng):
    """(decoder, [(tag, subframe, grant, tb, samples on the card)]) of the
    dynamic part of `path`."""
    if path == "ul":
        cell = Cell(nof_prb=100, nof_ports=1, id=301)
        dec = pd.DynamicEnbUl(cell, max_iterations=6)
        specs = (("ul_mcs20_96prb", 20, 1, 96, 0.09), ("ul_mcs10_25prb", 10, 40, 25, 0.05))
        out = []
        for tag, mcs, s0, l, amp in specs:
            grant = chip_smoke.ul_grant(mcs, s0, l, 0x46)
            tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
            rx = chip_smoke.awgn(rng, ue_ul_encode(cell, 3, pusch=(grant, tb)).cpu().numpy()[None], amp)
            out.append((tag, 3, grant, tb, torch.from_numpy(rx).cuda()))
        return dec, out
    nof_ports = 2 if path == "mimo" else 1
    cell = Cell(nof_prb=100, nof_ports=nof_ports, id=301)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    dec = pd.DynamicUeDl(cell, cfi=1, max_iterations=6)
    specs = ((("spatialmux2_mcs20_50prb", "spatialmux", 2, 20, tuple(range(50))),
              ("diversity_mcs9_30prb", "diversity", 1, 9, tuple(range(10, 40))))
             if path == "mimo" else
             (("mcs28_100prb", "port0", 1, 28, tuple(range(100))),
              ("mcs5_6prb", "port0", 1, 5, tuple(range(47, 53)))))
    out = []
    for tag, tx_scheme, nof_layers, mcs, prb in specs:
        grant = DlGrant(prb=prb, mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, len(prb) * nof_layers),
                        rnti=0x46, tx_scheme=tx_scheme, nof_layers=nof_layers, pmi=1)
        tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
        if path == "mimo":
            rx = chip_smoke.awgn(rng, chip_smoke.render_2x2(
                cell, 3, pdsch_encode_np(cell, 3, 1, grant, tb)), 0.02)
        else:
            rx = chip_smoke.render(cell, ofdm, 3, grant, tb, rng, 0.05)
        out.append((tag, 3, grant, tb, torch.from_numpy(rx).cuda()))
    return dec, out


def quantize_plain(samples: np.ndarray, ingest: str):
    """`pipeline_window._quantize_ingest` written the straightforward way (a
    stacked copy of the pairs, a temporary per step): what its in-place form
    is timed against, and must equal."""
    import srsran_tpu_torch.pipeline_window as pw

    dt, full = pw._INGEST[ingest]
    sri = np.stack([samples.real, samples.imag], axis=-1)
    peak = np.maximum(np.abs(sri).reshape(len(sri), -1).max(axis=1), 1e-12)
    scale = (peak / full).astype(np.float32)
    return np.clip(np.round(sri / scale[:, None, None, None]), -full, full).astype(dt), scale


def host_ms(fn, n: int = 5) -> float:
    """Median host milliseconds of fn() over n runs (no device work)."""
    runs = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    return sorted(runs)[n // 2]


def profile_window(report, path: str):
    """One windowed engine at full width: times, fenced host spans, kernels."""
    import srsran_tpu_torch.pipeline_window as pw

    kind = {"window": "ue_dl", "window_mimo": "ue_dl_mimo", "window_ul": "enb_ul"}[path]
    cell = Cell(nof_prb=100, nof_ports=2 if kind == "ue_dl_mimo" else 1, id=301)
    rng = np.random.default_rng(13)
    w, amp, mix = {"ue_dl": (chip_smoke.W_DL, 0.09, chip_smoke.dl_window_mix),
                   "ue_dl_mimo": (chip_smoke.W_MIMO, 0.045, chip_smoke.mimo_window_mix),
                   "enb_ul": (chip_smoke.W_UL, 0.05, chip_smoke.ul_window_mix)}[kind]
    eng = chip_smoke.window_engine(kind, cell, w, 6)
    samples, sfs, grants, sent = chip_smoke.window_of(mix(cell, rng, 16), w, rng, amp)
    if kind == "ue_dl_mimo":
        sent = [tb for pair in sent for tb in pair]
    res = eng.results(eng.dispatch_window(samples, sfs, grants))
    n_ok = chip_smoke.check_window(path, kind, res, sent, 0)
    entry = chip_smoke.window_times(path, kind, eng, samples, sfs, grants)
    entry["crc_ok"], entry["rows"] = n_ok, len(sent)

    # the ingest quantisation against its straightforward form: plain, in
    # place, in place, plain on the same samples
    (q, sc), (q_p, sc_p) = pw._quantize_ingest(samples, eng.ingest), quantize_plain(samples, eng.ingest)
    if not ((q == q_p).all() and (sc == sc_p).all() and q.dtype == q_p.dtype):
        raise RuntimeError(f"{path}: the ingest quantisation differs from its straightforward form")
    forms = (lambda: quantize_plain(samples, eng.ingest), lambda: pw._quantize_ingest(samples, eng.ingest))
    t = [host_ms(forms[i]) for i in (0, 1, 1, 0)]
    entry["quantize_ingest_ms_plain_inplace_inplace_plain"] = t
    print(f"  {eng.ingest} ingest quantisation of {samples.shape} on the host: straightforward form "
          f"{t[0]:.3f} and {t[3]:.3f} ms, in place {t[1]:.3f} and {t[2]:.3f} ms, equal bytes")

    # fenced host spans of one window
    inner = {"plan.quantize_ingest": (pw, "_quantize_ingest"), "plan.pack_window": (pw, "pack_window"),
             "plan.class_tables": (pw, "class_tables"), "plan.assemble_soft": (pw, "_assemble_soft"),
             "plan.upload": (eng, "_upload"), "C.turbo_decode_dyn": (pw, "turbo_decode_dyn"),
             "C.crc_ok_ab": (pw, "crc_ok_ab")}
    plain = {name: getattr(obj, attr) for name, (obj, attr) in inner.items()}
    for name, (obj, attr) in inner.items():
        setattr(obj, attr, timed(name, plain[name]))
    SPANS.clear()

    def fenced():
        stages, pack = timed("plan", eng._plan)(samples, sfs, grants)
        out = None
        for name, fn in stages:
            out = timed(name, fn)(out)
        timed("results", eng.results)(pw.PendingWindow(out[0], out[1], pack.tbs, pack))

    fenced_ms = chip_smoke.wall_ms(fenced, N)
    spans = {k: v / N for k, v in sorted(SPANS.items())}
    for name, (obj, attr) in inner.items():
        if obj is eng:
            delattr(obj, attr)
        else:
            setattr(obj, attr, plain[name])

    entry.update({"ms_per_window_fenced": fenced_ms, "fenced_spans_ms": spans})
    report["window"] = entry
    print(f"  fenced: {fenced_ms:.3f} ms per window; spans (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
    for e in entry["top_kernels"]:
        print(f"    {e['device_ms_per_window']:.4f} ms  {100 * e['share_of_device_time']:5.2f}%  "
              f"x{e['count_per_window']:g}  {e['name']}")


def profile_loopback(report, path: str):
    """One loopback window of `chip_smoke.py` phase 18, timed, profiled and
    split into fenced host spans."""
    import srsran_tpu_torch.pipeline_window as pw

    kind = {"loopback": "enb_dl", "loopback_ul": "ue_ul", "loopback_mimo": "enb_dl_mimo"}[path]
    gen, dec = chip_smoke.loopback_engines(kind)
    h, amp = chip_smoke.LOOP_CHANNELS[kind]
    sfs, grants, payloads = chip_smoke.grant_mix(
        kind, np.random.default_rng(41 + chip_smoke.GEN_KINDS.index(kind)), gen.w)

    def one():
        rx = pw.window_channel(gen.dispatch_window(payloads, sfs, grants), h, amp)
        return dec.results(dec.dispatch_window(rx, sfs, grants))

    rows, _n_it = chip_smoke.window_rows(chip_smoke.LOOP_DECODERS[kind], one())
    n_ok = sum(ok for _tb, ok in rows)
    if n_ok < len(rows):
        raise RuntimeError(f"{path}: {n_ok} of {len(rows)} TBs come back")
    entry = chip_smoke.time_window(path, one, gen.w)
    entry["crc_ok"] = n_ok
    chip_smoke.print_times(path, entry)

    inner = {"gen.plan._slot_sources": "_slot_sources", "gen.plan._payload_dense": "_payload_dense",
             "gen.plan.tx_class_tables": "tx_class_tables", "plan.pack_window": "pack_window",
             "dec.plan.class_tables": "class_tables", "dec.plan.assemble_soft": "_assemble_soft",
             "C.turbo_decode_dyn": "turbo_decode_dyn", "channel": "window_channel"}
    plain = {name: getattr(pw, attr) for name, attr in inner.items()}
    for name, attr in inner.items():
        setattr(pw, attr, timed(name, plain[name]))
    SPANS.clear()

    def fenced():
        stages, _pack = timed("gen.plan", gen._plan)(payloads, sfs, grants)
        out = None
        for name, fn in stages:
            out = timed(f"gen.{name}", fn)(out)
        rx = pw.window_channel(out, h, amp)
        stages, pack = timed("dec.plan", dec._plan)(rx, sfs, grants)
        out = None
        for name, fn in stages:
            out = timed(name, fn)(out)
        timed("results", dec.results)(pw.PendingWindow(out[0], out[1], pack.tbs, pack))

    fenced_ms = chip_smoke.wall_ms(fenced, N)
    spans = {k: v / N for k, v in sorted(SPANS.items())}
    for name, attr in inner.items():
        setattr(pw, attr, plain[name])
    entry.update({"ms_per_window_fenced": fenced_ms, "fenced_spans_ms": spans})
    report["loopback"] = entry
    print(f"  fenced: {fenced_ms:.3f} ms per window; spans (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
    for e in entry["top_kernels"]:
        print(f"    {e['device_ms_per_window']:.4f} ms  {100 * e['share_of_device_time']:5.2f}%  "
              f"x{e['count_per_window']:g}  {e['name']}")


def profile_ctrl(report, path: str):
    """One control loopback window of `chip_smoke.py` phase 19 (ctrl_dl) or
    20 (ctrl_ul): checked, timed, split into fenced host spans, and each
    step's kernels and device time."""
    kind = path.removeprefix("ctrl_")
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    gen, fe = chip_smoke.ctrl_engines(kind, cell, chip_smoke.W_CTRL)
    if kind == "dl":
        win = chip_smoke.ctrl_dl_window(cell, chip_smoke.CTRL_CFI, chip_smoke.W_CTRL, np.random.default_rng(19))
        steps = chip_smoke.ctrl_dl_steps(cell, win, gen, fe, *chip_smoke.LOOP_CHANNELS["enb_dl"])
    else:
        win = chip_smoke.ctrl_ul_window(cell, chip_smoke.W_CTRL, np.random.default_rng(20))
        steps = chip_smoke.ctrl_ul_steps(cell, win, gen, fe, *chip_smoke.LOOP_CHANNELS["ue_ul"])
    dev = fe.device
    s, _ = chip_smoke.run_steps(steps, dev)
    info = (chip_smoke.check_ctrl_dl(path, cell, win, fe, s) if kind == "dl" else
            chip_smoke.check_ctrl_ul(path, cell, win, s))
    recv = steps[1:]
    entry = chip_smoke.time_window(path, lambda: chip_smoke.run_steps(recv, dev, {"rx": s["rx"]}, fence=False),
                                   chip_smoke.W_CTRL)
    chip_smoke.print_times(path, entry)
    spans = chip_smoke.median_spans(steps, dev, {}, n=5)
    state, per_step = {"rx": s["rx"]}, {}
    for name, fn in recv:
        n_k, ms = chip_smoke.profile_kernels(lambda: fn(state))
        per_step[name] = {"kernels": n_k, "device_ms": ms}
    entry.update(info, fenced_spans_ms=spans, fenced_ms=sum(spans.values()), kernels_by_step=per_step)
    report["ctrl"] = entry
    print(f"  fenced: {sum(spans.values()):.3f} ms per window with the generator; spans (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
    print("  kernels and device ms by step: "
          + ", ".join(f"{k} {v['kernels']} / {v['device_ms']:.3f}" for k, v in per_step.items()))
    for e in entry["top_kernels"]:
        print(f"    {e['device_ms_per_window']:.4f} ms  {100 * e['share_of_device_time']:5.2f}%  "
              f"x{e['count_per_window']:g}  {e['name']}")


def profile_ue_dl(report):
    """One TRACK subframe of `chip_smoke.py` phase 24's link: fenced steps,
    each step's kernels and device time, the kernels by name."""
    from srsran_tpu_torch.phy.ue.ue_dl import ue_dl_decode_subframe

    kept = {}

    def on_pop(push, sf, sf_idx):
        kept["sf"], kept["sf_idx"] = sf.clone(), sf_idx

    dev = torch.device("cuda", torch.cuda.current_device())
    rec = chip_smoke.link_run(dev, 100, 3, on_track_pop=on_pop)
    cell, rnti = rec["cell"], rec["ue"].rnti
    state = {"sf": kept["sf"][None], "sf_idx": kept["sf_idx"]}
    steps = chip_smoke.ue_dl_steps(cell, rnti, dev)
    chip_smoke.run_steps(steps, dev, dict(state))
    host, event = chip_smoke.event_spans(steps, dev, state, n=5)
    per_step, st = {}, dict(state)
    for name, fn in steps:
        n_k, ms = chip_smoke.profile_kernels(lambda: fn(st))
        per_step[name] = {"kernels": n_k, "device_ms": ms}

    def one():
        ue_dl_decode_subframe(cell, state["sf"], state["sf_idx"], rnti, device=dev)

    one()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall = chip_smoke.wall_ms(one, N_STATIC)
    kernels = device_kernels(prof)
    busy = sum(e.device_time_total for e in kernels) / 1e3 / N_STATIC
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    report["ue_dl"] = {
        "sf_idx": kept["sf_idx"], "link_sdus": rec["sdus"], "link_tbs_ok": rec["tbs_ok"],
        "fenced_spans_host_ms": host, "fenced_spans_event_ms": event, "fenced_ms": sum(host.values()),
        "kernels_by_step": per_step, "ms_per_sf_under_profiler": wall, "device_busy_ms_per_sf": busy,
        "kernels_per_sf": sum(e.count for e in kernels) / N_STATIC,
        "top_kernels": [{"name": e.key[:60], "count_per_sf": e.count / N_STATIC,
                         "device_ms_per_sf": e.device_time_total / 1e3 / N_STATIC} for e in top]}
    print(f"ue_dl: link of 3 frames, {rec['tbs_ok']} TBs CRC-clean, {rec['sdus']} SDUs; one TRACK "
          f"subframe (sf {kept['sf_idx']}): fenced {sum(host.values()):.3f} ms; spans (host / events, "
          "ms): " + ", ".join(f"{k} {host[k]:.3f} / {event[k]:.3f}" for k in host))
    print("  kernels and device ms by step: "
          + ", ".join(f"{k} {v['kernels']} / {v['device_ms']:.3f}" for k, v in per_step.items()))
    print(f"  profiler: {report['ue_dl']['kernels_per_sf']:.0f} kernels per subframe, device busy "
          f"{busy:.3f} ms of {wall:.3f} ms ({100 * busy / wall:.1f}%)")
    for e in report["ue_dl"]["top_kernels"]:
        print(f"    {e['device_ms_per_sf']:.4f} ms  x{e['count_per_sf']:g}  {e['name']}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", default="siso", choices=(
        "siso", "mimo", "ul", "window", "window_mimo", "window_ul",
        "loopback", "loopback_ul", "loopback_mimo", "ctrl_dl", "ctrl_ul", "ue_dl", "ul_link"))
    path = parser.parse_args().path
    if not torch.cuda.is_available():
        print("profile_torch_dynamic: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    rng = np.random.default_rng(1)
    report = {"card": card, "torch": torch.__version__, "path": path, "grants": {}}
    if path == "ue_dl":
        profile_ue_dl(report)
        print(json.dumps(report))
        return 0
    if path == "ul_link":
        _launches, report["ul_link"], _shapes = chip_smoke.phase_ul_link(
            torch.device("cuda", torch.cuda.current_device()))
        print(json.dumps(report))
        return 0
    if path.startswith("ctrl"):
        profile_ctrl(report, path)
        print(json.dumps(report))
        return 0
    if path.startswith("loopback"):
        profile_loopback(report, path)
        print(json.dumps(report))
        return 0
    if path.startswith("window"):
        profile_window(report, path)
        print(json.dumps(report))
        return 0
    profile_static(report, path)
    torch.cuda.empty_cache()
    plain = {name: getattr(pd, name) for name in
             ("codeword_d_fill_grouped_dev", "qpp_dev", "turbo_decode_dyn", "crc_ok_ab")}
    ue, grants = dynamic_grants(path, rng)
    for tag, sf_idx, grant, tb, rx in grants:

        def tti():
            tb_hat, ok, _, n_it = ue.decode(rx, sf_idx, grant)
            if not (ok and (tb_hat == tb).all()):
                raise RuntimeError(f"{tag}: the TB did not come back")

        for _ in range(3):
            tti()
        before = turbo_cuda.LAUNCHES_DYN
        dev_ms = chip_smoke.cuda_ms(tti, N)
        map_per_tti = (turbo_cuda.LAUNCHES_DYN - before) / N
        host_ms = chip_smoke.wall_ms(tti, N)

        # stage and part spans, each fenced by synchronizes
        stages = {"a": dict(ue._stage_a), "b": dict(ue._stage_b), "c": dict(ue._stage_c)}
        for s, cache in (("a", ue._stage_a), ("b", ue._stage_b), ("c", ue._stage_c)):
            for key, fn in cache.items():
                cache[key] = timed(f"stage_{s}", fn)
        for name, fn in plain.items():
            setattr(pd, name, timed(f"c.{name}", fn))
        SPANS.clear()
        fenced_ms = chip_smoke.wall_ms(tti, N)
        spans = {k: v / N for k, v in sorted(SPANS.items())}
        for s, cache in (("a", ue._stage_a), ("b", ue._stage_b), ("c", ue._stage_c)):
            cache.update(stages[s])
        for name, fn in plain.items():
            setattr(pd, name, fn)

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            prof_wall_ms = chip_smoke.wall_ms(tti, N)
        kernels = device_kernels(prof)
        busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / N
        n_kernels = sum(e.count for e in kernels) / N
        top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
        entry = {
            "tbs": grant.tbs, "ms_per_tti_cuda_events": dev_ms, "ms_per_tti_host_wall": host_ms,
            "map_launches_per_tti": map_per_tti, "ms_per_tti_fenced": fenced_ms,
            "fenced_spans_ms": spans, "ms_per_tti_under_profiler": prof_wall_ms,
            "device_busy_ms_per_tti": busy_ms, "device_busy_share_of_host_wall": busy_ms / host_ms,
            "kernels_per_tti": n_kernels,
            "top_kernels": [{"name": e.key[:60], "count_per_tti": e.count / N,
                             "device_ms_per_tti": e.device_time_total / 1e3 / N} for e in top],
        }
        report["grants"][tag] = entry
        print(f"{tag} (tbs {grant.tbs}): {dev_ms:.3f} ms per TTI by CUDA events, {host_ms:.3f} ms "
              f"host wall, {map_per_tti:g} map launches per TTI")
        print(f"  fenced: {fenced_ms:.3f} ms per TTI; spans (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
        print(f"  profiler: {n_kernels:.0f} kernels per TTI, device busy {busy_ms:.3f} ms per TTI "
              f"({100 * busy_ms / host_ms:.1f}% of the host wall), {prof_wall_ms:.3f} ms per TTI "
              f"under the profiler")
        for e in entry["top_kernels"]:
            print(f"    {e['device_ms_per_tti']:.4f} ms  x{e['count_per_tti']:g}  {e['name']}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
