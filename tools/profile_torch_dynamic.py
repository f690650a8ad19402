#!/usr/bin/env python
"""Where the port's two decode paths spend their time, on one NVIDIA GPU.

First the static slice: `ue_dl_subframe` at 100 PRB, MCS 26, B=128
subframes a call (the inputs of `chip_smoke.py` phase 4).  It prints ms per
call by CUDA events and on the host clock (medians of 8 runs of 5 calls)
and, from `torch.profiler` over 5 calls, kernels per call, device busy time
per call, its share of the host wall, and the kernels that take most device
time.

Then one TTI of the dynamic-grant decode.  One `DynamicUeDl` on a 100 PRB cell decodes two grants again and again:
MCS 28 on 100 PRB (13 codeblocks of K=6144) and MCS 5 on 6 PRB (one small
codeblock), both rendered by the port's host transmitter from a seed.  For
each grant it prints
  * ms per TTI by CUDA events and on the host clock;
  * the share of each stage and of stage C's parts, timed on the host clock
    with a synchronize before and after each (so the parts do not overlap
    and their sum exceeds the free-running time);
  * from `torch.profiler` over 10 TTIs: kernels launched per TTI, device
    busy time per TTI and its share of the wall time, and the kernels that
    take most device time.
The last line is all of it as one JSON object.

Run from the repo root on a machine with a card:
    python3 tools/profile_torch_dynamic.py
"""

from __future__ import annotations

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
from srsran_tpu_torch.phy.phch.pdsch import DlGrant  # noqa: E402
from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs  # noqa: E402

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


def profile_static(report):
    """The static slice: times of a B=128 call and one profiled window."""
    _, _, grant, fn, samples = chip_smoke.load_slice(torch.device("cuda:0"))

    def call():
        _, ok, _ = fn(samples)
        return ok

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
        "batch": chip_smoke.B, "tbs": grant.tbs, "crc_ok": n_ok,
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
    print(f"static slice, 100 PRB MCS 26 B={chip_smoke.B} ({n_ok} TBs pass CRC): {dev_ms:.3f} ms "
          f"per call by CUDA events ({dev_runs[0]:.3f}-{dev_runs[-1]:.3f}), {host_ms:.3f} ms host "
          f"wall, {map_per_call:g} map launches per call")
    print(f"  profiler: {entry['kernels_per_call']:.0f} kernels per call, device busy "
          f"{busy_ms:.3f} ms per call ({100 * busy_ms / host_ms:.1f}% of the host wall), "
          f"{prof_wall_ms:.3f} ms per call under the profiler")
    for e in entry["top_kernels"]:
        print(f"    {e['device_ms_per_call']:.4f} ms  {100 * e['share_of_device_time']:5.2f}%  "
              f"x{e['count_per_call']:g}  {e['name']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_dynamic: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = pd.DynamicUeDl(cell, cfi=1, max_iterations=6)
    rng = np.random.default_rng(1)
    report = {"card": card, "torch": torch.__version__, "grants": {}}
    profile_static(report)
    plain = {name: getattr(pd, name) for name in
             ("codeword_d_fill_grouped_dev", "qpp_dev", "turbo_decode_dyn", "crc_ok_ab")}
    for tag, mcs, prb in (("mcs28_100prb", 28, tuple(range(100))), ("mcs5_6prb", 5, tuple(range(47, 53)))):
        grant = DlGrant(prb=prb, mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, len(prb)), rnti=0x46)
        tb = rng.integers(0, 2, grant.tbs).astype(np.uint8)
        rx = torch.from_numpy(chip_smoke.render(cell, ofdm, 3, grant, tb, rng, 0.05)).cuda()

        def tti():
            tb_hat, ok, _, n_it = ue.decode(rx, 3, grant)
            assert ok and (tb_hat == tb).all()

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
