#!/usr/bin/env python3
"""CRC pass rate, MAP launches and snr_db of the program's entry point over
a range of noise amplitudes, one batch each, for choosing a mix's noise:

    python3 lte_bench/tools/noise_sweep.py --config lte20_fdd_ul_pusch --batch 128 \\
        --seed 7 0.15 0.2 0.25

Runs on the first CUDA device (it prints nothing without one)."""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("amps", type=float, nargs="+")
    args = ap.parse_args()

    import torch

    from lte_bench import catalog, stimuli
    from srsran_tpu_torch.phy.fec import turbo_cuda

    if not torch.cuda.is_available():
        print("noise_sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = catalog.config(ROOT, args.config)
    link = catalog.link(cfg)
    sent = stimuli.draw_tbs(args.seed, 32, cfg["grant"]["tbs"])
    clean = torch.from_numpy(stimuli.render(link, cfg, sent)).to(dev)
    fn = link.build_entry(cfg, [dev])
    for amp in args.amps:
        mix = dict(batch=args.batch, noise_amp=amp, n_tbs=32, pool_batches=2)
        pool = stimuli.build_pool(clean, mix, args.seed)
        for p in range(2):
            launches0 = turbo_cuda.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tb, ok, snr = fn(pool[p])
            n_ok = int(ok.sum())
            ms = (time.perf_counter() - t0) * 1e3
            print(f"{args.config} amp {amp}: batch {p}: {n_ok}/{args.batch} pass, "
                  f"{turbo_cuda.LAUNCHES - launches0} MAP launches, snr_db mean "
                  f"{float(snr.mean()):.3f}, {ms:.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
