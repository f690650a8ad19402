"""PDSCH BLER / throughput sweep — the `pdsch_test` + `turbodecoder_test -t`
analog (the port's twin of `examples/bler_sweep.py`): encode a fixed
(PRB, MCS) configuration, impair it at a range of SNRs with numpy noise,
run the batched receive path (`pipeline.ue_dl_subframe`: OFDM → chest →
equalize → demod → turbo) on `--device`, and print BLER and goodput per
point.

  python -m srsran_tpu_torch.examples.bler_sweep --prb 6 --mcs 7 --snr 0:10:1 --batch 32
  python -m srsran_tpu_torch.examples.bler_sweep --prb 100 --mcs 26 --snr 14:22:1 --batch 128
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve
from ..phy.chest.refsignal_dl import put_crs_np
from ..phy.common import Cell
from ..phy.ofdm import OfdmConfig, ofdm_tx_sf
from ..phy.phch.pdsch import DlGrant, pdsch_encode_np
from ..phy.phch.ra import dl_mcs_to_mod, dl_tbs
from ..pipeline import ue_dl_subframe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--prb", type=int, default=6)
    ap.add_argument("--mcs", type=int, default=7)
    ap.add_argument("--snr", default="0:10:1", help="start:stop:step dB")
    ap.add_argument("--batch", type=int, default=32, help="subframes per point")
    ap.add_argument("--iters", type=int, default=6, help="max turbo iterations")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    lo, hi, step = (float(v) for v in args.snr.split(":"))
    snrs = np.arange(lo, hi + 1e-9, step)
    rng = np.random.default_rng(args.seed)

    cell = Cell(nof_prb=args.prb, nof_ports=1, id=301)
    tbs = dl_tbs(args.mcs, args.prb)
    grant = DlGrant(prb=tuple(range(args.prb)), mod=dl_mcs_to_mod(args.mcs), tbs=tbs)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    B = args.batch

    # one clean transmit subframe per batch slot (distinct payloads)
    grids = []
    for _ in range(B):
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        grids.append(put_crs_np(pdsch_encode_np(cell, 2, 1, grant, tb), cell, 2))
    tx = ofdm_tx_sf(ofdm, torch.from_numpy(np.stack(grids)).to(device)).cpu().numpy()  # (B, 1, sf_len)
    sig_pow = float(np.mean(np.abs(tx) ** 2))

    fn = ue_dl_subframe(cell, 2, 1, grant, max_iterations=args.iters, device=device)

    print(f"# PDSCH {args.prb} PRB MCS {args.mcs} ({grant.mod.name}, TBS {tbs}), "
          f"{B} subframes/point, <= {args.iters} iterations")
    print(f"# {'SNR dB':>7} {'BLER':>9} {'ok':>5} {'Mbps':>9} {'ms/pt':>8}")
    for snr_db in snrs:
        amp = np.sqrt(sig_pow / (2.0 * 10 ** (snr_db / 10)))
        noise = amp * (rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape))
        s = torch.from_numpy((tx + noise).astype(np.complex64))
        t0 = time.perf_counter()
        ok = int(fn(s.to(device))[1].sum())
        dt = time.perf_counter() - t0
        print(f"  {snr_db:7.1f} {1.0 - ok / B:9.4f} {ok:3d}/{B} "
              f"{ok * tbs / dt / 1e6:9.1f} {dt * 1e3:8.1f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
