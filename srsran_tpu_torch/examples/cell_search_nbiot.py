"""cell_search_nbiot — scan NB-IoT carriers for anchor cells from raw
baseband (the `lib/examples/cell_search_nbiot.c` analog; the port's twin of
`examples/cell_search_nbiot.py`), on `--device`.

Each input is a 1.92 Msps cf32 capture of one candidate carrier; the scan
runs NPSS timing correlation (folded over the 10 ms period), NPSS-based CFO
estimation, then NSSS + MIB-NB through the grid chain
(`phy/ue/ue_sync_nbiot.py`).

  python -m srsran_tpu_torch.examples.cell_search_nbiot 2506:cap_a.cf32 2510:cap_b.cf32
  python -m srsran_tpu_torch.examples.cell_search_nbiot --selftest
"""

from __future__ import annotations

import argparse

import numpy as np

from ..device import resolve
from ..phy.phch.npbch import MibNb, npbch_encode_np, npbch_re_indices, put_nrs_np
from ..phy.sync.nbiot import put_npss_grid, put_nsss_grid
from ..phy.ue.ue_sync_nbiot import nbiot_cell_search_scan, nbiot_modulate_np


def anchor_frame(ncell: int, mib: MibNb, frame4: int = 0) -> np.ndarray:
    """One anchor-carrier frame of grids (10, 14, 12): NPBCH + NRS in sf 0,
    NPSS in sf 5, NSSS in sf 9."""
    frame = np.zeros((10, 14, 12), np.complex64)
    frame[0].reshape(-1)[npbch_re_indices(ncell)] = npbch_encode_np(mib, ncell)[0]
    put_nrs_np(frame[0], ncell, 0)
    put_npss_grid(frame[5])
    put_nsss_grid(frame[9], ncell, frame4)
    return frame


def selftest_captures(rng):
    """Two 40 ms captures, as the reference script's selftest makes them: a
    cell (199) behind a timing offset, CFO and noise at EARFCN 2510, noise
    alone at 2506."""
    ncell = 199
    tx = nbiot_modulate_np(np.tile(anchor_frame(ncell, MibNb(sfn_msb=3, op_mode=1)), (4, 1, 1)))
    n = np.arange(len(tx))
    rx = tx * np.exp(2j * np.pi * 0.01 * n / 128)
    rx = np.concatenate([np.zeros(500, np.complex64), rx])
    rx = (rx + 0.03 * (rng.standard_normal(len(rx))
                       + 1j * rng.standard_normal(len(rx)))).astype(np.complex64)
    noise = (0.1 * (rng.standard_normal(len(rx))
                    + 1j * rng.standard_normal(len(rx)))).astype(np.complex64)
    return {2506: noise, 2510: rx}, 2510, ncell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("captures", nargs="*", help="EARFCN:FILE pairs (cf32 at 1.92 Msps)")
    ap.add_argument("--min-psr", type=float, default=3.0)
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    expect = None
    if args.selftest:
        caps, exp_earfcn, exp_cell = selftest_captures(np.random.default_rng(7))
        expect = (exp_earfcn, exp_cell)
    elif args.captures:
        caps = {}
        for spec in args.captures:
            earfcn, path = spec.split(":", 1)
            caps[int(earfcn)] = np.fromfile(path, np.complex64)
    else:
        raise SystemExit("need EARFCN:FILE pairs or --selftest")

    found = nbiot_cell_search_scan(caps, min_psr=args.min_psr, device=device)
    for earfcn, res in found:
        c = res.cell
        print(f"EARFCN {earfcn}: N_id_ncell={c.n_id_ncell} "
              f"MIB-NB(sfn_msb={c.mib.sfn_msb}, op_mode={c.mib.op_mode}) "
              f"timing={res.timing} CFO={res.cfo * 15e3:+.0f} Hz "
              f"PSR={res.psr:.1f}")
    scanned = ", ".join(str(e) for e in caps)
    print(f"scanned [{scanned}]: {len(found)} cell(s) found")
    if expect is not None:
        if [(e, r.cell.n_id_ncell) for e, r in found] != [expect]:
            print(f"selftest: FAILED, expected {expect}")
            return 1
        print("selftest: OK")
    return 0 if found else 1


if __name__ == "__main__":
    raise SystemExit(main())
