"""pssch_ue — sidelink (C-V2X / D2D) receiver: sync on PSSS/SSSS, decode the
MIB-SL from the PSBCH, then scan subframes for PSCCH SCIs and decode the
scheduled PSSCH transport blocks (the `lib/examples/pssch_ue.c` analog; the
port's twin of `examples/pssch_ue.py`), on `--device`.

TM4 (V2X, SCI format 1) by default, `--tm2` for D2D SCI format 0:

  python -m srsran_tpu_torch.examples.pssch_ue -i capture.cf32 -p 50
  python -m srsran_tpu_torch.examples.pssch_ue -i tm2.cf32 -p 100 --tm2

Works on the reference's own test captures, e.g.
`tests/vectors/signal_sidelink_uxm_s15.36e6_50prb_0prb_offset_mcs12.dat`.
The last line of the output is a JSON summary (SCIs, TBs, subframes).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve
from ..phy.common import Cell
from ..phy.ofdm import OfdmConfig, ofdm_rx_sf
from ..phy.phch.psbch import psbch_decode, psbch_search_tm34
from ..phy.phch.pscch import pscch_decode, pscch_search_tm34
from ..phy.phch.pssch import pssch_decode, pssch_decode_tm34
from ..phy.phch.ra import riv_decode
from ..phy.sync.sidelink import psss_find, psss_seq_np, ssss_detect


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", required=True, help="cf32 capture file")
    ap.add_argument("-p", "--nof-prb", type=int, default=50)
    ap.add_argument("--tm2", action="store_true", help="D2D TM2 (SCI-0) instead of V2X TM4")
    ap.add_argument("--nonstandard-rates", action="store_true",
                    help="capture uses reduced srsLTE rates (e.g. 11.52 Msps for 50 PRB)")
    ap.add_argument("--num-sub-channel", type=int, default=10, help="TM4 subchannels")
    ap.add_argument("--size-sub-channel", type=int, default=5, help="TM4 PRBs per subchannel")
    ap.add_argument("--slss-id", type=int, default=None,
                    help="known N_sl_id (skip SSSS detection)")
    ap.add_argument("-n", "--max-subframes", type=int, default=20)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    x = torch.from_numpy(np.fromfile(args.input, np.complex64)).to(device)
    std = not args.nonstandard_rates
    cell = Cell(nof_prb=args.nof_prb, nof_ports=1, id=0, use_standard_rates=std)
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)

    # --- sync: PSSS correlation over the whole capture ---
    root, off, metric = psss_find(x, args.nof_prb, standard_rates=std, device=device)
    # a capture shorter than a subframe past the peak holds no whole sync
    # subframe (the reference script fails there): take its last one
    sf_start = min(max(off - ofdm.symbol_starts()[1], 0), x.shape[0] - cell.sf_len)
    print(f"PSSS: root {root}, offset {off} (metric {metric:.1f}); "
          f"sync subframe starts at sample {sf_start}")
    sync_grid = ofdm_rx_sf(ofdm, x[sf_start : sf_start + cell.sf_len])

    # --- N_sl_id: SSSS 336-hypothesis detection (TM2 layout) or --slss-id ---
    n_sl_id = args.slss_id
    if n_sl_id is None and args.tm2:
        k0 = cell.nof_re_per_symbol // 2 - 31
        ce = sync_grid[1, k0 : k0 + 62] * torch.from_numpy(np.conj(psss_seq_np(root))).to(device)
        eq = sync_grid[cell.nsymb_per_slot + 4, k0 : k0 + 62] * torch.conj(ce) / (torch.abs(ce) ** 2 + 1e-3)
        nid, conf = ssss_detect(eq)
        n_sl_id = int(nid)
        print(f"SSSS: N_sl_id = {n_sl_id} (confidence {float(conf):.2f})")
    elif n_sl_id is None:
        n_sl_id = root * 168  # TM4: the PSSS root halves the id space, PSBCH picks

    # --- MIB-SL from the PSBCH in the sync subframe ---
    mib = None
    if args.tm2:
        got, ok = psbch_decode(sync_grid, cell, n_sl_id)
        mib = got.pack() if ok else None
    else:
        ids = [n_sl_id] if args.slss_id is not None else list(range(root * 168, root * 168 + 168))
        for cand, (bits, ok) in zip(ids, psbch_search_tm34(sync_grid, cell, ids)):
            if ok:
                n_sl_id, mib = cand, bits
                break
    if mib is not None:
        bw = int("".join(map(str, np.asarray(mib)[:3])), 2)
        print(f"PSBCH: MIB-SL decoded, N_sl_id = {n_sl_id}, sl-Bandwidth index {bw} "
              f"(n{(6, 15, 25, 50, 75, 100)[bw]})")
    else:
        print(f"PSBCH: no MIB-SL (data-only capture?) — continuing with N_sl_id = {n_sl_id}")

    # --- scan subframes for SCIs + transport blocks ---
    n_sf = min(x.shape[0] // cell.sf_len, args.max_subframes)
    grids = ofdm_rx_sf(ofdm, x[: n_sf * cell.sf_len].reshape(n_sf, cell.sf_len))
    n_sci = n_tb = 0
    for sf in range(n_sf):
        grid = grids[sf]
        if args.tm2:
            sci, ok = pscch_decode(grid, cell, prb_idx=0)
            if not ok:
                continue
            n_sci += 1
            rb0, l_crb = riv_decode(args.nof_prb, sci.riv)
            print(f"sf {sf}: SCI-0 riv={sci.riv} (PRB {rb0}+{l_crb}) mcs={sci.mcs_idx}")
            tb, ok = pssch_decode(grid, cell, sci.n_sa_id, sci.mcs_idx, rb0, l_crb, sf_idx=0, rv=0)
            if ok:
                n_tb += 1
                print(f"        PSSCH TB ({len(tb)} bits) CRC OK: "
                      f"{np.packbits(tb.cpu().numpy()).tobytes().hex()}")
        else:
            starts = [sub * args.size_sub_channel for sub in range(args.num_sub_channel)]
            for p, cs, sci, crc in pscch_search_tm34(grid, cell, starts, args.num_sub_channel):
                sub = p // args.size_sub_channel
                n_sci += 1
                n_x_id = int("".join(map(str, crc)), 2)
                l_subch = riv_decode(args.num_sub_channel, sci.riv)[1]
                prb_start = p + 2
                nof_prb = (l_subch + sub) * args.size_sub_channel - prb_start
                print(f"sf {sf}: SCI-1 subch {sub} cs {cs} mcs={sci.mcs_idx} N_x_id={n_x_id}")
                tb, ok = pssch_decode_tm34(grid, cell, n_x_id, sci.mcs_idx, prb_start, nof_prb,
                                           sf_idx=sf, rv=0)
                if ok:
                    n_tb += 1
                    print(f"        PSSCH TB ({len(tb)} bits) CRC OK: "
                          f"{np.packbits(tb[:64].cpu().numpy()).tobytes().hex()}...")
    print(f"done: {n_sci} SCIs, {n_tb} transport blocks decoded in {n_sf} subframes")
    print(json.dumps({"n_sl_id": n_sl_id, "mib": mib is not None, "scis": n_sci, "tbs": n_tb,
                      "subframes": n_sf}))
    return 0 if n_sci else 1


if __name__ == "__main__":
    raise SystemExit(main())
