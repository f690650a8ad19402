"""windowed_link — the four windowed directions closing a full duplex link
(the port's twin of `examples/windowed_link.py`): the eNB generates W
downlink subframes of arbitrary grants in one dispatch (`WindowedEnbDl`),
the UE decodes them (`WindowedUeDl`); the UE generates the uplink mix
(`WindowedUeUl`), the eNB decodes it (`WindowedEnbUl`).  Every per-TTI
quantity is data; the host keeps the grants' books and adds numpy noise.

  python -m srsran_tpu_torch.examples.windowed_link --prb 50 -w 8 --seed 3
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..device import resolve
from ..phy.common import Cell
from ..phy.phch.pdsch import DlGrant
from ..phy.phch.pusch import UlGrant
from ..phy.phch.ra import dl_mcs_to_mod, dl_tbs, tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
from ..pipeline_window import WindowedEnbDl, WindowedEnbUl, WindowedUeDl, WindowedUeUl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--prb", type=int, default=50)
    ap.add_argument("-w", "--window", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    rng = np.random.default_rng(args.seed)
    cell = Cell(nof_prb=args.prb, nof_ports=1, id=17)
    W = args.window
    enb_tx = WindowedEnbDl(cell, cfi=1, w=W, device=device)
    ue_rx = WindowedUeDl(cell, cfi=1, w=W, max_iterations=4, device=device)
    ue_tx = WindowedUeUl(cell, w=W, device=device)
    enb_rx = WindowedEnbUl(cell, w=W, max_iterations=4, device=device)

    # downlink: a random grant mix, payloads through the air
    dl_sfs, dl_grants, dl_tbs_bits = [], [], []
    while len(dl_grants) < W:
        mcs = int(rng.integers(0, 27))
        l = int(rng.integers(4, args.prb + 1))
        st = int(rng.integers(0, args.prb + 1 - l))
        t = dl_tbs(mcs, l)
        if t == 0:
            continue
        dl_sfs.append(int(rng.integers(0, 10)))
        dl_grants.append(DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(mcs), tbs=t,
                                 rnti=0x46))
        dl_tbs_bits.append(rng.integers(0, 2, t).astype(np.uint8))

    t0 = time.time()
    tx = WindowedEnbDl.samples(enb_tx.dispatch_window(dl_tbs_bits, dl_sfs, dl_grants))
    rx = (tx + args.noise * (rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape))
          ).astype(np.complex64)
    res, _ = ue_rx.decode_window(rx[:, None, :], dl_sfs, dl_grants)
    n_dl = sum(int(ok and np.array_equal(tb_hat, tb))
               for tb, (tb_hat, ok, _n) in zip(dl_tbs_bits, res))
    bits = sum(g.tbs for g in dl_grants)
    print(f"DL: {n_dl}/{W} TBs ({bits / 1e3:.0f} kbit) generated+decoded "
          f"in {time.time() - t0:.1f}s (incl. table builds)")

    # uplink: a mixed-width PUSCH mix back the other way
    widths = [w for w in (4, 9, 25, 50, 75, 96) if w <= args.prb]
    ul_sfs, ul_grants, ul_tbs_bits = [], [], []
    while len(ul_grants) < W:
        mcs = int(rng.integers(0, 24))
        nprb = int(widths[rng.integers(0, len(widths))])
        st = int(rng.integers(0, args.prb - nprb + 1))
        t = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
        if t == 0:
            continue
        ul_sfs.append(int(rng.integers(0, 10)))
        ul_grants.append(UlGrant(prb_start=st, nof_prb=nprb, mod=ul_mcs_to_mod(mcs), tbs=t, rv=0,
                                 rnti=0x46))
        ul_tbs_bits.append(rng.integers(0, 2, t).astype(np.uint8))

    t0 = time.time()
    tx = WindowedUeUl.samples(ue_tx.dispatch_window(ul_tbs_bits, ul_sfs, ul_grants))
    rx = (tx + args.noise * (rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape))
          ).astype(np.complex64)
    res, _ = enb_rx.decode_window(rx[:, None, :], ul_sfs, ul_grants)
    n_ul = sum(int(ok and np.array_equal(tb_hat, tb))
               for tb, (tb_hat, ok, _n) in zip(ul_tbs_bits, res))
    bits = sum(g.tbs for g in ul_grants)
    print(f"UL: {n_ul}/{W} TBs ({bits / 1e3:.0f} kbit) generated+decoded "
          f"in {time.time() - t0:.1f}s (incl. table builds)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
