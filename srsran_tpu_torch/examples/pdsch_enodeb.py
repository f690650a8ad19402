"""pdsch_enodeb — generate a continuous LTE DL signal carrying PDSCH data
(the `lib/examples/pdsch_enodeb.c` analog; the port's twin of
`examples/pdsch_enodeb.py`).

Renders frames with PSS/SSS/PBCH/CRS and one full-band PDSCH grant per
subframe (frame-counter payload) on `--device`, writing cf32 samples to a
file or UDP.

  python -m srsran_tpu_torch.examples.pdsch_enodeb -o /tmp/dl.cf32 -p 6 -m 4 -n 4
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve
from ..io import FileSink, NetSink
from ..phy.common import Cell
from ..phy.enb.enb_dl import DlSched, enb_dl_subframe
from ..phy.phch.dci import Dci1A
from ..phy.phch.pbch import Mib
from ..phy.phch.pdcch import nof_cce, search_space_candidates
from ..phy.phch.pdsch import DlGrant
from ..phy.phch.ra import dl_mcs_to_mod, dl_tbs, riv_encode


def build_frame(cell, rnti: int, mcs: int, sfn: int, payload_fn, device) -> tuple[torch.Tensor, list]:
    """One frame: (samples (10 * sf_len,) complex64 on `device`, the ten TBs)."""
    mib = Mib(nof_prb=cell.nof_prb)
    out, tbs_sent = [], []
    for sf_idx in range(10):
        dci = Dci1A(riv=riv_encode(cell.nof_prb, 0, cell.nof_prb), mcs=mcs, harq_pid=0, ndi=1, rv=0)
        grant = DlGrant(prb=tuple(range(cell.nof_prb)), mod=dl_mcs_to_mod(mcs),
                        tbs=dl_tbs(mcs, cell.nof_prb), rnti=rnti)
        tb = payload_fn(sfn, sf_idx, grant.tbs)
        cands = search_space_candidates(rnti, sf_idx, nof_cce(cell, sf_idx, 1))
        agg = 4 if cands.get(4) else max(cands)
        sched = DlSched(cfi=1, dcis=[(dci.pack(cell.nof_prb), rnti, agg, cands[agg][0])],
                        grants=[(grant, tb)])
        _, samples = enb_dl_subframe(cell, sf_idx, sched, mib=mib, sfn=sfn, device=device)
        out.append(samples[0])
        tbs_sent.append(tb)
    return torch.cat(out), tbs_sent


def counter_payload(sfn: int, sf_idx: int, tbs: int) -> np.ndarray:
    """Deterministic frame/subframe-seeded payload (stands in for the
    reference's byte counter)."""
    rng = np.random.default_rng(sfn * 10 + sf_idx)
    return rng.integers(0, 2, tbs).astype(np.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--output", required=True, help="cf32 file path or udp:host:port")
    ap.add_argument("-p", "--nof-prb", type=int, default=6)
    ap.add_argument("-c", "--cell-id", type=int, default=1)
    ap.add_argument("-m", "--mcs", type=int, default=4)
    ap.add_argument("-r", "--rnti", type=lambda s: int(s, 0), default=0x1234)
    ap.add_argument("-n", "--nof-frames", type=int, default=1)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cell = Cell(nof_prb=args.nof_prb, nof_ports=1, id=args.cell_id)
    if args.output.startswith("udp:"):
        _, host, port = args.output.split(":")
        sink = NetSink(host, int(port))
    else:
        sink = FileSink(args.output)
    for sfn in range(args.nof_frames):
        frame, _ = build_frame(cell, args.rnti, args.mcs, sfn, counter_payload, device)
        sink.write(frame.cpu().numpy())
        print(f"sfn {sfn}: {frame.shape[0]} samples", flush=True)
    sink.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
