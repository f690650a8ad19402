"""cell_search — scan an I/Q capture for LTE cells (the
`lib/examples/cell_search.c` analog; the port's twin of
`examples/cell_search.py`): PSS/SSS over all N_id_2 roots, CFO estimate,
then MIB decode, on `--device`.

  python -m srsran_tpu_torch.examples.cell_search -i /tmp/dl.cf32 -p 6
"""

from __future__ import annotations

import argparse

from ..device import resolve
from ..io import FileSource
from ..phy.common import Cell
from ..phy.ofdm import OfdmConfig
from ..phy.ue.ue_sync import cell_search, mib_search


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-p", "--nof-prb", type=int, default=6)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cell0 = Cell(nof_prb=args.nof_prb, nof_ports=1, id=0)
    samples = FileSource(args.input).read(cell0.sf_len * 20)
    res = cell_search(samples, args.nof_prb, device=device)
    if res is None:
        print("no cell found")
        return 1
    print(f"found cell: PCI={res.cell_id} (N_id_1={res.cell_id // 3}, "
          f"N_id_2={res.cell_id % 3}) CFO={res.cfo:.3f} subcarriers "
          f"peak@{res.peak_offset} sf_idx={res.sf_idx}")
    cell = Cell(nof_prb=args.nof_prb, nof_ports=1, id=res.cell_id)
    ofdm = OfdmConfig.from_cell(cell)
    sf0 = res.peak_offset - ofdm.symbol_starts()[6] + (cell.sf_len * 5 if res.sf_idx == 5 else 0)
    got = mib_search(samples, cell, sf0, res.cfo, device=device)
    if got:
        mib, nports, _ = got
        print(f"MIB: nof_prb={mib.nof_prb} nof_ports={nports} sfn={mib.sfn}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
