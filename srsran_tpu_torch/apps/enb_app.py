"""srsran_tpu_torch eNB process: renders DL subframes and streams them over UDP.

Counterpart of the reference's `apps/enb_app.py`, the analog of the
reference `srsenb` binary run with the ZMQ fake RF (`test/run_lte.sh:303`).
The PHY runs on `--device` (default: the card; raises where there is
none); `--device cpu` runs it on the CPU.  Each subframe is read to the
host once, at the socket.  Usage:

  python -m srsran_tpu_torch.apps.enb_app --config enb.conf --phy.nof_prb=6 \\
      --dest 127.0.0.1:2101 --ttis 1000 --payload-period 5
"""

import argparse
import time

from ..device import resolve
from ..io import NetSink
from ..phy.common import Cell
from ..runtime import MetricsHub, StdoutMetrics, load_config
from .enb import EnbApp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--rr-conf", default=None,
                    help="libconfig cell list (srsenb rr.conf format)")
    ap.add_argument("--sib-conf", default=None,
                    help="libconfig SIB contents (srsenb sib.conf format)")
    ap.add_argument("--drb-conf", default=None,
                    help="libconfig QCI bearer profiles (drb.conf format)")
    ap.add_argument("--dest", default="127.0.0.1:2101")
    ap.add_argument("--ttis", type=int, default=200)
    ap.add_argument("--payload-period", type=int, default=5)
    ap.add_argument("--realtime", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args, extra = ap.parse_known_args()
    cfg = load_config(args.config, overrides=extra)
    device = resolve(args.device)

    if args.rr_conf:
        # operator config plane (enb_cfg_parser.cc role): the cell
        # identity comes from rr.conf's cell_list
        from ..runtime.enb_cfg import EnbConfig

        op_cfg = EnbConfig.load(args.rr_conf, args.sib_conf, args.drb_conf)
        cell = Cell(nof_prb=cfg.phy.nof_prb, nof_ports=cfg.phy.nof_ports,
                    id=op_cfg.cells[0].get("pci", cfg.phy.cell_id))
    else:
        cell = Cell(nof_prb=cfg.phy.nof_prb, nof_ports=cfg.phy.nof_ports, id=cfg.phy.cell_id)
    enb = EnbApp(cell, rnti=cfg.rnti, cfi=cfg.phy.cfi,
                 pcap_path=cfg.pcap.filename if cfg.pcap.enable else None, device=device)
    host, port = args.dest.split(":")
    sink = NetSink(host, int(port), "udp")

    hub = MetricsHub()
    hub.add_producer(enb.get_metrics)
    hub.add_listener(StdoutMetrics())

    t0 = time.time()
    for tti in range(args.ttis):
        if tti % args.payload_period == 0:
            enb.write_sdu(f"tti-{tti:06d}-payload".encode() * 2)
        samples = enb.run_tti()
        sink.write(samples.cpu().numpy())
        if args.realtime:
            target = t0 + (tti + 1) * 1e-3
            dt = target - time.time()
            if dt > 0:
                time.sleep(dt)
        if tti % 100 == 99:
            hub.poll_once()
    sink.close()


if __name__ == "__main__":
    main()
