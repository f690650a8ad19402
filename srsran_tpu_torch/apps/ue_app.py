"""srsran_tpu_torch UE process: ingests I/Q over UDP (native GIL-free pump),
synchronizes, decodes, and prints received data-bearer SDUs.

Counterpart of the reference's `apps/ue_app.py`, the analog of the
reference `srsue` binary on the ZMQ fake RF.  The ring is the native
`SampleRing` (built from `native/` at first use); each subframe read from it
goes to `--device` (default: the card; raises where there is none) once,
and `--device cpu` runs the PHY on the CPU.  Usage:

  python -m srsran_tpu_torch.apps.ue_app --port 2101 --phy.nof_prb=6 --duration 5
"""

import argparse
import time

from ..device import resolve
from ..native import SampleRing
from ..phy.common import Cell
from ..phy.fec import turbo_cuda
from ..runtime import MetricsHub, StdoutMetrics, load_config
from .ue import UeApp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--port", type=int, default=2101)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args, extra = ap.parse_known_args()
    cfg = load_config(args.config, overrides=extra)
    device = resolve(args.device)

    ue = UeApp(nof_prb=cfg.phy.nof_prb, rnti=cfg.rnti, cfi=cfg.phy.cfi or None,
               pcap_path=cfg.pcap.filename if cfg.pcap.enable else None, device=device)
    cell0 = Cell(nof_prb=cfg.phy.nof_prb)
    ring = SampleRing(64 * cell0.sf_len)
    ring.start_udp_pump(args.port)
    print(f"listening: UDP {args.port} on {device}", flush=True)

    hub = MetricsHub()
    hub.add_producer(ue.get_metrics)
    hub.add_listener(StdoutMetrics())

    t_end = time.time() + args.duration
    n_sdu = 0
    while time.time() < t_end:
        chunk = ring.read(cell0.sf_len, timeout_s=0.2)
        if len(chunk):
            ue.push_samples(chunk)
            ue.process()
        while True:
            sdu = ue.read_sdu()
            if sdu is None:
                break
            n_sdu += 1
            print(f"SDU {n_sdu}: {sdu[:24]!r}... ({len(sdu)} B)", flush=True)
    hub.poll_once()
    print(f"done: {n_sdu} SDUs, dropped_samples={ring.dropped}", flush=True)
    print(f"map launches: static {turbo_cuda.LAUNCHES - turbo_cuda.LAUNCHES_DYN}, "
          f"dynamic-K {turbo_cuda.LAUNCHES_DYN}", flush=True)
    ring.close()


if __name__ == "__main__":
    main()
