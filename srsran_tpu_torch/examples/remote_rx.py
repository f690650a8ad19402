"""remote_rx — receive I/Q samples over the network and record or relay
them (the `lib/examples/zmq_remote_rx.c` analog; the port's twin of
`examples/remote_rx.py`).

  python -m srsran_tpu_torch.examples.remote_rx --listen 5010 -o capture.cf32 -n 192000
  python -m srsran_tpu_torch.examples.remote_rx --listen 5010 --forward 127.0.0.1:5020
  python -m srsran_tpu_torch.examples.remote_rx --rf zmq \\
      --rf-args rx_port=tcp://localhost:2000 --srate 1920000 -o cap.cf32

With `--rf zmq` the source speaks the reference's fake-RF REQ/REP wire
protocol (`rf_zmq_imp.c`).  Otherwise pair with the native pump
(`srsran_tpu_torch.native.SampleRing`) or any cf32-datagram source.  The
samples stay on the host; `--device` is taken, as by every script of the
port, and checked, but nothing here runs on it.
"""

from __future__ import annotations

import argparse
import socket

import numpy as np

from ..device import resolve
from ..io import FileSink, NetSink, NetSource


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--listen", type=int, help="UDP port (default RF mode)")
    ap.add_argument("--rf", choices=("udp", "zmq"), default="udp")
    ap.add_argument("--rf-args", default="",
                    help="zmq device args, e.g. rx_port=tcp://localhost:2000")
    ap.add_argument("--srate", type=int, default=None,
                    help="radio sample rate (zmq mode; must divide base_srate)")
    ap.add_argument("-o", "--output", help="cf32 output file")
    ap.add_argument("--forward", help="host:port to relay datagrams to")
    ap.add_argument("-n", "--nof-samples", type=int, default=192000)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    resolve(args.device)
    if args.rf == "zmq":
        from ..io.rf_zmq import ZmqRf

        rf = ZmqRf(args.rf_args)
        if args.srate:
            rf.set_srate(args.srate)
        src = _ZmqSource(rf.rx[0])
        print(f"zmq REQ connected ({args.rf_args})", flush=True)
    else:
        assert args.listen, "--listen required in udp mode"
        src = NetSource("127.0.0.1", args.listen)
        print(f"listening on udp:{args.listen}", flush=True)
    sink = FileSink(args.output) if args.output else None
    fwd = None
    if args.forward:
        host, port = args.forward.rsplit(":", 1)
        fwd = NetSink(host, int(port))

    got = 0
    while got < args.nof_samples:
        try:
            chunk = src.read(min(8192, args.nof_samples - got))
        except (socket.timeout, TimeoutError):
            print(f"timeout after {got} samples")
            break
        if chunk is None or len(chunk) == 0:
            continue
        if sink is not None:
            sink.write(chunk)
        if fwd is not None:
            fwd.write(np.asarray(chunk))
        got += len(chunk)
    if sink is not None:
        sink.close()
    print(f"received {got} samples")
    return 0


class _ZmqSource:
    """Adapt ZmqRfRx to the NetSource read() surface."""

    def __init__(self, rx):
        self._rx = rx

    def read(self, n):
        samples, _ts = self._rx.recv(n)
        return samples


if __name__ == "__main__":
    raise SystemExit(main())
