"""Host copy of `srsran_tpu/io/icmp_ping.py`, held to it by `tests/test_torch_stack.py`.

Minimal ICMP echo client (raw socket, stdlib only).

Stands in for the `ping` binary the reference's E2E script uses
(`test/run_lte.sh:303` pings through the attached UE): container images
here ship no iputils, and the TUN E2E test needs a real kernel ICMP round
trip.  Requires CAP_NET_RAW (root).

CLI: ``python -m srsran_tpu_torch.io.icmp_ping <dst> [count] [timeout_s]`` —
exit code 0 iff every echo was answered; prints one RTT line per reply.
"""

from __future__ import annotations

import os
import socket
import struct
import sys
import time


def _checksum(data: bytes) -> int:
    if len(data) % 2:
        data += b"\x00"
    s = sum(struct.unpack(f"!{len(data)//2}H", data))
    s = (s >> 16) + (s & 0xFFFF)
    s += s >> 16
    return ~s & 0xFFFF


def ping(dst: str, count: int = 3, timeout_s: float = 10.0,
         interval_s: float = 0.3, payload_len: int = 56) -> list[float]:
    """Send `count` echo requests; returns the RTTs (s) of the replies
    received within the deadline (len < count ⇒ loss)."""
    ident = os.getpid() & 0xFFFF
    sock = socket.socket(socket.AF_INET, socket.SOCK_RAW,
                         socket.getprotobyname("icmp"))
    sock.setblocking(False)
    sent: dict[int, float] = {}
    rtts: list[float] = []
    try:
        deadline = time.time() + timeout_s
        next_tx = 0.0
        seq = 0
        while time.time() < deadline and len(rtts) < count:
            now = time.time()
            if seq < count and now >= next_tx:
                payload = struct.pack("!d", now) + b"Q" * (payload_len - 8)
                hdr = struct.pack("!BBHHH", 8, 0, 0, ident, seq)
                csum = _checksum(hdr + payload)
                pkt = struct.pack("!BBHHH", 8, 0, csum, ident, seq) + payload
                sock.sendto(pkt, (dst, 0))
                sent[seq] = now
                seq += 1
                next_tx = now + interval_s
            try:
                data, _ = sock.recvfrom(2048)
            except BlockingIOError:
                time.sleep(0.005)
                continue
            if len(data) < 28:
                continue
            ihl = (data[0] & 0xF) * 4
            typ, _code, _cs, rid, rseq = struct.unpack("!BBHHH", data[ihl : ihl + 8])
            if typ == 0 and rid == ident and rseq in sent:
                rtts.append(time.time() - sent.pop(rseq))
        return rtts
    finally:
        sock.close()


def main() -> int:
    dst = sys.argv[1]
    count = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    timeout = float(sys.argv[3]) if len(sys.argv) > 3 else 10.0
    rtts = ping(dst, count, timeout)
    for r in rtts:
        print(f"reply from {dst}: time={r*1e3:.1f} ms", flush=True)
    lost = count - len(rtts)
    print(f"{count} transmitted, {len(rtts)} received, "
          f"{100.0*lost/count:.0f}% packet loss", flush=True)
    return 0 if lost == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
