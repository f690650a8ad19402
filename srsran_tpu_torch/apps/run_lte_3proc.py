"""Three-process LTE E2E over REAL sockets on the port — the analog of the
reference's `test/run_lte.sh:288-312` process topology:

  UE proc  <-- PHY I/Q frames (TCP lockstep, the rf_zmq REQ/REP
               pattern, rf_zmq_imp.c:218) -->  eNB proc
  eNB proc <-- S1AP over TCP :36412 with 4-byte length framing (a
               documented SCTP stand-in; srsepc/src/mme/mme.cc:25
               listens on SCTP) + GTP-U over UDP :2152
               (srsenb/src/stack/upper/gtpu.cc) -->  EPC proc

Counterpart of the reference's `apps/run_lte_3proc.py`, with the same
arguments and wire formats (S1AP ALIGNED-PER, GTP-U headers, complex64
I/Q), so each role interoperates with the reference's.  The eNB's and the
UE's PHY run on `--device` (default: the card; raises where there is
none; `--device cpu` runs them on the CPU); the EPC role runs no PHY.
Each subframe is read to the host once, at the socket, and a received one
goes to the device once.  Run each role:

  python -m srsran_tpu_torch.apps.run_lte_3proc --role epc --s1ap-port 36412 --gtpu-port 2152
  python -m srsran_tpu_torch.apps.run_lte_3proc --role enb --s1ap 127.0.0.1:36412 \\
      --gtpu 127.0.0.1:2152 --phy-port 2300
  python -m srsran_tpu_torch.apps.run_lte_3proc --role ue --phy 127.0.0.1:2300

With `--tun` (root): the UE attaches a kernel TUN inside a netns and
the EPC raises the SGi TUN + runs a real `ping` through the whole
stack, exactly like run_lte.sh.  Each role prints one JSON result line:
the reference's keys, and for the eNB and the UE also the device, the MAP
kernel's launches by mode (`turbo_cuda.LAUNCHES` less `LAUNCHES_DYN`, and
`LAUNCHES_DYN`), its launch shapes (`turbo_cuda.SHAPES`: B, nw, lw, T,
dynamic-K mode, count) and the lockstep TTI's host times: `tti_ms` and
`tti_ms_mean`, the median and the mean interval between completed
exchanges, and `busy_ms`, the median time of the process's own part of a
TTI (its `run_tti` and the read of its subframe, after which the device is
idle; the first TTI left out).
"""

import argparse
import json
import os
import socket
import statistics
import struct
import subprocess
import sys
import time

import numpy as np
import torch

from ..device import as_samples, resolve

IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
# the directory that holds the package, for `python -m` in a child process
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _frame_send(sock: socket.socket, data: bytes):
    sock.sendall(struct.pack(">I", len(data)) + data)


def _frame_recv(sock: socket.socket) -> bytes | None:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    n = struct.unpack(">I", hdr)[0]
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            return None
        out += chunk
    return out


def _drain_frames(sock: socket.socket, out: list, buf: bytearray) -> None:
    """Nonblocking: append every whole frame queued on `sock` to `out`.

    `buf` is the socket's receive buffer, held by the caller from one call
    to the next: the bytes of a frame whose header or body has not all
    arrived wait there, so a frame split across calls comes out whole and
    the stream keeps its framing.  A closed peer ends the read as an empty
    socket does."""
    sock.setblocking(False)
    try:
        while True:
            try:
                chunk = sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                break
            if not chunk:
                break
            buf += chunk
    finally:
        sock.setblocking(True)
    while len(buf) >= 4:
        n = struct.unpack_from(">I", buf)[0]
        if len(buf) < 4 + n:
            break
        out.append(bytes(buf[4 : 4 + n]))
        del buf[: 4 + n]


class _Clock:
    """The lockstep TTI's host times of one process: the intervals between
    completed exchanges, and the process's own part of each TTI."""

    def __init__(self, device):
        self.device = device
        self.t_first = None
        self._t_last = None
        self.intervals: list[float] = []
        self.busy: list[float] = []

    def tick(self):
        """One completed exchange."""
        now = time.perf_counter()
        if self.t_first is None:
            self.t_first = now
        else:
            self.intervals.append(now - self._t_last)
        self._t_last = now

    def host(self, t: torch.Tensor | None) -> bytes:
        """The subframe's bytes for the socket (b"" for None) once the
        device has finished the process's part of the TTI."""
        if t is None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return b""
        return t.cpu().numpy().tobytes()

    def fields(self) -> dict:
        def ms(xs):
            return 1e3 * statistics.median(xs) if xs else None

        return {"tti_ms": ms(self.intervals), "busy_ms": ms(self.busy[1:]),
                "tti_ms_mean": 1e3 * statistics.fmean(self.intervals) if self.intervals else None}


def _kernel_fields(device) -> dict:
    from ..phy.fec import turbo_cuda

    return {"device": str(device),
            "map_launches": {"static": turbo_cuda.LAUNCHES - turbo_cuda.LAUNCHES_DYN,
                             "dyn": turbo_cuda.LAUNCHES_DYN},
            "map_shapes": [[*k, n] for k, n in sorted(turbo_cuda.SHAPES.items())]}


# ==========================================================================
# EPC process: MME + HSS + SPGW behind real listeners
# ==========================================================================


def run_epc(args):
    from ..epc import Hss, Mme, Spgw, Subscriber
    from ..stack import security as sec

    opc = sec.compute_opc(KEY, bytes.fromhex(
        "63bfa50ee6523365ff14c1f45f88737d"))
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, opc, amf=b"\x80\x00",
                                  sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)

    # S1AP: TCP with length framing — the SCTP stand-in (mme.cc:25)
    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ls.bind(("127.0.0.1", args.s1ap_port))
    ls.listen(1)
    # GTP-U: the real UDP:2152 (gtpu.cc)
    gu = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    gu.bind(("127.0.0.1", args.gtpu_port))
    gu.setblocking(False)
    print(json.dumps({"epc": "listening"}), flush=True)

    conn, _addr = ls.accept()
    conn_buf = bytearray()
    enb_gtpu_addr = None
    if args.tun:
        spgw.attach_tun(name="tun_sgi3p")
    dl_sent = 0
    # the duration clock starts at the first UE attach: the peers spend
    # a machine-dependent stretch in import, device start-up and the first
    # TTIs, and a wall deadline from process start makes the run length a
    # startup lottery (hard cap keeps a stuck run bounded)
    t_end = None
    t_hard = time.time() + args.duration + 120.0
    attached_ip = None
    last_dl = 0.0
    while (t_end is None or time.time() < t_end) and time.time() < t_hard:
        msgs: list = []
        _drain_frames(conn, msgs, conn_buf)
        for m in msgs:
            for resp in mme.handle(m, enb_id=0x19B):
                _frame_send(conn, resp)
        mme.pump_s11()
        try:
            while True:
                pkt, addr = gu.recvfrom(65536)
                enb_gtpu_addr = addr
                spgw.rx_from_enb(pkt)
        except BlockingIOError:
            pass
        # DL GTP-U waits in the SPGW's queue until the eNB's address is
        # known (its first UL packet): the reference pops one packet per
        # loop pass before that and drops it
        while enb_gtpu_addr and (pkt := spgw.pop_tx()) is not None:
            gu.sendto(pkt, enb_gtpu_addr)
        if args.tun:
            spgw.pump_tun()
        if attached_ip is None and mme.attached_imsis:
            for ue in mme.ues.values():
                if ue.ue_ip:
                    attached_ip = ue.ue_ip
            if attached_ip is not None and t_end is None:
                t_end = time.time() + args.duration
        if (attached_ip and dl_sent < args.n_dl and not args.tun
                and time.time() - last_dl > 0.01):
            # synthetic DL payloads (host-queue mode only: with --tun
            # the traffic is the real kernel ICMP)
            spgw.sgi_tx(attached_ip, bytes([dl_sent & 0xFF]) * 120)
            dl_sent += 1
            last_dl = time.time()
        time.sleep(0.001)
    print(json.dumps({
        "role": "epc", "attached": sorted(mme.attached_imsis),
        "ue_ip": attached_ip, "dl_sent": dl_sent,
        "sgi_rx": len(spgw.sgi_rx),
    }), flush=True)


# ==========================================================================
# eNB process: full EnbStack with socket proxies toward the EPC
# ==========================================================================


class MmeProxy:
    """The EnbStack-facing MME handle whose transport is the S1AP
    socket: `handle()` writes frames, inbound frames are pumped back
    into the stack's registered link (s1ap.cc role)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._rx = bytearray()  # a frame not yet whole (`_drain_frames`)
        self._link = None

    def register_enb(self, enb_id: int, link):
        self._link = link

    def handle(self, msg: bytes, enb_id: int | None = None) -> list:
        _frame_send(self.sock, msg)
        return []  # responses arrive asynchronously via pump()

    def pump(self):
        msgs: list = []
        _drain_frames(self.sock, msgs, self._rx)
        for m in msgs:
            if self._link is not None:
                self._link(m)


class SpgwProxy:
    """The EnbStack-facing S1-U handle: GTP-U PDUs cross UDP:2152 in
    both directions (gtpu.cc)."""

    def __init__(self, addr):
        from collections import deque

        self.addr = addr
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.setblocking(False)
        self.tx_queue = deque()  # local requeue buffer (_pump_spgw holds
        #                          packets for not-yet-active bearers)

    def rx_from_enb(self, pkt: bytes):
        self.sock.sendto(pkt, self.addr)

    def pop_tx(self):
        if self.tx_queue:
            return self.tx_queue.popleft()
        try:
            pkt, _ = self.sock.recvfrom(65536)
            return pkt
        except BlockingIOError:
            return None


def run_enb(args, device):
    from ..phy.common import Cell
    from .full_stack import EnbStack

    host, port = args.s1ap.split(":")
    s1 = socket.create_connection((host, int(port)))
    ghost, gport = args.gtpu.split(":")
    mme = MmeProxy(s1)
    spgw = SpgwProxy((ghost, int(gport)))
    cell = Cell(nof_prb=args.prb, nof_ports=1, id=7)
    enb = EnbStack(cell, mme, spgw, mcs=8, device=device)

    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ls.bind(("127.0.0.1", args.phy_port))
    ls.listen(1)
    print(json.dumps({"enb": "listening"}), flush=True)
    conn, _ = ls.accept()

    clock = _Clock(device)
    ul = None
    n_tti = 0
    # clock from the first completed TTI exchange (see run_epc note)
    t_end = None
    t_hard = time.time() + args.duration + 120.0
    while (t_end is None or time.time() < t_end) and time.time() < t_hard:
        if t_end is None and n_tti >= 1:
            t_end = time.time() + args.duration
        t0 = time.perf_counter()
        mme.pump()
        dl = clock.host(enb.run_tti(ul))
        clock.busy.append(time.perf_counter() - t0)
        # PHY frame toward the UE (REQ/REP lockstep, rf_zmq pattern);
        # the peer may have hit its own deadline — exit on a closed link
        try:
            _frame_send(conn, dl)
            fr = _frame_recv(conn)
        except OSError:
            break
        if fr is None:
            break
        ul = as_samples(np.frombuffer(fr, np.complex64), device) if fr else None
        n_tti += 1
        clock.tick()
    print(json.dumps({
        "role": "enb", "ttis": n_tti,
        "ul_crc_ok": enb.stats.get("ul_crc_ok", 0),
        "ues": [hex(r) for r in enb.ues],
        **_kernel_fields(device), **clock.fields(),
    }), flush=True)


# ==========================================================================
# UE process
# ==========================================================================


def run_ue(args, device):
    from ..phy.common import Cell
    from ..stack import security as sec
    from ..stack.nas_ue import Usim
    from .full_stack import UeStack

    opc = sec.compute_opc(KEY, bytes.fromhex(
        "63bfa50ee6523365ff14c1f45f88737d"))
    cell = Cell(nof_prb=args.prb, nof_ports=1, id=7)
    ue = UeStack(cell, Usim(IMSI, KEY, opc), device=device)
    host, port = args.phy.split(":")
    # up to 60 s for the eNB to listen (the reference waits 10 s): its
    # device start-up on the card may take longer
    for _ in range(600):
        try:
            sock = socket.create_connection((host, int(port)))
            break
        except OSError:
            time.sleep(0.1)
    else:
        raise ConnectionError(f"no eNB listening at {args.phy}")
    clock = _Clock(device)
    ul_sent = 0
    ping_proc = None
    ping_out = ""
    n_rx = 0
    attached = None  # (TTI, seconds from the first exchange) at registration
    # clock from the first completed TTI exchange (see run_epc note)
    t_end = None
    t_hard = time.time() + args.duration + 120.0
    while (t_end is None or time.time() < t_end) and time.time() < t_hard:
        if t_end is None and n_rx >= 1:
            t_end = time.time() + args.duration
        try:
            fr = _frame_recv(sock)
        except OSError:
            break
        if fr is None:
            break
        t0 = time.perf_counter()
        ul = clock.host(ue.run_tti(as_samples(np.frombuffer(fr, np.complex64), device)))
        clock.busy.append(time.perf_counter() - t0)
        try:
            _frame_send(sock, ul)
        except OSError:
            break
        n_rx += 1
        clock.tick()
        if (ue.rrc_state == UeStack.RRC_ACTIVE
                and ue.nas.state == ue.nas.REGISTERED):
            if attached is None:
                attached = (n_rx, time.perf_counter() - clock.t_first)
            if args.tun and ping_proc is None:
                # kernel IP boundary in a netns + a real ping toward the
                # SGi gateway — the run_lte.sh:288-312 procedure
                gw = ue.attach_tun(name="tun_ue3p", netns=args.netns)
                gw.tun.add_route("default")
                env = dict(os.environ, PYTHONPATH=PKG_ROOT)
                ping_proc = subprocess.Popen(
                    ["ip", "netns", "exec", args.netns, sys.executable, "-m",
                     "srsran_tpu_torch.io.icmp_ping", "172.16.0.254", "3",
                     "40"],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, env=env)
            if ul_sent < args.n_ul and not args.tun:
                ue.send_ip_packet(bytes([0x45, ul_sent & 0xFF]) * 60)
                ul_sent += 1
    ping_rc = None
    if ping_proc is not None:
        try:
            ping_out, _ = ping_proc.communicate(timeout=10)
        except Exception:
            ping_proc.kill()
        ping_rc = ping_proc.returncode
    print(json.dumps({
        "role": "ue", "registered": ue.nas.state == ue.nas.REGISTERED,
        "ue_ip": ue.ue_ip, "ip_rx": len(ue.ip_rx), "ul_sent": ul_sent,
        "ping_rc": ping_rc, "ping_out": ping_out[-200:],
        "ttis": n_rx, "attached_tti": None if attached is None else attached[0],
        "attached_s": None if attached is None else attached[1],
        **_kernel_fields(device), **clock.fields(),
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", required=True, choices=("epc", "enb", "ue"))
    ap.add_argument("--s1ap-port", type=int, default=36412)
    ap.add_argument("--gtpu-port", type=int, default=2152)
    ap.add_argument("--s1ap", default="127.0.0.1:36412")
    ap.add_argument("--gtpu", default="127.0.0.1:2152")
    ap.add_argument("--phy", default="127.0.0.1:2300")
    ap.add_argument("--phy-port", type=int, default=2300)
    ap.add_argument("--prb", type=int, default=15)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--n-dl", type=int, default=12)
    ap.add_argument("--n-ul", type=int, default=6)
    ap.add_argument("--tun", action="store_true")
    ap.add_argument("--netns", default="srstpu_3p")
    ap.add_argument("--device", default=None,
                    help="torch device of the eNB's and the UE's PHY (default: the card)")
    args = ap.parse_args()
    if args.role == "epc":
        run_epc(args)
    else:
        {"enb": run_enb, "ue": run_ue}[args.role](args, resolve(args.device))


if __name__ == "__main__":
    main()
