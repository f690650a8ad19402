"""Host copy of `srsran_tpu/io/tun.py`, held to it by `tests/test_torch_stack.py`.

Kernel TUN-device IP boundary.

Re-design of the reference's gateways: the UE side (`srsue/src/stack/upper/
gw.cc`, 632 LoC — TUN up/down, IP packet pump) and the SPGW's SGi TUN
(`srsepc/src/spgw/gtpu.cc`).  User IP packets enter/leave the stack through
a real kernel interface, so standard tools (ping, iperf, sockets) exercise
the whole RAN path — the reference's E2E test does exactly this through
network namespaces (`test/run_lte.sh:288-312`).

Pure-stdlib implementation (ioctl TUNSETIFF + `ip` for addressing); no
root-only operation is hidden: `TunDevice.available()` reports whether the
environment permits TUN at all, and callers fall back to the in-memory
packet path when it does not (containerized CI often forbids it).
"""

from __future__ import annotations

import fcntl
import os
import select
import struct
import subprocess

TUNSETIFF = 0x400454CA
IFF_TUN = 0x0001
IFF_NO_PI = 0x1000
_CLONE = "/dev/net/tun"


class TunDevice:
    """One TUN interface: read() pops an IP packet the kernel routed to
    the interface; write() injects an IP packet back into the kernel."""

    def __init__(self, name: str, ip_cidr: str, mtu: int = 1500,
                 netns: str | None = None):
        """``netns``: move the interface into that network namespace before
        configuring it (the reference's run_lte.sh:288 UE isolation — lets
        a single host ping itself through the whole RAN path).  The fd
        stays usable from the creating process regardless."""
        self.name = name
        self.netns = netns
        self.fd = os.open(_CLONE, os.O_RDWR | os.O_NONBLOCK)
        ifr = struct.pack("16sH", name.encode()[:15], IFF_TUN | IFF_NO_PI)
        fcntl.ioctl(self.fd, TUNSETIFF, ifr)
        if netns is not None:
            self._run("ip", "link", "set", name, "netns", netns)
        self._run(*self._ns(), "ip", "addr", "add", ip_cidr, "dev", name)
        self._run(*self._ns(), "ip", "link", "set", name, "mtu", str(mtu))
        self._run(*self._ns(), "ip", "link", "set", name, "up")

    def _ns(self) -> tuple[str, ...]:
        return ("ip", "netns", "exec", self.netns) if self.netns else ()

    @staticmethod
    def available() -> bool:
        """True when this environment can open + configure a TUN device."""
        if not os.path.exists(_CLONE):
            return False
        try:
            fd = os.open(_CLONE, os.O_RDWR)
        except OSError:
            return False
        try:
            fcntl.ioctl(fd, TUNSETIFF, struct.pack("16sH", b"tunprobe0", IFF_TUN | IFF_NO_PI))
        except OSError:
            return False
        finally:
            os.close(fd)
        return True

    @staticmethod
    def _run(*cmd: str):
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise OSError(f"{' '.join(cmd)}: {r.stderr.strip()}")

    def add_route(self, cidr: str):
        """Route a destination prefix into this interface (the gw.cc
        default-route / SPGW UE-pool route role)."""
        self._run(*self._ns(), "ip", "route", "replace", cidr, "dev", self.name)

    def read(self, max_pkts: int = 32) -> list[bytes]:
        """Drain up to max_pkts queued outbound IP packets (non-blocking)."""
        out = []
        for _ in range(max_pkts):
            r, _, _ = select.select([self.fd], [], [], 0)
            if not r:
                break
            try:
                pkt = os.read(self.fd, 65535)
            except BlockingIOError:
                break
            if pkt:
                out.append(pkt)
        return out

    def write(self, pkt: bytes):
        os.write(self.fd, pkt)

    def close(self):
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class UeGw:
    """UE-side gateway (`gw.cc` role): the UE's IP address lives on a TUN
    interface; outbound kernel packets become UL PDCP SDUs, DL SDUs are
    written back to the kernel."""

    def __init__(self, ue_ip: str, name: str = "tun_ue0", netns: str | None = None):
        self.tun = TunDevice(name, f"{ue_ip}/24", netns=netns)

    def pump_ul(self, send) -> int:
        """Forward queued kernel packets via ``send(pkt)``; returns count."""
        pkts = self.tun.read()
        for p in pkts:
            send(p)
        return len(pkts)

    def deliver_dl(self, pkt: bytes):
        self.tun.write(pkt)

    def close(self):
        self.tun.close()


class SpgwGi:
    """SPGW SGi-side TUN (`srsepc/src/spgw/gtpu.cc` role): the UE address
    pool is routed into the interface; packets the kernel sends there go
    down the GTP-U tunnel, uplink packets from UEs are injected back."""

    def __init__(self, pool_cidr: str = "172.16.0.0/24", gw_ip: str = "172.16.0.254",
                 name: str = "tun_sgi0"):
        self.tun = TunDevice(name, f"{gw_ip}/24")

    def pump_dl(self, send_to_ue) -> int:
        """Forward kernel→pool packets via ``send_to_ue(dst_ip, pkt)``."""
        pkts = self.tun.read()
        for p in pkts:
            if len(p) >= 20 and (p[0] >> 4) == 4:
                dst = ".".join(str(b) for b in p[16:20])
                send_to_ue(dst, p)
        return len(pkts)

    def inject_ul(self, pkt: bytes):
        self.tun.write(pkt)

    def close(self):
        self.tun.close()
