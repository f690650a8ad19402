"""Host copy of `srsran_tpu/apps/ttcn3.py`, held to it by `tests/test_torch_stack.py`;
`Ttcn3UePhy(device=)` and `SystemInterface(device=)` pass the device of the
port's `UeStack` through (None: the card).

TTCN-3-style conformance harness: the UE stack with the PHY replaced
by a fake driven over newline-delimited JSON on TCP (re-design of
`srsue/test/ttcn3/` — `lte_ttcn3_phy.h:36` implements `ue_lte_phy_base`
and the SYSTEM interface carries MAC PDUs + cell commands over JSON/TCP
ports).

The system simulator (test side) connects and drives:

  {"cmd": "cell_cfg", "pci": 1, "nof_prb": 6}      configure/select a cell
  {"cmd": "attach"}                                 trigger attach
  {"cmd": "rar", "rapid": 17, "temp_crnti": 70}     deliver the RAR
  {"cmd": "dl_pdu", "data": "<hex MAC PDU>"}        DL MAC PDU toward the UE
  {"cmd": "ul_pdu", "size": 64}                     pull one UL MAC PDU
  {"cmd": "status"}                                 RRC state etc.
  {"cmd": "ip_rx"}                                  pop a received IP packet

Responses are one JSON object per line: {"event": ..., ...}.  Events the
UE raises (PRACH transmission) are returned by the command that caused
them — the transport stays strictly request/response like the
reference's TTCN-3 ports.
"""

from __future__ import annotations

import json
import socket
import threading

from ..phy.common import Cell
from ..stack.nas_ue import Usim
from .full_stack import UeStack


class Ttcn3UePhy:
    """Fake PHY wrapping a UeStack: MAC PDUs in/out, no waveforms
    (the lte_ttcn3_phy role)."""

    def __init__(self, device=None):
        self.device = device  # the UeStack's device: None is the card
        self.stack: UeStack | None = None
        self.prach_sent: list[int] = []

    def cell_cfg(self, pci: int, nof_prb: int) -> dict:
        cell = Cell(nof_prb=nof_prb, nof_ports=1, id=pci)
        usim = Usim(imsi="001010123456789", key=bytes(range(16)), opc=bytes(16))
        self.stack = UeStack(cell, usim, device=self.device)
        return {"event": "cell_ready", "pci": pci}

    def attach(self) -> dict:
        s = self.stack
        s.start_attach()
        # the fake PHY "transmits" the preamble instantly
        s.mac.start_ra(s.preamble)
        s.rrc_state = UeStack.RRC_WAIT_RAR
        self.prach_sent.append(s.preamble)
        return {"event": "prach", "preamble": s.preamble}

    def rar(self, rapid: int, temp_crnti: int, ta: int = 0, grant20: int = 0) -> dict:
        from .full_stack import _pack_rar

        self.stack._handle_rar(self.stack.tti, _pack_rar(rapid, ta, grant20, temp_crnti))
        return {"event": "rar_processed", "crnti": self.stack.crnti}

    def dl_pdu(self, data: bytes) -> dict:
        self.stack._handle_dl_pdu(data)
        return {"event": "dl_processed", "rrc_state": self.stack.rrc_state}

    def ul_pdu(self, size: int) -> dict:
        pdu = self.stack._build_ul_mac_pdu(size)
        return {"event": "ul_pdu", "data": pdu.hex()}

    def status(self) -> dict:
        s = self.stack
        return {
            "event": "status",
            "rrc_state": s.rrc_state if s else -1,
            "crnti": s.crnti if s else None,
            "stats": dict(s.stats) if s else {},
        }

    def ip_rx(self) -> dict:
        s = self.stack
        pkt = s.ip_rx.pop(0) if s and s.ip_rx else None
        return {"event": "ip_rx", "data": pkt.hex() if pkt else None}

    def handle(self, msg: dict) -> dict:
        cmd = msg.get("cmd")
        if cmd == "cell_cfg":
            return self.cell_cfg(int(msg["pci"]), int(msg["nof_prb"]))
        if cmd == "attach":
            return self.attach()
        if cmd == "rar":
            return self.rar(int(msg["rapid"]), int(msg["temp_crnti"]),
                            int(msg.get("ta", 0)), int(msg.get("grant20", 0)))
        if cmd == "dl_pdu":
            return self.dl_pdu(bytes.fromhex(msg["data"]))
        if cmd == "ul_pdu":
            return self.ul_pdu(int(msg.get("size", 128)))
        if cmd == "status":
            return self.status()
        if cmd == "ip_rx":
            return self.ip_rx()
        return {"event": "error", "detail": f"unknown cmd {cmd!r}"}


class SystemInterface:
    """One-connection JSON/TCP server (the SYS port)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1", device=None):
        self.phy = Ttcn3UePhy(device=device)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self._thread: threading.Thread | None = None
        self._stop = False

    def serve_background(self):
        self._thread = threading.Thread(target=self.serve_once, daemon=True)
        self._thread.start()

    def serve_once(self):
        conn, _ = self.sock.accept()
        with conn, conn.makefile("rwb") as f:
            while not self._stop:
                line = f.readline()
                if not line:
                    break
                try:
                    resp = self.phy.handle(json.loads(line))
                except Exception as e:  # report, keep serving
                    resp = {"event": "error", "detail": repr(e)}
                f.write((json.dumps(resp) + "\n").encode())
                f.flush()

    def close(self):
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass
        if self._thread:
            self._thread.join(timeout=2)
