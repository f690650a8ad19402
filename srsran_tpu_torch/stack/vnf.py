"""Host copy of `srsran_tpu/stack/vnf.py`, held to it by `tests/test_torch_stack.py`.

VNF/PNF split-PHY message protocol (5G-NR scaffolding), the analog of
`lib/src/common/basic_vnf.cc` / `basic_vnf_api.h`.

The reference's NR mode splits the stack (VNF) from a remote PHY (PNF)
over a UDP message protocol: SF_IND (PNF→VNF per slot), DL_CONFIG and
TX_REQUEST (VNF→PNF), RX_DATA_IND (PNF→VNF). This module provides the
codec plus in-process endpoint classes that drive the exchange — the
seam where a future NR PHY slots in.
"""

from __future__ import annotations

import dataclasses
import struct
from collections import deque

SF_IND = 0
DL_CONFIG = 1
TX_REQUEST = 2
RX_DATA_IND = 3

_HDR = struct.Struct("<II")  # type, body length


def pack_sf_ind(t1: int, tti: int) -> bytes:
    body = struct.pack("<II", t1, tti)
    return _HDR.pack(SF_IND, len(body)) + body


def pack_dl_config(t1: int, t2: int, tti: int, beam_id: int = 0) -> bytes:
    body = struct.pack("<IIIH", t1, t2, tti, beam_id)
    return _HDR.pack(DL_CONFIG, len(body)) + body


def pack_tx_request(tti: int, pdus: list[tuple[int, bytes]]) -> bytes:
    body = struct.pack("<II", tti, len(pdus))
    for index, data in pdus:
        body += struct.pack("<HH", len(data), index) + data
    return _HDR.pack(TX_REQUEST, len(body)) + body


def pack_rx_data_ind(t1: int, tti: int, pdus: list[bytes]) -> bytes:
    body = struct.pack("<III", t1, tti, len(pdus))
    for data in pdus:
        body += struct.pack("<H", len(data)) + data
    return _HDR.pack(RX_DATA_IND, len(body)) + body


def unpack(msg: bytes):
    """Returns (type, dict)."""
    mtype, blen = _HDR.unpack_from(msg)
    body = msg[_HDR.size : _HDR.size + blen]
    if mtype == SF_IND:
        t1, tti = struct.unpack("<II", body)
        return mtype, dict(t1=t1, tti=tti)
    if mtype == DL_CONFIG:
        t1, t2, tti, beam = struct.unpack("<IIIH", body)
        return mtype, dict(t1=t1, t2=t2, tti=tti, beam_id=beam)
    if mtype == TX_REQUEST:
        tti, n = struct.unpack_from("<II", body)
        pos = 8
        pdus = []
        for _ in range(n):
            ln, idx = struct.unpack_from("<HH", body, pos)
            pos += 4
            pdus.append((idx, body[pos : pos + ln]))
            pos += ln
        return mtype, dict(tti=tti, pdus=pdus)
    if mtype == RX_DATA_IND:
        t1, tti, n = struct.unpack_from("<III", body)
        pos = 12
        pdus = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<H", body, pos)
            pos += 2
            pdus.append(body[pos : pos + ln])
            pos += ln
        return mtype, dict(t1=t1, tti=tti, pdus=pdus)
    raise ValueError(f"unknown msg type {mtype}")


class Pnf:
    """PHY-side endpoint: emits SF indications, collects TX requests,
    delivers UL data."""

    def __init__(self):
        self.tti = 0
        self.tx_queue: deque = deque()
        self.dl_pdus: dict[int, list] = {}

    def slot_indication(self) -> bytes:
        msg = pack_sf_ind(t1=self.tti * 1000, tti=self.tti)
        self.tti += 1
        return msg

    def handle(self, msg: bytes):
        mtype, m = unpack(msg)
        if mtype == TX_REQUEST:
            self.dl_pdus.setdefault(m["tti"], []).extend(m["pdus"])

    def ul_data(self, tti: int, pdus: list[bytes]) -> bytes:
        return pack_rx_data_ind(t1=tti * 1000, tti=tti, pdus=pdus)


class Vnf:
    """Stack-side endpoint: responds to SF indications with DL config +
    TX requests; receives UL data."""

    def __init__(self):
        self.dl_source = deque()  # bytes to schedule
        self.rx_pdus: deque = deque()
        self.latencies: list[int] = []

    def handle(self, msg: bytes) -> list[bytes]:
        mtype, m = unpack(msg)
        out = []
        if mtype == SF_IND:
            out.append(pack_dl_config(t1=m["t1"], t2=m["t1"] + 1, tti=m["tti"]))
            if self.dl_source:
                out.append(pack_tx_request(m["tti"], [(0, self.dl_source.popleft())]))
        elif mtype == RX_DATA_IND:
            self.rx_pdus.extend(m["pdus"])
        return out
