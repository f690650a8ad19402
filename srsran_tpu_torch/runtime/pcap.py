"""Wireshark-compatible MAC-LTE packet capture (DLT 147).

Host copy of `MacPcap` from `srsran_tpu/runtime/pcap.py`, byte for byte the
reference's format (`lib/src/common/pcap.c:62-120`, `pcap.h:29-96`): the
pcap global header with network=147, and per packet the mac-lte context
(radioType, direction, rntiType + RNTI/UEID/frame/CRC/CC/NB tags) followed
by the payload tag and the MAC PDU.
"""

from __future__ import annotations

import struct
import time

MAC_LTE_DLT = 147
FDD_RADIO = 1
DIRECTION_UPLINK = 0
DIRECTION_DOWNLINK = 1
NO_RNTI, P_RNTI, RA_RNTI, C_RNTI, SI_RNTI = 0, 1, 2, 3, 4

_RNTI_TAG = 0x02
_UEID_TAG = 0x03
_FRAME_SUBFRAME_TAG = 0x04
_CRC_STATUS_TAG = 0x07
_CARRIER_ID_TAG = 0x0A
_NB_MODE_TAG = 0x0F
_PAYLOAD_TAG = 0x01


class MacPcap:
    def __init__(self, path: str, ue_id: int = 0):
        self._f = open(path, "wb")
        self.ue_id = ue_id
        # pcap global header (pcap.h pcap_hdr_t)
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, MAC_LTE_DLT))

    def write_pdu(self, pdu: bytes, rnti: int, direction: int = DIRECTION_DOWNLINK,
                  rnti_type: int = C_RNTI, sfn: int = 0, sf_idx: int = 0, crc_ok: bool = True,
                  cc_idx: int = 0):
        ctx = bytes([FDD_RADIO, direction, rnti_type])
        ctx += bytes([_RNTI_TAG]) + struct.pack(">H", rnti)
        ctx += bytes([_UEID_TAG]) + struct.pack(">H", self.ue_id)
        ctx += bytes([_FRAME_SUBFRAME_TAG]) + struct.pack(">H", (sfn << 4) | sf_idx)
        ctx += bytes([_CRC_STATUS_TAG, 1 if crc_ok else 0])
        ctx += bytes([_CARRIER_ID_TAG, cc_idx])
        ctx += bytes([_NB_MODE_TAG, 0])
        ctx += bytes([_PAYLOAD_TAG])
        total = len(ctx) + len(pdu)
        t = time.time()
        rec = struct.pack("<IIII", int(t), int((t % 1) * 1e6), total, total)
        self._f.write(rec + ctx + pdu)
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
