"""Host copy of `srsran_tpu/runtime/pcap.py`, held to it by `tests/test_torch_stack.py`.

Wireshark-compatible MAC-LTE packet capture (DLT 147).

Byte-for-byte the reference's format (`lib/src/common/pcap.c:62-120`,
`pcap.h:29-96`): pcap global header with network=147, and per packet the
mac-lte context (radioType, direction, rntiType + RNTI/UEID/frame/CRC/CC/NB
tags) immediately followed by the payload tag and MAC PDU — so captures
open in Wireshark's LTE MAC dissector directly.
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
        self._f.write(
            struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, MAC_LTE_DLT)
        )

    def write_pdu(
        self,
        pdu: bytes,
        rnti: int,
        direction: int = DIRECTION_DOWNLINK,
        rnti_type: int = C_RNTI,
        sfn: int = 0,
        sf_idx: int = 0,
        crc_ok: bool = True,
        cc_idx: int = 0,
    ):
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


NAS_LTE_DLT = 148
RLC_LTE_DLT = 149
S1AP_DLT = 150


class NasPcap:
    """NAS-EPS capture (DLT 148; lib/src/common/nas_pcap.cc): raw NAS
    messages, dissected by Wireshark's nas-eps."""

    def __init__(self, path: str, ue_id: int = 0):
        self._f = open(path, "wb")
        self.ue_id = ue_id
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, NAS_LTE_DLT))

    def write_pdu(self, pdu: bytes):
        t = time.time()
        self._f.write(struct.pack("<IIII", int(t), int((t % 1) * 1e6), len(pdu), len(pdu)))
        self._f.write(pdu)
        self._f.flush()

    def close(self):
        self._f.close()


class S1apPcap:
    """S1AP capture (DLT 150; lib/src/common/s1ap_pcap.cc): raw control
    messages (this framework's TLV codec rather than ASN.1 PER)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, S1AP_DLT))

    def write_pdu(self, pdu: bytes):
        t = time.time()
        self._f.write(struct.pack("<IIII", int(t), int((t % 1) * 1e6), len(pdu), len(pdu)))
        self._f.write(pdu)
        self._f.flush()

    def close(self):
        self._f.close()


class RlcPcap:
    """RLC-LTE capture (DLT 149; lib/src/common/rlc_pcap.cc context
    format): rlc-lte context header + PDU for the Wireshark dissector."""

    RLC_TM, RLC_UM, RLC_AM = 1, 2, 4
    _SN_LENGTH_TAG = 0x02
    _DIRECTION_TAG = 0x03
    _PRIORITY_TAG = 0x04
    _UEID_TAG = 0x05
    _CHANNEL_TYPE_TAG = 0x06
    _CHANNEL_ID_TAG = 0x07
    _PAYLOAD_TAG = 0x01

    def __init__(self, path: str, ue_id: int = 1):
        self._f = open(path, "wb")
        self.ue_id = ue_id
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, RLC_LTE_DLT))

    def write_pdu(self, pdu: bytes, mode: int = 4, direction: int = 1, lcid: int = 1, sn_bits: int = 10):
        body = bytes([FDD_RADIO, mode, 0])  # radioType, rlcMode, priority=0
        body += bytes([self._SN_LENGTH_TAG, sn_bits])
        body += bytes([self._DIRECTION_TAG, direction])
        body += bytes([self._UEID_TAG]) + struct.pack(">H", self.ue_id)
        body += bytes([self._CHANNEL_TYPE_TAG, 4])  # DRB
        body += bytes([self._CHANNEL_ID_TAG]) + struct.pack(">H", lcid)
        body += bytes([self._PAYLOAD_TAG]) + pdu
        t = time.time()
        self._f.write(struct.pack("<IIII", int(t), int((t % 1) * 1e6), len(body), len(body)))
        self._f.write(body)
        self._f.flush()

    def close(self):
        self._f.close()
