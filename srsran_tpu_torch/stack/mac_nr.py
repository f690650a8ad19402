"""Host copy of `srsran_tpu/stack/mac_nr.py`, held to it by `tests/test_torch_stack.py`.

NR MAC PDU codec, TS 38.321 §6.1 (re-design of
`lib/src/mac/mac_nr_pdu.cc` — part of the reference's 5G-NR
scaffolding, which has no NR PHY).

SubPDU header: R | F | LCID(6), followed by an 8- or 16-bit L field for
variable-length subPDUs (F selects 16-bit). Fixed-size CEs and UL-CCCH
carry no L. The last subPDU of a DL-SCH may be padding (LCID 63).
"""

from __future__ import annotations

LCID_CCCH_NR = 0
LCID_PADDING_NR = 63
# fixed-size UL CE sizes (TS 38.321 Table 6.2.1-2 subset)
UL_CE_SIZES = {59: 1, 60: 1, 61: 2, 62: 4}  # short BSR, trunc BSR, C-RNTI, long BSR(4)
DL_CE_SIZES = {62: 6, 61: 1, 60: 0}  # contention resolution, TA command, ...
CCCH_SDU_LEN = 6  # UL-CCCH fixed 48-bit Msg3


def mac_nr_pack(
    subpdus: list[tuple[int, bytes]], tb_size: int | None = None, is_ul: bool = True
) -> bytes:
    """Pack (lcid, payload) subPDUs; pad with LCID 63 to tb_size if given.

    LCID 0 is the fixed-48-bit CCCH only on UL-SCH (Msg3); on DL-SCH the
    CCCH subPDU carries a normal L field (TS 38.321 Table 6.2.1-1).
    """
    out = bytearray()
    for lcid, payload in subpdus:
        n = len(payload)
        if lcid == LCID_CCCH_NR and is_ul:
            out.append(lcid & 0x3F)  # no L field
            out += payload
        elif lcid in UL_CE_SIZES or lcid in DL_CE_SIZES:
            out.append(lcid & 0x3F)
            out += payload
        elif n < 256:
            out.append(lcid & 0x3F)  # F=0 → 8-bit L
            out.append(n)
            out += payload
        else:
            out.append(0x40 | (lcid & 0x3F))  # F=1 → 16-bit L
            out += n.to_bytes(2, "big")
            out += payload
    if tb_size is not None and len(out) < tb_size:
        pad = tb_size - len(out) - 1
        out.append(LCID_PADDING_NR)
        out += b"\x00" * pad
    return bytes(out)


def mac_nr_unpack(pdu: bytes, is_ul: bool = False) -> list[tuple[int, bytes]]:
    """Unpack → [(lcid, payload)], padding stripped."""
    out = []
    pos = 0
    while pos < len(pdu):
        hdr = pdu[pos]
        f = bool(hdr & 0x40)
        lcid = hdr & 0x3F
        pos += 1
        if lcid == LCID_PADDING_NR:
            break
        if lcid == LCID_CCCH_NR and is_ul:
            out.append((lcid, pdu[pos : pos + CCCH_SDU_LEN]))
            pos += CCCH_SDU_LEN
            continue
        ce_sizes = UL_CE_SIZES if is_ul else DL_CE_SIZES
        if lcid in ce_sizes:
            n = ce_sizes[lcid]
            out.append((lcid, pdu[pos : pos + n]))
            pos += n
            continue
        if f:
            n = int.from_bytes(pdu[pos : pos + 2], "big")
            pos += 2
        else:
            n = pdu[pos]
            pos += 1
        out.append((lcid, pdu[pos : pos + n]))
        pos += n
    return out
