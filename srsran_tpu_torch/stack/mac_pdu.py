"""MAC PDU pack/unpack, TS 36.321 §6 (re-design of `lib/src/mac/pdu.cc`).

Host copy of `srsran_tpu/stack/mac_pdu.py` for the port's apps.  Supports
R/R/E/LCID(/F/L) subheaders with multiple SDUs and padding — the subset needed to carry data bearers and be dissectable by Wireshark's
MAC-LTE dissector (pcaps from `srsran_tpu_torch.runtime.pcap`).
"""

from __future__ import annotations

LCID_PADDING = 31
LCID_DTCH = 3  # first data bearer

# Fixed-size MAC control elements (TS 36.321 §6.1.3): their subheaders
# carry no F/L field.  The LCID space differs per direction (pdu.cc
# dl_sch_lcid vs ul_sch_lcid).
LCID_SCELL_ACT = 27  # Activation/Deactivation CE (TS 36.321 §6.1.3.8, R10 CA)

DL_CE_SIZES = {
    27: 1,  # SCell Activation/Deactivation (C7..C1 bitmap + R)
    28: 6,  # UE Contention Resolution Identity
    29: 1,  # Timing Advance Command
    30: 0,  # DRX Command
}


def scell_activation_ce(active_indices: set[int] | list[int]) -> bytes:
    """One-octet Activation/Deactivation CE: bit Ci (i=1..7) activates
    SCellIndex i; bit 0 reserved (TS 36.321 §6.1.3.8)."""
    v = 0
    for i in active_indices:
        if 1 <= i <= 7:
            v |= 1 << i
    return bytes([v])


def scell_activation_parse(ce: bytes) -> set[int]:
    v = ce[0]
    return {i for i in range(1, 8) if v & (1 << i)}
UL_CE_SIZES = {
    26: 1,  # Power Headroom Report
    27: 2,  # C-RNTI
    28: 1,  # Truncated BSR
    29: 1,  # Short BSR
    30: 3,  # Long BSR
}


def _sdu_subheader(lcid: int, length: int, is_last: bool, fixed: bool) -> bytes:
    """R/R/E/LCID (+F/L unless last-in-chain or a fixed-size CE)."""
    if is_last:
        return bytes([lcid & 0x1F])  # E=0, no L
    if fixed:
        return bytes([0x20 | (lcid & 0x1F)])  # E=1, no L (fixed-size CE)
    if length < 128:
        return bytes([0x20 | (lcid & 0x1F), length & 0x7F])
    return bytes([0x20 | (lcid & 0x1F), 0x80 | ((length >> 8) & 0x7F), length & 0xFF])


def mac_pack(sdus: list[tuple[int, bytes]], tb_size: int, ce_sizes: dict[int, int] | None = None) -> bytes:
    """Pack (lcid, payload) SDUs into a TB of tb_size bytes, padding as
    needed (TS 36.321 §6.1.2: 1-2 padding subheaders lead the chain; larger
    padding is one E=0 padding subheader at the end of it).  Pass
    DL_CE_SIZES/UL_CE_SIZES as ce_sizes so control elements get their
    spec-true fixed-size subheaders."""
    assert sdus, "at least one SDU"
    ce_sizes = ce_sizes or {}
    for lcid, pl in sdus:
        if lcid in ce_sizes and len(pl) != ce_sizes[lcid]:
            raise ValueError(f"CE lcid {lcid} must be {ce_sizes[lcid]} bytes, got {len(pl)}")

    def layout(trailing_pad: bool):
        hdr = bytearray()
        for i, (lcid, pl) in enumerate(sdus):
            is_last = (i == len(sdus) - 1) and not trailing_pad
            hdr += _sdu_subheader(lcid, len(pl), is_last, lcid in ce_sizes)
        if trailing_pad:
            hdr.append(LCID_PADDING)  # E=0 padding subheader closes the chain
        return hdr

    body = sum(len(p) for _, p in sdus)
    # first try: no trailing padding subheader
    hdr = layout(False)
    pad = tb_size - len(hdr) - body
    if pad < 0:
        raise ValueError(f"TB too small: need {len(hdr)+body}, have {tb_size}")
    if pad in (1, 2):
        # 1-2 single-byte padding subheaders at the START of the header
        pdu = bytes([0x20 | LCID_PADDING] * pad) + bytes(hdr) + b"".join(p for _, p in sdus)
        return pdu
    if pad > 2:
        hdr = layout(True)
        pdu = bytes(hdr) + b"".join(p for _, p in sdus)
        return pdu + b"\x00" * (tb_size - len(pdu))
    return bytes(hdr) + b"".join(p for _, p in sdus)


def mac_unpack(pdu: bytes, ce_sizes: dict[int, int] | None = None) -> list[tuple[int, bytes]]:
    """Unpack a MAC PDU → list of (lcid, payload), padding stripped."""
    ce_sizes = ce_sizes or {}
    subheaders = []  # (lcid, length or None)
    pos = 0
    while pos < len(pdu):
        b = pdu[pos]
        pos += 1
        e = (b >> 5) & 1
        lcid = b & 0x1F
        if lcid == LCID_PADDING:
            if e:
                subheaders.append((lcid, 0))
                continue
            subheaders.append((lcid, None))
            break
        if lcid in ce_sizes:
            subheaders.append((lcid, ce_sizes[lcid]))
            if e == 0:
                break
            continue
        if e == 0:
            subheaders.append((lcid, None))  # last: rest of PDU
            break
        f_l = pdu[pos]
        pos += 1
        if f_l & 0x80:
            length = ((f_l & 0x7F) << 8) | pdu[pos]
            pos += 1
        else:
            length = f_l & 0x7F
        subheaders.append((lcid, length))
    out = []
    for i, (lcid, length) in enumerate(subheaders):
        if lcid == LCID_PADDING:
            continue
        if length is None:
            payload = pdu[pos:]
            out.append((lcid, payload))
            break
        out.append((lcid, pdu[pos : pos + length]))
        pos += length
    return out
