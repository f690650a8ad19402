"""DCI pack/unpack, TS 36.212 §5.3.3 — host side.

Copy of `srsran_tpu/phy/phch/dci.py`.  Formats: 0 (UL grant), 1 (RA type 0),
1A (compact), 1B (TM6 closed loop), 1C (SI/RAR/paging), 1D (TM5 MU-MIMO),
2 (TM4), 2A (TM3), 2B (TM8).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def riv_nbits(nof_prb: int) -> int:
    return int(math.ceil(math.log2(nof_prb * (nof_prb + 1) / 2)))


class _BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int):
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]

    def array(self) -> np.ndarray:
        return np.array(self.bits, np.uint8)


class _BitReader:
    def __init__(self, bits):
        self.bits = list(map(int, bits))
        self.pos = 0

    def get(self, n: int) -> int:
        v = int("".join(map(str, self.bits[self.pos : self.pos + n])), 2)
        self.pos += n
        return v


def _harq_bits(tdd: bool) -> int:
    """HARQ process number field width: 3 bits FDD, 4 bits TDD
    (reference dci.c:40 HARQ_PID_LEN)."""
    return 4 if tdd else 3


@dataclasses.dataclass
class Dci1A:
    """DCI format 1A (C-RNTI).  ``tdd=True`` widens the HARQ field to 4
    bits and appends the 2-bit DAI (reference dci.c:142-143,178)."""

    riv: int = 0
    mcs: int = 0
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    tpc: int = 0
    distributed: bool = False
    dai: int = 0  # TDD only

    # sizes that would collide with other formats get one padding bit
    # (TS 36.212 §5.3.3.1.3 "ambiguous sizes")
    AMBIGUOUS = {12, 14, 16, 20, 24, 26, 32, 40, 44, 56}

    @staticmethod
    def nof_bits(nof_prb: int, tdd: bool = False) -> int:
        n = 1 + 1 + riv_nbits(nof_prb) + 5 + _harq_bits(tdd) + 1 + 2 + 2
        n += 2 if tdd else 0  # DAI
        # format 0/1A are padded to equal size; 1A is already >= format 0 here
        if n in Dci1A.AMBIGUOUS:
            n += 1
        return n

    def pack(self, nof_prb: int, tdd: bool = False) -> np.ndarray:
        w = _BitWriter()
        w.put(1, 1)  # flag: 1 = format 1A
        w.put(int(self.distributed), 1)
        w.put(self.riv, riv_nbits(nof_prb))
        w.put(self.mcs, 5)
        w.put(self.harq_pid, _harq_bits(tdd))
        w.put(self.ndi, 1)
        w.put(self.rv, 2)
        w.put(self.tpc, 2)
        if tdd:
            w.put(self.dai, 2)
        out = w.array()
        pad = Dci1A.nof_bits(nof_prb, tdd) - len(out)
        if pad > 0:
            out = np.concatenate([out, np.zeros(pad, np.uint8)])
        return out

    @classmethod
    def unpack(cls, bits, nof_prb: int, tdd: bool = False) -> "Dci1A":
        r = _BitReader(bits)
        flag = r.get(1)
        if flag != 1:
            raise ValueError("not format 1A")
        dist = bool(r.get(1))
        riv = r.get(riv_nbits(nof_prb))
        mcs = r.get(5)
        harq = r.get(_harq_bits(tdd))
        ndi = r.get(1)
        rv = r.get(2)
        tpc = r.get(2)
        dai = r.get(2) if tdd else 0
        return cls(riv, mcs, harq, ndi, rv, tpc, dist, dai)


@dataclasses.dataclass
class Dci0:
    """DCI format 0 (UL grant).  In TDD, 2 extra bits follow the DMRS
    cyclic shift: the UL index for UL/DL config 0, the DAI otherwise
    (reference dci.c:545-551); 0/1A stay size-matched because 1A grows
    by the same amount."""

    riv: int = 0
    mcs: int = 0
    ndi: int = 0
    tpc: int = 0
    dmrs_cshift: int = 0
    cqi_request: bool = False
    hopping: bool = False
    ul_idx: int = 0  # TDD UL/DL config 0 only
    dai: int = 0  # TDD configs 1-6

    def pack(self, nof_prb: int, target_len: int | None = None,
             tdd: bool = False, tdd_cfg0: bool = False) -> np.ndarray:
        w = _BitWriter()
        w.put(0, 1)  # flag: 0 = format 0
        w.put(int(self.hopping), 1)
        w.put(self.riv, riv_nbits(nof_prb))
        w.put(self.mcs, 5)
        w.put(self.ndi, 1)
        w.put(self.tpc, 2)
        w.put(self.dmrs_cshift, 3)
        if tdd:
            w.put(self.ul_idx if tdd_cfg0 else self.dai, 2)
        w.put(int(self.cqi_request), 1)
        out = w.array()
        tgt = target_len or Dci1A.nof_bits(nof_prb, tdd)
        if len(out) < tgt:
            out = np.concatenate([out, np.zeros(tgt - len(out), np.uint8)])
        return out

    @classmethod
    def unpack(cls, bits, nof_prb: int, tdd: bool = False, tdd_cfg0: bool = False) -> "Dci0":
        r = _BitReader(bits)
        if r.get(1) != 0:
            raise ValueError("not format 0")
        hop = bool(r.get(1))
        riv = r.get(riv_nbits(nof_prb))
        mcs = r.get(5)
        ndi = r.get(1)
        tpc = r.get(2)
        cs = r.get(3)
        ul_idx = dai = 0
        if tdd:
            if tdd_cfg0:
                ul_idx = r.get(2)
            else:
                dai = r.get(2)
        cqi = bool(r.get(1))
        return cls(riv, mcs, ndi, tpc, cs, cqi, hop, ul_idx, dai)


@dataclasses.dataclass
class Dci1B:
    """DCI format 1B (single-layer closed-loop precoding, TM6;
    TS 36.212 §5.3.3.1.3A, dci.c format1B).

    Same body as 1A plus TPMI (2 bits for 2 ports, 4 for 4) and a PMI
    confirmation flag.  Padded at the 1A "ambiguous" sizes."""

    riv: int = 0
    mcs: int = 0
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    tpc: int = 0
    tpmi: int = 0
    pmi_confirm: int = 0
    distributed: bool = False
    dai: int = 0  # TDD only

    @staticmethod
    def _tpmi_bits(nof_ports: int) -> int:
        return 2 if nof_ports <= 2 else 4

    @classmethod
    def nof_bits(cls, nof_prb: int, nof_ports: int = 2, tdd: bool = False) -> int:
        n = 1 + riv_nbits(nof_prb) + 5 + _harq_bits(tdd) + 1 + 2 + 2 + cls._tpmi_bits(nof_ports) + 1
        n += 2 if tdd else 0
        if n in Dci1A.AMBIGUOUS:
            n += 1
        return n

    def pack(self, nof_prb: int, nof_ports: int = 2, tdd: bool = False) -> np.ndarray:
        w = _BitWriter()
        w.put(int(self.distributed), 1)
        w.put(self.riv, riv_nbits(nof_prb))
        w.put(self.mcs, 5)
        w.put(self.harq_pid, _harq_bits(tdd))
        w.put(self.ndi, 1)
        w.put(self.rv, 2)
        w.put(self.tpc, 2)
        if tdd:
            w.put(self.dai, 2)
        w.put(self.tpmi, self._tpmi_bits(nof_ports))
        w.put(self.pmi_confirm, 1)
        out = w.array()
        pad = Dci1B.nof_bits(nof_prb, nof_ports, tdd) - len(out)
        if pad > 0:
            out = np.concatenate([out, np.zeros(pad, np.uint8)])
        return out

    @classmethod
    def unpack(cls, bits, nof_prb: int, nof_ports: int = 2, tdd: bool = False) -> "Dci1B":
        r = _BitReader(bits)
        dist = bool(r.get(1))
        riv = r.get(riv_nbits(nof_prb))
        mcs, harq, ndi, rv, tpc = r.get(5), r.get(_harq_bits(tdd)), r.get(1), r.get(2), r.get(2)
        dai = r.get(2) if tdd else 0
        tpmi = r.get(cls._tpmi_bits(nof_ports))
        pmi = r.get(1)
        return cls(riv, mcs, harq, ndi, rv, tpc, tpmi, pmi, dist, dai)


@dataclasses.dataclass
class Dci1D:
    """DCI format 1D (single-layer MU-MIMO, TM5; TS 36.212 §5.3.3.1.4A,
    dci.c format1D).  As 1B but the confirmation bit is replaced by a
    downlink power-offset flag (δ_power-offset selector)."""

    riv: int = 0
    mcs: int = 0
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    tpc: int = 0
    tpmi: int = 0
    power_offset: int = 0
    distributed: bool = False
    dai: int = 0  # TDD only

    @classmethod
    def nof_bits(cls, nof_prb: int, nof_ports: int = 2, tdd: bool = False) -> int:
        return Dci1B.nof_bits(nof_prb, nof_ports, tdd)

    def pack(self, nof_prb: int, nof_ports: int = 2, tdd: bool = False) -> np.ndarray:
        w = _BitWriter()
        w.put(int(self.distributed), 1)
        w.put(self.riv, riv_nbits(nof_prb))
        w.put(self.mcs, 5)
        w.put(self.harq_pid, _harq_bits(tdd))
        w.put(self.ndi, 1)
        w.put(self.rv, 2)
        w.put(self.tpc, 2)
        if tdd:
            w.put(self.dai, 2)
        w.put(self.tpmi, Dci1B._tpmi_bits(nof_ports))
        w.put(self.power_offset, 1)
        out = w.array()
        pad = Dci1D.nof_bits(nof_prb, nof_ports, tdd) - len(out)
        if pad > 0:
            out = np.concatenate([out, np.zeros(pad, np.uint8)])
        return out

    @classmethod
    def unpack(cls, bits, nof_prb: int, nof_ports: int = 2, tdd: bool = False) -> "Dci1D":
        r = _BitReader(bits)
        dist = bool(r.get(1))
        riv = r.get(riv_nbits(nof_prb))
        mcs, harq, ndi, rv, tpc = r.get(5), r.get(_harq_bits(tdd)), r.get(1), r.get(2), r.get(2)
        dai = r.get(2) if tdd else 0
        tpmi = r.get(Dci1B._tpmi_bits(nof_ports))
        po = r.get(1)
        return cls(riv, mcs, harq, ndi, rv, tpc, tpmi, po, dist, dai)


def _rbg_size(nof_prb: int) -> int:
    """Resource-block-group size P (TS 36.213 Table 7.1.6.1-1)."""
    if nof_prb <= 10:
        return 1
    if nof_prb <= 26:
        return 2
    if nof_prb <= 63:
        return 3
    return 4


@dataclasses.dataclass
class Dci1:
    """DCI format 1 (DL scheduling, resource allocation type 0 RBG bitmap;
    TS 36.212 §5.3.3.1.2, dci.c format1)."""

    rbg_bitmap: int = 0  # MSB = RBG 0
    mcs: int = 0
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    tpc: int = 0
    dai: int = 0  # TDD only

    @staticmethod
    def nof_rbg(nof_prb: int) -> int:
        p = _rbg_size(nof_prb)
        return (nof_prb + p - 1) // p

    @classmethod
    def nof_bits(cls, nof_prb: int, tdd: bool = False) -> int:
        """Payload size, padded by one bit if it would collide with the
        format-0/1A size (TS 36.212 §5.3.3.1.2; dci.c format1 sizeof) —
        blind search must be able to tell the formats apart by length."""
        n = 1 + cls.nof_rbg(nof_prb) + 5 + _harq_bits(tdd) + 1 + 2 + 2
        n += 2 if tdd else 0
        if n == Dci1A.nof_bits(nof_prb, tdd):
            n += 1
        return n

    def pack(self, nof_prb: int, tdd: bool = False) -> np.ndarray:
        w = _BitWriter()
        w.put(0, 1)  # RA header: type 0
        w.put(self.rbg_bitmap, self.nof_rbg(nof_prb))
        w.put(self.mcs, 5)
        w.put(self.harq_pid, _harq_bits(tdd))
        w.put(self.ndi, 1)
        w.put(self.rv, 2)
        w.put(self.tpc, 2)
        if tdd:
            w.put(self.dai, 2)
        while len(w.bits) < self.nof_bits(nof_prb, tdd):
            w.put(0, 1)
        return w.array()

    @classmethod
    def unpack(cls, bits, nof_prb: int, tdd: bool = False) -> "Dci1":
        r = _BitReader(bits)
        if r.get(1) != 0:
            raise ValueError("RA type 1 not supported")
        bitmap = r.get(cls.nof_rbg(nof_prb))
        mcs, harq, ndi, rv, tpc = r.get(5), r.get(_harq_bits(tdd)), r.get(1), r.get(2), r.get(2)
        dai = r.get(2) if tdd else 0
        return cls(bitmap, mcs, harq, ndi, rv, tpc, dai)

    def prb_list(self, nof_prb: int) -> tuple[int, ...]:
        p = _rbg_size(nof_prb)
        n = self.nof_rbg(nof_prb)
        out = []
        for g in range(n):
            if (self.rbg_bitmap >> (n - 1 - g)) & 1:
                out += list(range(g * p, min((g + 1) * p, nof_prb)))
        return tuple(out)

    @staticmethod
    def bitmap_for_prbs(prbs, nof_prb: int) -> int:
        p = _rbg_size(nof_prb)
        n = Dci1.nof_rbg(nof_prb)
        bm = 0
        for g in range(n):
            if any(g * p <= b < (g + 1) * p for b in prbs):
                bm |= 1 << (n - 1 - g)
        return bm


@dataclasses.dataclass
class Dci1C:
    """DCI format 1C (very compact: RAR/SI/paging; TS 36.212 §5.3.3.1.4).

    Distributed VRB allocation with gap 0, QPSK only, TBS index from the
    1C-specific table column."""

    riv: int = 0
    tbs_idx: int = 0  # i_TBS 0..31 (Table 7.1.7.2.3-1 column)

    @staticmethod
    def nof_bits(nof_prb: int) -> int:
        n_dvrb = nof_prb  # gap-0 N_vrb ≈ nof_prb (step-size 1 at <50 PRB)
        return int(math.ceil(math.log2(n_dvrb * (n_dvrb + 1) / 2))) + 5

    def pack(self, nof_prb: int) -> np.ndarray:
        w = _BitWriter()
        w.put(self.riv, Dci1C.nof_bits(nof_prb) - 5)
        w.put(self.tbs_idx, 5)
        return w.array()

    @classmethod
    def unpack(cls, bits, nof_prb: int) -> "Dci1C":
        r = _BitReader(bits)
        riv = r.get(cls.nof_bits(nof_prb) - 5)
        return cls(riv, r.get(5))


@dataclasses.dataclass
class Dci2:
    """DCI formats 2/2A/2B (TS 36.212 §5.3.3.1.5/.5A/.5B; dci.c
    dci_format2AB_pack/unpack, sizes dci_format2{,A,B}_sizeof).

    2 = closed-loop spatial multiplexing (TM4), precoding info 3/6 bits
    for 2/4 ports; 2A = open-loop (TM3), 0/2 bits; 2B = dual-layer
    beamforming (TM8), no precoding info and the swap bit carries the
    scrambling identity (sram_id, dci.c:1114).  RA type 0 only (the
    header bit exists when nof_prb > 10); FDD, no CIF; payload padded
    past the TS 36.212 §5.3.3.1.2 ambiguous sizes like the reference."""

    rbg_bitmap: int = 0
    tpc: int = 0
    harq_pid: int = 0
    swap_flag: int = 0  # format 2B: scrambling identity n_SCID
    mcs1: int = 0
    ndi1: int = 0
    rv1: int = 0
    mcs2: int = 0
    ndi2: int = 0
    rv2: int = 0
    precoding_info: int = 0  # formats 2 and 2A (4 ports) only
    fmt: str = "2"  # "2" | "2a" | "2b"
    dai: int = 0  # TDD only

    _AMBIGUOUS = frozenset({12, 14, 16, 20, 24, 26, 32, 40, 44, 56})

    @property
    def is_2a(self) -> bool:
        return self.fmt == "2a"

    @staticmethod
    def _pinfo_bits(fmt: str, nof_ports: int) -> int:
        if fmt == "2":
            return 3 if nof_ports <= 2 else 6  # precoding_bits_f2
        if fmt == "2a":
            return 0 if nof_ports <= 2 else 2  # precoding_bits_f2a
        return 0  # 2B: none

    @classmethod
    def nof_bits(cls, nof_prb: int, fmt: str = "2", nof_ports: int = 2, tdd: bool = False) -> int:
        n = Dci1.nof_rbg(nof_prb) + 2 + _harq_bits(tdd) + 1 + 2 * (5 + 1 + 2)
        n += (2 if tdd else 0) + cls._pinfo_bits(fmt, nof_ports)
        if nof_prb > 10:
            n += 1  # RA type header bit
        while n in cls._AMBIGUOUS:
            n += 1
        return n

    def pack(self, nof_prb: int, nof_ports: int = 2, tdd: bool = False) -> np.ndarray:
        w = _BitWriter()
        if nof_prb > 10:
            w.put(0, 1)  # RA type 0
        w.put(self.rbg_bitmap, Dci1.nof_rbg(nof_prb))
        w.put(self.tpc, 2)
        if tdd:
            w.put(self.dai, 2)  # DAI precedes HARQ in formats 2 (dci.c 2AB unpack)
        w.put(self.harq_pid, _harq_bits(tdd))
        w.put(self.swap_flag, 1)
        for mcs, ndi, rv in ((self.mcs1, self.ndi1, self.rv1), (self.mcs2, self.ndi2, self.rv2)):
            w.put(mcs, 5)
            w.put(ndi, 1)
            w.put(rv, 2)
        nb = self._pinfo_bits(self.fmt, nof_ports)
        if nb:
            w.put(self.precoding_info, nb)
        while len(w.bits) < self.nof_bits(nof_prb, self.fmt, nof_ports, tdd):
            w.put(0, 1)
        return w.array()

    @classmethod
    def unpack(cls, bits, nof_prb: int, is_2a: bool = False, fmt: str | None = None,
               nof_ports: int = 2, tdd: bool = False) -> "Dci2":
        if fmt is None:
            fmt = "2a" if is_2a else "2"
        r = _BitReader(bits)
        if nof_prb > 10 and r.get(1) != 0:
            raise ValueError("RA type 1 not supported")
        bitmap = r.get(Dci1.nof_rbg(nof_prb))
        tpc = r.get(2)
        dai = r.get(2) if tdd else 0
        harq = r.get(_harq_bits(tdd))
        swap = r.get(1)
        mcs1, ndi1, rv1 = r.get(5), r.get(1), r.get(2)
        mcs2, ndi2, rv2 = r.get(5), r.get(1), r.get(2)
        nb = cls._pinfo_bits(fmt, nof_ports)
        pinfo = r.get(nb) if nb else 0
        return cls(bitmap, tpc, harq, swap, mcs1, ndi1, rv1, mcs2, ndi2, rv2, pinfo, fmt, dai)
