"""Resource-element-group (REG) mapping for the control region, TS 36.211
§6.2.4/§6.7/§6.8.5/§6.9 — host side.

Copy of `srsran_tpu/phy/phch/regs.py`: per cell (and CFI) the physical RE
indices of the PCFICH's 4 quadruplets (symbol 0, cell-ID anchored), the
PHICH groups (3 REGs each, cell-ID spread) and the PDCCH's CCE-ordered
quadruplet sequence after the 32-column sub-block interleaver and the
cell-ID cyclic shift.  Master REG order is PRB-major, then REG slot, then
symbol.  Both cyclic prefixes and both PHICH durations: extended CP doubles
the PHICH group count (two groups per mapping unit, NSF 2), extended PHICH
duration spreads a group's three REGs over symbols 0-2.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..common import Cell

NRE = 12
PDCCH_NCOLS = 32
PDCCH_PERM = [
    1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
    0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
]  # TS 36.212 §5.1.4.2.1 column permutation


def _regs_per_symbol(l: int, nof_ports: int, nsymb_slot: int = 7) -> int:
    """REGs in control symbol l: 2 where CRS lives (l=0; l=1 with 4
    ports; l = nsymb-3, which falls inside a 4-symbol control region for
    extended CP), else 3."""
    if l == 0:
        return 2
    if l == 1:
        return 2 if nof_ports == 4 else 3
    if l == nsymb_slot - 3:
        return 2
    return 3


def _reg_res(l: int, slot_j: int, prb: int, nregs: int, vo: int) -> tuple[int, ...]:
    """The 4 subcarriers of REG (l, j) in `prb` (TS 36.211 §6.2.4)."""
    k0 = prb * NRE
    if nregs == 2:  # CRS symbol: 6 REs minus pilots at vo, vo+3
        base = k0 + slot_j * 6
        ks = [base + i for i in range(6) if i != vo and i != vo + 3]
    else:
        ks = [k0 + slot_j * 4 + i for i in range(4)]
    return tuple(ks)


@lru_cache(maxsize=64)
def build_regs(cell: Cell):
    """Returns dict with master REG list + per-channel assignments."""
    nof_prb, ports = cell.nof_prb, cell.nof_ports
    vo = cell.id % 3
    max_ctrl = 4 if nof_prb <= 10 else 3
    n = [_regs_per_symbol(l, ports, cell.nsymb_per_slot)
         for l in range(max_ctrl)]

    # master order: prb-major, REG slot (jmax), then symbol
    regs: list[dict] = []
    for prb in range(nof_prb):
        j = [0] * max_ctrl
        for jmax in range(3):
            for l in range(max_ctrl):
                if n[l] == 3 or (n[l] == 2 and jmax != 1):
                    regs.append(
                        dict(l=l, prb=prb, j=j[l], k=_reg_res(l, j[l], prb, n[l], vo), assigned=False)
                    )
                    j[l] += 1

    # PCFICH: 4 REGs in symbol 0 (§6.7.4)
    k_hat = (NRE // 2) * (cell.id % (2 * nof_prb))
    pcfich = []
    for i in range(4):
        k = (k_hat + (i * nof_prb // 2) * (NRE // 2)) % (nof_prb * NRE)
        reg = next(r for r in regs if r["l"] == 0 and r["prb"] * NRE + r["j"] * 6 == k)
        reg["assigned"] = True
        pcfich.append(reg)

    # PHICH mapping units of 3 REGs each (§6.9.3; regs.c:286-337).
    # Normal duration: all three REGs in symbol 0.  Extended duration:
    # one REG in each of symbols 0..2 (li = i).  Extended CP associates
    # TWO groups with each mapping unit (NSF 2), so the group count
    # doubles while the REG footprint per unit stays 3.
    ng = {0: 1 / 6, 1: 1 / 2, 2: 1.0, 3: 2.0}.get(cell.phich_resources, 1 / 6)
    is_ext_cp = cell.nsymb_per_slot == 6
    ext_dur = cell.phich_length == 1
    n_units = int(np.ceil(ng * nof_prb / 8))
    avail = {l: [r for r in regs if r["l"] == l and not r["assigned"]]
             for l in range(min(3, max_ctrl))}
    nl = {l: len(v) for l, v in avail.items()}
    phich: list[list[dict]] = []  # mapping units (3 REGs each)
    for mi in range(n_units):
        unit = []
        for i in range(3):
            li = i if ext_dur else 0
            navail = nl[li]
            ni = ((cell.id * navail // nl[0]) + mi + i * navail // 3) % navail
            reg = avail[li][ni]
            if reg["assigned"]:
                # collision cannot happen for valid configs; guard anyway
                ni = next(x for x in range(navail)
                          if not avail[li][x]["assigned"])
                reg = avail[li][ni]
            reg["assigned"] = True
            unit.append(reg)
        phich.append(unit)
    nof_phich_groups = 2 * n_units if is_ext_cp else n_units

    # PDCCH per CFI: interleave + cell-ID cyclic shift (§6.8.5)
    pdcch = {}
    for cfi in (1, 2, 3):
        nof_ctrl = cfi + 1 if nof_prb <= 10 else cfi
        avail = [r for r in regs if r["l"] < nof_ctrl and not r["assigned"]]
        m_total = len(avail)
        nrows = (m_total - 1) // PDCCH_NCOLS + 1
        ndummy = PDCCH_NCOLS * nrows - m_total
        out = [None] * m_total
        k = 0
        for jcol in range(PDCCH_NCOLS):
            for irow in range(nrows):
                pos = irow * PDCCH_NCOLS + PDCCH_PERM[jcol]
                if pos >= ndummy:
                    m = pos - ndummy
                    kp = (k - cell.id) % m_total
                    out[m] = avail[kp]
                    k += 1
        useful = (m_total // 9) * 9
        pdcch[cfi] = out[:useful]

    return dict(regs=regs, pcfich=pcfich, phich=phich, pdcch=pdcch,
                nof_phich_groups=nof_phich_groups)


def _flat(reg: dict, nre: int) -> np.ndarray:
    return np.asarray([reg["l"] * nre + k for k in reg["k"]], np.int32)


@lru_cache(maxsize=64)
def pcfich_re_indices_true(cell: Cell) -> np.ndarray:
    """16 flat RE indices of PCFICH in quadruplet order."""
    r = build_regs(cell)
    nre = cell.nof_re_per_symbol
    return np.concatenate([_flat(reg, nre) for reg in r["pcfich"]])


@lru_cache(maxsize=64)
def phich_group_re_indices_true(cell: Cell, group: int) -> np.ndarray:
    """Flat RE indices carrying PHICH `group`.

    Normal CP: the full 12 REs of the group's mapping unit.  Extended
    CP: two groups share a unit with spreading factor 2 — the even group
    rides subcarrier pairs (0,1) of each REG quadruplet, the odd group
    pairs (2,3) (TS 36.211 §6.9.1 ext-CP resource split)."""
    r = build_regs(cell)
    nre = cell.nof_re_per_symbol
    if cell.nsymb_per_slot == 7:
        return np.concatenate([_flat(reg, nre) for reg in r["phich"][group]])
    unit = r["phich"][group // 2]
    half = group % 2
    out = []
    for reg in unit:
        flat = _flat(reg, nre)
        out.append(flat[2 * half : 2 * half + 2])
    return np.concatenate(out)


def nof_phich_groups_true(cell: Cell) -> int:
    return build_regs(cell)["nof_phich_groups"]


@lru_cache(maxsize=64)
def pdcch_re_indices_true(cell: Cell, cfi: int) -> np.ndarray:
    """Flat RE indices of the PDCCH in CCE/quadruplet transmit order."""
    r = build_regs(cell)
    nre = cell.nof_re_per_symbol
    regs = r["pdcch"][cfi]
    if not regs:
        return np.zeros(0, np.int32)
    return np.concatenate([_flat(reg, nre) for reg in regs])
