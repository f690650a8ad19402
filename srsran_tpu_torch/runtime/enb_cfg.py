"""Host copy of `srsran_tpu/runtime/enb_cfg.py`, held to it by `tests/test_torch_stack.py`.

eNB cell/SIB/DRB configuration-file plane.

The reference configures its cells from three libconfig-format files —
`rr.conf` (cell list, MAC/PHY config), `sib.conf` (SIB1/SIB2/SIB3
contents) and `drb.conf` (per-QCI bearer profiles) — parsed by
`srsenb/src/enb_cfg_parser.cc` with the examples in
`srsenb/{rr,sib,drb}.conf.example`.  This module provides the same
operator-facing plane: a small libconfig parser (`parse_libconfig`) and
`make_enb`, which builds a configured `apps.full_stack.EnbStack` whose
broadcast SIBs are generated from the files (and therefore round-trip
through the TS 36.331 ASN.1 codec — the config plane feeds the real
wire encoder, not a parallel bookkeeping structure).

`make_enb` builds the port's `EnbStack` and takes its `device=`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any


# ----------------------------------------------------------- libconfig
# value model: group -> dict, list -> list, array -> list, scalars ->
# int/float/bool/str (hex ints supported, as in cell_id = 0x01)

_TOKEN = re.compile(r"""
    (?P<ws>\s+|//[^\n]*|\#[^\n]*|/\*.*?\*/)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<hex>0x[0-9a-fA-F]+)
  | (?P<float>-?\d+\.\d*(?:[eE][+-]?\d+)?|-?\.\d+)
  | (?P<int>-?\d+(?![\w.]))
  | (?P<name>[A-Za-z_][A-Za-z0-9_\-]*)
  | (?P<punct>[={};()\[\],:])
""", re.X | re.S)


def _tokenize(text: str):
    pos = 0
    out = []
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"libconfig: bad syntax at {text[pos:pos+30]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        out.append((m.lastgroup, m.group(0)))
    return out


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, val):
        kind, tok = self.next()
        if tok != val:
            raise ValueError(f"libconfig: expected {val!r}, got {tok!r}")

    def settings(self, end=None) -> dict:
        out: dict[str, Any] = {}
        while True:
            kind, tok = self.peek()
            if kind is None or tok == end:
                return out
            if tok in (";", ","):
                self.next()
                continue
            if kind != "name":
                raise ValueError(f"libconfig: expected a setting name, got {tok!r}")
            self.next()
            k2, t2 = self.peek()
            if t2 in ("=", ":"):
                self.next()
            out[tok] = self.value()

    def value(self):
        kind, tok = self.peek()
        if tok == "{":
            self.next()
            v = self.settings(end="}")
            self.expect("}")
            return v
        if tok == "(":
            self.next()
            items = []
            while self.peek()[1] != ")":
                if self.peek()[1] == ",":
                    self.next()
                    continue
                items.append(self.value())
            self.expect(")")
            return items
        if tok == "[":
            self.next()
            items = []
            while self.peek()[1] != "]":
                if self.peek()[1] == ",":
                    self.next()
                    continue
                items.append(self.value())
            self.expect("]")
            return items
        self.next()
        if kind == "string":
            return tok[1:-1].encode().decode("unicode_escape")
        if kind == "hex":
            return int(tok, 16)
        if kind == "int":
            return int(tok)
        if kind == "float":
            return float(tok)
        if kind == "name":
            if tok in ("true", "True", "TRUE"):
                return True
            if tok in ("false", "False", "FALSE"):
                return False
            return tok
        raise ValueError(f"libconfig: unexpected token {tok!r}")


def parse_libconfig(text: str) -> dict:
    """Parse libconfig-syntax text (the rr/sib/drb.conf format) into
    plain Python data: groups → dicts, lists/arrays → lists."""
    return _Parser(_tokenize(text)).settings()


def parse_libconfig_file(path: str) -> dict:
    with open(path) as f:
        return parse_libconfig(f.read())


# ------------------------------------------------------------ builders


@dataclasses.dataclass
class EnbConfig:
    """Parsed operator configuration (rr/sib/drb.conf contents)."""

    rr: dict
    sib: dict
    drb: dict

    @classmethod
    def load(cls, rr_path: str, sib_path: str, drb_path: str | None = None):
        return cls(
            rr=parse_libconfig_file(rr_path),
            sib=parse_libconfig_file(sib_path),
            drb=parse_libconfig_file(drb_path) if drb_path else {},
        )

    # -- convenient views --
    @property
    def cells(self) -> list[dict]:
        return self.rr.get("cell_list", [])

    def qci_config(self, qci: int) -> dict | None:
        for q in self.drb.get("qci_config", []):
            if q.get("qci") == qci:
                return q
        return None


def _sib2_kwargs(sib: dict) -> dict:
    """sib.conf sib2 → `stack.rrc.pack_sib2` keyword arguments."""
    out: dict[str, Any] = {}
    s2 = sib.get("sib2", {})
    rr = s2.get("rr_config_common_sib", {})
    rach = rr.get("rach_cnfg", {})
    if "num_ra_preambles" in rach:
        out["nof_ra_preambles"] = rach["num_ra_preambles"]
    prach = rr.get("prach_cnfg", {})
    if "root_sequence_index" in prach:
        out["root_seq_idx"] = prach["root_sequence_index"]
    info = prach.get("prach_cnfg_info", {})
    if "prach_config_index" in info:
        out["prach_config_index"] = info["prach_config_index"]
    if "zero_correlation_zone_config" in info:
        out["zero_corr_zone"] = info["zero_correlation_zone_config"]
    if "prach_freq_offset" in info:
        out["prach_freq_offset"] = info["prach_freq_offset"]
    ue_t = s2.get("ue_timers_and_constants", {})
    if "n310" in ue_t:
        out["n310"] = ue_t["n310"]
    if "t310" in ue_t:
        out["t310_ms"] = ue_t["t310"]
    return out


def make_enb(cfg: EnbConfig, mme, spgw, nof_prb: int = 25,
             nof_ports: int = 1, cell_index: int = 0, mcs: int = 5,
             *, device=None, **stack_kwargs):
    """Boot an `EnbStack` from the operator configuration: cell identity
    from rr.conf's cell_list entry, broadcast SIB1/SIB2(+SIB3) generated
    from sib.conf through the ASN.1 codec, PRACH configuration applied
    to the detector, and S1 handover neighbours from meas_cell_list
    (`enb_cfg_parser.cc` roles; bandwidth comes from the main enb.conf
    [enb] section in the reference, passed here as `nof_prb`).  The stack
    runs on `device` (None: the card; raises where there is none)."""
    from ..apps.full_stack import EnbStack
    from ..phy.common import Cell
    from ..phy.phch.prach import PrachConfig
    from ..stack import rrc

    cell_cfg = cfg.cells[cell_index]
    cell = Cell(nof_prb=nof_prb, nof_ports=nof_ports,
                id=cell_cfg.get("pci", 1))
    enb = EnbStack(cell, mme, spgw, mcs=mcs,
                   enb_id=cell_cfg.get("cell_id", 0x19B),
                   earfcn=cell_cfg.get("dl_earfcn", 3400),
                   device=device, **stack_kwargs)

    # --- SIB1 from sib.conf sib1 + rr.conf cell identity ---
    s1 = cfg.sib.get("sib1", {})
    si_per = 8
    sched = s1.get("sched_info", [])
    if sched:
        si_per = sched[0].get("si_periodicity", 8)
    enb._sib1 = rrc.pack_sib1(
        cell_id=(enb.enb_id << 8) | (cell.id & 0xFF),
        tac=cell_cfg.get("tac", 1),
        si_periodicity=f"rf{si_per}",
    )

    # --- SIB2 (+SIB3 when mapped) from sib.conf ---
    kw = _sib2_kwargs(cfg.sib)
    sib3 = None
    mapped = sched[0].get("si_mapping_info", []) if sched else []
    if 3 in mapped and "sib3" in cfg.sib:
        s3 = cfg.sib["sib3"]
        intra = s3.get("intra_freq_cell_reselection", s3)
        sib3 = rrc.make_sib3(
            q_hyst_db=int(str(s3.get("cell_reselection_common", {})
                              .get("q_hyst", 4)).removeprefix("db")),
            q_rx_lev_min=intra.get("q_rx_lev_min", -65),
            t_resel_eutra=intra.get("t_resel_eutra", 0),
        )
    enb._sib2 = rrc.pack_sib2(sib3=sib3, **kw)

    # --- PRACH detector configuration follows the broadcast ---
    enb.prach_cfg = PrachConfig(
        root_seq_index=kw.get("root_seq_idx", 0),
        zero_corr_zone=kw.get("zero_corr_zone", 1),
        freq_offset=kw.get("prach_freq_offset", 0),
        nof_preambles=kw.get("nof_ra_preambles", 64),
    )

    # --- S1 handover neighbours (rr.conf meas_cell_list → nbr map) ---
    for n in cell_cfg.get("meas_cell_list", []):
        if "eci" in n and "pci" in n:
            enb.s1_neighbors[n["pci"]] = n["eci"] >> 8

    return enb
