"""Host copy of `srsran_tpu/apps/nr_stack.py`, held to it by `tests/test_torch_stack.py`.

NR "coreless" scaffolding stacks — the framework analog of the
reference's `srsenb/src/stack/gnb_stack_nr.cc`, `srsue/src/stack/
ue_stack_nr.cc`, `srsenb/src/stack/rrc/rrc_nr.cc` and
`srsenb/src/stack/mac/mac_nr.cc`.

The reference ships NO NR PHY: its NR mode is a stack-only scaffold in
which a gNB stack and a UE stack exchange MAC PDUs through the VNF/PNF
split-PHY UDP protocol (`lib/src/common/basic_vnf.cc`), with one
hard-wired UE (`coreless.rnti`) and one default DRB (`coreless.drb_lcid`,
`gnb_stack_nr.cc:79-100`) carrying IP with ciphering disabled
(`rrc_nr.cc:362-369` RRCSetup pdcp-Config [[cipheringDisabled]]).

This module matches that scope — and completes the signalling loop the
reference leaves as TODOs (`rrc_nr.cc:316-325` parse_ul_ccch/dcch are
commented out): a real TS 38.331 UPER exchange on SRB0/SRB1
(RRCSetupRequest → RRCSetup → RRCSetupComplete, DL/UL InformationTransfer,
RRCRelease), SRB1 on NR RLC AM + 12-bit-SN PDCP, the DRB on NR RLC UM
(6-bit SN, `rrc_nr.cc:68` default_rlc_um_nr_config(6)) + 18-bit-SN PDCP,
all multiplexed into TS 38.321 MAC subPDUs and carried across the wire
format of the VNF/PNF messages (SF_IND / TX_REQUEST / RX_DATA_IND).
"""

from __future__ import annotations

from collections import deque

from ..stack import mac_nr, vnf
from ..stack.asn1 import rrc_nr
from ..stack.pdcp_nr import PdcpEntityNr, PdcpNrConfig
from ..stack.rlc_nr import RlcAmNr, RlcUmNr

SRB0_LCID = 0  # CCCH
SRB1_LCID = 1
DRB_LCID = 4  # reference default coreless.drb_lcid (enb.cc stack args)
RNTI = 0x4601  # reference default coreless.rnti

MIB_PERIOD = 8  # TTIs between MIB broadcasts (80 ms field cadence / 10)
SIB1_PERIOD = 16


def _default_mib() -> dict:
    """Field choices of rrc_nr.cc:118-141 update_default_cfg."""
    return {
        "message": ("mib", {
            "sys_frame_num": 0,
            "sub_carrier_spacing_common": "scs15or60",
            "ssb_subcarrier_offset": 0,
            "dmrs_type_a_position": "pos2",
            "pdcch_cfg_sib1": {"ctrl_res_set_zero": 0, "search_space_zero": 0},
            "cell_barred": "not_barred",
            "intra_freq_resel": "allowed",
            "spare": 0,
        })
    }


def _default_sib1(cell_id: int = 0x0001) -> dict:
    """rrc_nr.cc:142-166 default SIB1 subset."""
    return {
        "message": ("c1", ("sib_type1", {
            "cell_sel_info": {"q_rx_lev_min": -70, "q_qual_min": -20},
            "cell_access_related_info": {
                "plmn_id_list": [{
                    "plmn_id_list": [{"mcc": [0, 0, 1], "mnc": [0, 1]}],
                    "tac": 0x000001,
                    "cell_id": cell_id,
                    "cell_reserved_for_oper": "not_reserved",
                }],
            },
            "si_sched_info": {
                "sched_info_list": [{
                    "si_broadcast_status": "broadcasting",
                    "si_periodicity": "rf16",
                    "sib_map_info": [{"type": "sib_type2"}],
                }],
                "si_win_len": "s20",
            },
        }))
    }


class _Bearers:
    """SRB1 (RLC AM + PDCP SRB) and DRB (RLC UM 6-bit + PDCP 18-bit)."""

    def __init__(self, is_gnb: bool):
        d = 1 if is_gnb else 0
        self.srb1_rlc = RlcAmNr(sn_bits=12)
        self.srb1_pdcp = PdcpEntityNr(PdcpNrConfig(is_srb=True, bearer_id=1, direction_tx=d))
        self.drb_rlc = RlcUmNr(sn_bits=6)
        # cipheringDisabled + no SecurityModeCommand in the reference's
        # coreless mode -> NEA0/NIA0 on the DRB
        self.drb_pdcp = PdcpEntityNr(
            PdcpNrConfig(is_srb=False, sn_bits=18, bearer_id=DRB_LCID, direction_tx=d)
        )


class GnbStackNr:
    """gnb_stack_nr.cc role: MIB/SIB1 broadcast, RRC setup, one DRB."""

    def __init__(self, cell_id: int = 1):
        self.mib_bytes = rrc_nr.pack("bcch_bch", _default_mib())
        self.sib1_bytes = rrc_nr.pack("bcch_dl_sch", _default_sib1(cell_id))
        self.bearers = _Bearers(is_gnb=True)
        self.srb0_tx: deque[bytes] = deque()  # packed DL-CCCH PDUs
        self.connected = False
        self.transaction_id = 0
        self.rx_nas: list[bytes] = []  # ded NAS from setup-complete / UL transfers
        self.rx_drb: list[bytes] = []  # the gw.write role (gnb_stack_nr.cc:187)
        self.released = False

    # ---- user-plane / signalling ingress ------------------------------
    def write_drb(self, sdu: bytes):
        self.bearers.drb_rlc.write_sdu(self.bearers.drb_pdcp.write_sdu(sdu))

    def write_nas(self, nas: bytes):
        msg = {"message": ("c1", ("dl_info_transfer", {
            "rrc_transaction_id": self.transaction_id % 4,
            "crit_exts": ("dl_info_transfer", {"ded_nas_msg": nas}),
        }))}
        self.transaction_id += 1
        self._send_srb1(rrc_nr.pack("dl_dcch", msg))

    def send_release(self):
        msg = {"message": ("c1", ("rrc_release", {
            "rrc_transaction_id": self.transaction_id % 4,
            "crit_exts": ("rrc_release", {}),
        }))}
        self.transaction_id += 1
        self._send_srb1(rrc_nr.pack("dl_dcch", msg))

    def _send_srb1(self, pdu: bytes):
        self.bearers.srb1_rlc.write_sdu(self.bearers.srb1_pdcp.write_sdu(pdu))

    # ---- MAC boundary --------------------------------------------------
    def bcch_pdus(self, tti: int) -> list[tuple[int, bytes]]:
        """(index, pdu) broadcast list for the TX_REQUEST of this TTI."""
        out = []
        if tti % MIB_PERIOD == 0:
            out.append((vnf_index_bch(), self.mib_bytes))
        if tti % SIB1_PERIOD == 1:
            out.append((vnf_index_sib(), self.sib1_bytes))
        return out

    def get_dl_tb(self, tb_size: int = 512) -> bytes | None:
        subpdus: list[tuple[int, bytes]] = []
        room = tb_size
        while self.srb0_tx and room > len(self.srb0_tx[0]) + 3:
            pdu = self.srb0_tx.popleft()
            subpdus.append((SRB0_LCID, pdu))
            room -= len(pdu) + 2
        pdu = self.bearers.srb1_rlc.read_pdu(max(0, room - 3))
        if pdu is not None:
            subpdus.append((SRB1_LCID, pdu))
            room -= len(pdu) + 3
        pdu = self.bearers.drb_rlc.read_pdu(max(0, room - 3))
        if pdu is not None:
            subpdus.append((DRB_LCID, pdu))
        if not subpdus:
            return None
        return mac_nr.mac_nr_pack(subpdus, tb_size, is_ul=False)

    def put_ul_tb(self, tb: bytes):
        for lcid, payload in mac_nr.mac_nr_unpack(tb, is_ul=True):
            if lcid == SRB0_LCID:
                self._handle_ul_ccch(payload)
            elif lcid == SRB1_LCID:
                self.bearers.srb1_rlc.write_pdu(payload)
            elif lcid == DRB_LCID:
                self.bearers.drb_rlc.write_pdu(payload)
        while (sdu := self.bearers.srb1_rlc.read_sdu()) is not None:
            for rrc_pdu in self.bearers.srb1_pdcp.write_pdu(sdu):
                self._handle_ul_dcch(rrc_pdu)
        while (sdu := self.bearers.drb_rlc.read_sdu()) is not None:
            self.rx_drb.extend(self.bearers.drb_pdcp.write_pdu(sdu))

    # ---- RRC (rrc_nr.cc ue::send_connection_setup, completed) ---------
    def _handle_ul_ccch(self, payload: bytes):
        msg = rrc_nr.unpack("ul_ccch", payload)
        _, (kind, _req) = msg["message"]
        if kind != "rrc_setup_request" or self.connected:
            return
        setup = {"message": ("c1", ("rrc_setup", {
            "rrc_transaction_id": self.transaction_id % 4,
            "crit_exts": ("rrc_setup", {
                "radio_bearer_cfg": {
                    "srb_to_add_mod_list": [{"srb_id": 1}],
                    "drb_to_add_mod_list": [{
                        "drb_id": 1,
                        "pdcp_cfg": {
                            "drb": {
                                "pdcp_sn_size_ul": "len18bits",
                                "pdcp_sn_size_dl": "len18bits",
                                "hdr_compress": ("not_used", None),
                            },
                            "ciphering_disabled": "true",
                        },
                    }],
                },
                "master_cell_group": b"",
            }),
        }))}
        self.transaction_id += 1
        self.srb0_tx.append(rrc_nr.pack("dl_ccch", setup))

    def _handle_ul_dcch(self, pdu: bytes):
        msg = rrc_nr.unpack("ul_dcch", pdu)
        _, (kind, body) = msg["message"]
        if kind == "rrc_setup_complete":
            self.connected = True
            _, ies = body["crit_exts"]
            self.rx_nas.append(ies["ded_nas_msg"])
        elif kind == "ul_info_transfer":
            _, ies = body["crit_exts"]
            if "ded_nas_msg" in ies:
                self.rx_nas.append(ies["ded_nas_msg"])


class UeStackNr:
    """ue_stack_nr.cc + srsue rrc_nr.cc role."""

    def __init__(self, ue_id: int = 0x2A2A2A2A2A & ((1 << 39) - 1)):
        self.ue_id = ue_id
        self.mib: dict | None = None
        self.sib1: dict | None = None
        self.bearers: _Bearers | None = None
        self.srb0_tx: deque[bytes] = deque()
        self.setup_requested = False
        self.connected = False
        self.released = False
        self.rx_nas: list[bytes] = []
        self.rx_drb: list[bytes] = []
        self._pending_nas: deque[bytes] = deque()
        self._pending_drb: deque[bytes] = deque()

    def write_drb(self, sdu: bytes):
        if self.bearers is None:
            self._pending_drb.append(sdu)
        else:
            self.bearers.drb_rlc.write_sdu(self.bearers.drb_pdcp.write_sdu(sdu))

    def write_nas(self, nas: bytes):
        if not self.connected:
            self._pending_nas.append(nas)
        else:
            self._send_ul_info(nas)

    def _send_ul_info(self, nas: bytes):
        msg = {"message": ("c1", ("ul_info_transfer", {
            "crit_exts": ("ul_info_transfer", {"ded_nas_msg": nas}),
        }))}
        self._send_srb1(rrc_nr.pack("ul_dcch", msg))

    def _send_srb1(self, pdu: bytes):
        assert self.bearers is not None
        self.bearers.srb1_rlc.write_sdu(self.bearers.srb1_pdcp.write_sdu(pdu))

    # ---- broadcast reception -------------------------------------------
    def put_bcch(self, index: int, pdu: bytes):
        if index == vnf_index_bch():
            self.mib = rrc_nr.unpack("bcch_bch", pdu)
        elif index == vnf_index_sib():
            self.sib1 = rrc_nr.unpack("bcch_dl_sch", pdu)
        if self.mib and self.sib1 and not self.setup_requested:
            req = {"message": ("c1", ("rrc_setup_request", {"rrc_setup_request": {
                "ue_id": ("random_value", self.ue_id),
                "establishment_cause": "mo_data",
                "spare": 0,
            }}))}
            self.srb0_tx.append(rrc_nr.pack("ul_ccch", req))
            self.setup_requested = True

    # ---- MAC boundary ----------------------------------------------------
    def get_ul_tb(self, tb_size: int = 256) -> bytes | None:
        subpdus: list[tuple[int, bytes]] = []
        room = tb_size
        while self.srb0_tx:
            pdu = self.srb0_tx.popleft()
            subpdus.append((SRB0_LCID, pdu))  # UL-CCCH: fixed 48-bit, no L
            room -= len(pdu) + 1
        if self.bearers is not None:
            pdu = self.bearers.srb1_rlc.read_pdu(max(0, room - 3))
            if pdu is not None:
                subpdus.append((SRB1_LCID, pdu))
                room -= len(pdu) + 3
            pdu = self.bearers.drb_rlc.read_pdu(max(0, room - 3))
            if pdu is not None:
                subpdus.append((DRB_LCID, pdu))
        if not subpdus:
            return None
        return mac_nr.mac_nr_pack(subpdus, tb_size)

    def put_dl_tb(self, tb: bytes):
        for lcid, payload in mac_nr.mac_nr_unpack(tb, is_ul=False):
            if lcid == SRB0_LCID:
                self._handle_dl_ccch(payload)
            elif lcid == SRB1_LCID and self.bearers is not None:
                self.bearers.srb1_rlc.write_pdu(payload)
            elif lcid == DRB_LCID and self.bearers is not None:
                self.bearers.drb_rlc.write_pdu(payload)
        if self.bearers is None:
            return
        while (sdu := self.bearers.srb1_rlc.read_sdu()) is not None:
            for rrc_pdu in self.bearers.srb1_pdcp.write_pdu(sdu):
                self._handle_dl_dcch(rrc_pdu)
        while (sdu := self.bearers.drb_rlc.read_sdu()) is not None:
            self.rx_drb.extend(self.bearers.drb_pdcp.write_pdu(sdu))

    # ---- RRC --------------------------------------------------------------
    def _handle_dl_ccch(self, payload: bytes):
        msg = rrc_nr.unpack("dl_ccch", payload)
        _, (kind, body) = msg["message"]
        if kind != "rrc_setup" or self.bearers is not None:
            return
        _, ies = body["crit_exts"]
        rb = ies["radio_bearer_cfg"]
        drb = rb["drb_to_add_mod_list"][0]
        pc = drb.get("pdcp_cfg", {})
        sn = 18 if pc.get("drb", {}).get("pdcp_sn_size_dl") == "len18bits" else 12
        self.bearers = _Bearers(is_gnb=False)
        self.bearers.drb_pdcp.cfg.sn_bits = sn
        self.bearers.drb_pdcp.mod = 1 << sn
        self.bearers.drb_pdcp.window = 1 << (sn - 1)
        complete = {"message": ("c1", ("rrc_setup_complete", {
            "rrc_transaction_id": body["rrc_transaction_id"],
            "crit_exts": ("rrc_setup_complete", {
                "sel_plmn_id": 1,
                "ded_nas_msg": self._pending_nas.popleft() if self._pending_nas else b"\x7e\x00\x41",
            }),
        }))}
        self.connected = True
        self._send_srb1(rrc_nr.pack("ul_dcch", complete))
        while self._pending_nas:
            self._send_ul_info(self._pending_nas.popleft())
        while self._pending_drb:
            self.write_drb(self._pending_drb.popleft())

    def _handle_dl_dcch(self, pdu: bytes):
        msg = rrc_nr.unpack("dl_dcch", pdu)
        _, (kind, body) = msg["message"]
        if kind == "dl_info_transfer":
            _, ies = body["crit_exts"]
            if "ded_nas_msg" in ies:
                self.rx_nas.append(ies["ded_nas_msg"])
        elif kind == "rrc_release":
            self.released = True
            self.connected = False


# PDU index markers inside TX_REQUEST (basic_vnf_api.h tagged its PDUs
# with a type; here index 0/1 = BCH/SIB broadcast, 2 = DL-SCH data)
def vnf_index_bch() -> int:
    return 0


def vnf_index_sib() -> int:
    return 1


VNF_INDEX_DLSCH = 2


class NrAirLink:
    """Cross-connects the two stacks through the VNF/PNF wire protocol:
    every TB crosses as a packed TX_REQUEST and arrives as a packed
    RX_DATA_IND, exercising basic_vnf_api.h's message formats."""

    def __init__(self, gnb: GnbStackNr, ue: UeStackNr,
                 dl_tb_size: int = 512, ul_tb_size: int = 256):
        self.gnb, self.ue = gnb, ue
        self.dl_tb_size, self.ul_tb_size = dl_tb_size, ul_tb_size
        self.tti = 0

    def step(self):
        tti = self.tti
        self.tti += 1
        # DL: gNB VNF packs a TX_REQUEST answering the PNF's SF_IND
        _, sf = vnf.unpack(vnf.pack_sf_ind(t1=tti * 1000, tti=tti))
        assert sf["tti"] == tti
        pdus = list(self.gnb.bcch_pdus(tti))
        tb = self.gnb.get_dl_tb(self.dl_tb_size)
        if tb is not None:
            pdus.append((VNF_INDEX_DLSCH, tb))
        if pdus:
            _, m = vnf.unpack(vnf.pack_tx_request(tti, pdus))
            for index, pdu in m["pdus"]:
                if index == VNF_INDEX_DLSCH:
                    self.ue.put_dl_tb(pdu)
                else:
                    self.ue.put_bcch(index, pdu)
        # UL: UE TB crosses as the PNF's RX_DATA_IND toward the gNB VNF
        tb = self.ue.get_ul_tb(self.ul_tb_size)
        if tb is not None:
            _, m = vnf.unpack(vnf.pack_rx_data_ind(t1=tti * 1000, tti=tti, pdus=[tb]))
            for pdu in m["pdus"]:
                self.gnb.put_ul_tb(pdu)

    def run(self, n: int):
        for _ in range(n):
            self.step()
