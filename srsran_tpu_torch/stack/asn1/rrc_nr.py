"""Host copy of `srsran_tpu/stack/asn1/rrc_nr.py`, held to it by `tests/test_torch_stack.py`.

TS 38.331 NR RRC message schemas (UPER) on the per.py DSL.

Replaces the reference's generated `rrc_nr_asn1.cc` (55 kLoC — SURVEY
§2.2 / Appendix C item 3) for the messages its 5G-NR scaffolding
exchanges (srsenb/src/stack/rrc/rrc_nr.cc, srsue/src/stack/rrc/rrc_nr.cc):
MIB (BCCH-BCH), SIB1 (BCCH-DL-SCH), RRCSetupRequest (UL-CCCH),
RRCSetup/RRCReject (DL-CCCH), RRCSetupComplete / ULInformationTransfer
(UL-DCCH), DLInformationTransfer / RRCRelease (DL-DCCH).

Validated bit-exactly against golden vectors produced by the reference's
own generated codec (tests/test_asn1_rrc_nr.py documents the generator
inputs; the vectors cover every schema here).
"""

from .per import (
    BitStr,
    Choice,
    Enum,
    Int,
    M,
    Null,
    O,
    OctStr,
    Seq,
    SeqOf,
    c1_spares,
)

# ENUMERATED {true} OPTIONAL — presence flag only, zero value bits
FLAG = Enum(["true"])

# --------------------------------------------------------------- MIB / BCCH

PDCCH_CONFIG_SIB1 = Seq(
    [M("ctrl_res_set_zero", Int(0, 15)), M("search_space_zero", Int(0, 15))]
)

MIB = Seq(
    [
        M("sys_frame_num", BitStr(6)),
        M("sub_carrier_spacing_common", Enum(["scs15or60", "scs30or120"])),
        M("ssb_subcarrier_offset", Int(0, 15)),
        M("dmrs_type_a_position", Enum(["pos2", "pos3"])),
        M("pdcch_cfg_sib1", PDCCH_CONFIG_SIB1),
        M("cell_barred", Enum(["barred", "not_barred"])),
        M("intra_freq_resel", Enum(["allowed", "not_allowed"])),
        M("spare", BitStr(1)),
    ]
)

BCCH_BCH_MESSAGE = Seq(
    [M("message", Choice([("mib", MIB), ("msg_class_ext", Seq([]))]))]
)

# --------------------------------------------------------------------- SIB1

MCC = SeqOf(Int(0, 9), 3, 3)
MNC = SeqOf(Int(0, 9), 2, 3)
PLMN_IDENTITY = Seq([O("mcc", MCC), M("mnc", MNC)])

PLMN_IDENTITY_INFO = Seq(
    [
        M("plmn_id_list", SeqOf(PLMN_IDENTITY, 1, 12)),
        O("tac", BitStr(24)),
        O("ranac", Int(0, 255)),
        M("cell_id", BitStr(36)),
        M("cell_reserved_for_oper", Enum(["reserved", "not_reserved"])),
    ],
    ext=True,
)

CELL_ACCESS_RELATED_INFO = Seq(
    [
        M("plmn_id_list", SeqOf(PLMN_IDENTITY_INFO, 1, 12)),
        O("cell_reserved_for_other_use", FLAG),
    ],
    ext=True,
)

CONN_EST_FAIL_CTRL = Seq(
    [
        M("conn_est_fail_count", Enum(["n1", "n2", "n3", "n4"])),
        M("conn_est_fail_offset_validity",
          Enum(["s30", "s60", "s120", "s240", "s300", "s420", "s600", "s900"])),
        O("conn_est_fail_offset", Int(0, 15)),
    ]
)

RACH_CFG_GENERIC = Seq(
    [
        M("prach_cfg_idx", Int(0, 255)),
        M("msg1_fdm", Enum(["one", "two", "four", "eight"])),
        M("msg1_freq_start", Int(0, 274)),
        M("zero_correlation_zone_cfg", Int(0, 15)),
        M("preamb_rx_target_pwr", Int(-202, -60)),
        M("preamb_trans_max",
          Enum(["n3", "n4", "n5", "n6", "n7", "n8", "n10", "n20", "n50", "n100", "n200"])),
        M("pwr_ramp_step", Enum(["db0", "db2", "db4", "db6"])),
        M("ra_resp_win", Enum(["sl1", "sl2", "sl4", "sl8", "sl10", "sl20", "sl40", "sl80"])),
    ],
    ext=True,
)

SI_REQUEST_RES = Seq(
    [
        M("ra_preamb_start_idx", Int(0, 63)),
        O("ra_assoc_period_idx", Int(0, 15)),
        O("ra_ssb_occasion_mask_idx", Int(0, 15)),
    ]
)

SI_REQUEST_CFG = Seq(
    [
        O("rach_occasions_si", Seq([
            M("rach_cfg_si", RACH_CFG_GENERIC),
            M("ssb_per_rach_occasion",
              Enum(["one_eighth", "one_fourth", "one_half", "one", "two", "four",
                    "eight", "sixteen"])),
        ])),
        O("si_request_period",
          Enum(["one", "two", "four", "six", "eight", "ten", "twelve", "sixteen"])),
        M("si_request_res", SeqOf(SI_REQUEST_RES, 1, 32)),
    ]
)

SIB_TYPE_INFO = Seq(
    [
        M("type", Enum(["sib_type2", "sib_type3", "sib_type4", "sib_type5", "sib_type6",
                        "sib_type7", "sib_type8", "sib_type9", "spare8", "spare7", "spare6",
                        "spare5", "spare4", "spare3", "spare2", "spare1"], ext=True)),
        O("value_tag", Int(0, 31)),
        O("area_scope", FLAG),
    ]
)

SCHED_INFO = Seq(
    [
        M("si_broadcast_status", Enum(["broadcasting", "not_broadcasting"])),
        M("si_periodicity", Enum(["rf8", "rf16", "rf32", "rf64", "rf128", "rf256", "rf512"])),
        M("sib_map_info", SeqOf(SIB_TYPE_INFO, 1, 32)),
    ]
)

SI_SCHED_INFO = Seq(
    [
        M("sched_info_list", SeqOf(SCHED_INFO, 1, 32)),
        M("si_win_len",
          Enum(["s5", "s10", "s20", "s40", "s80", "s160", "s320", "s640", "s1280"])),
        O("si_request_cfg", SI_REQUEST_CFG),
        O("si_request_cfg_sul", SI_REQUEST_CFG),
        O("sys_info_area_id", BitStr(24)),
    ],
    ext=True,
)

UE_TIMERS_AND_CONSTS = Seq(
    [
        M("t300", Enum(["ms100", "ms200", "ms300", "ms400", "ms600", "ms1000", "ms1500",
                        "ms2000"])),
        M("t301", Enum(["ms100", "ms200", "ms300", "ms400", "ms600", "ms1000", "ms1500",
                        "ms2000"])),
        M("t310", Enum(["ms0", "ms50", "ms100", "ms200", "ms500", "ms1000", "ms2000"])),
        M("n310", Enum(["n1", "n2", "n3", "n4", "n6", "n8", "n10", "n20"])),
        M("t311", Enum(["ms1000", "ms3000", "ms5000", "ms10000", "ms15000", "ms20000",
                        "ms30000"])),
        M("n311", Enum(["n1", "n2", "n3", "n4", "n5", "n6", "n8", "n10"])),
        M("t319", Enum(["ms100", "ms200", "ms300", "ms400", "ms600", "ms1000", "ms1500",
                        "ms2000"])),
    ],
    ext=True,
)

CELL_SELECTION_INFO = Seq(
    [
        M("q_rx_lev_min", Int(-70, -22)),
        O("q_rx_lev_min_offset", Int(1, 8)),
        O("q_rx_lev_min_sul", Int(-70, -22)),
        O("q_qual_min", Int(-43, -12)),
        O("q_qual_min_offset", Int(1, 8)),
    ]
)


class _Unsupported(Seq):
    """Placeholder for SIB1 optionals the scaffolding never emits
    (servingCellConfigCommon, uac-BarringInfo) — decode raises if present."""

    def __init__(self, name: str):
        super().__init__([])
        self.name = name

    def encode(self, w, value):
        raise NotImplementedError(f"{self.name} not supported")

    def decode(self, r):
        raise NotImplementedError(f"{self.name} not supported")


SIB1 = Seq(
    [
        O("cell_sel_info", CELL_SELECTION_INFO),
        M("cell_access_related_info", CELL_ACCESS_RELATED_INFO),
        O("conn_est_fail_ctrl", CONN_EST_FAIL_CTRL),
        O("si_sched_info", SI_SCHED_INFO),
        O("serving_cell_cfg_common", _Unsupported("servingCellConfigCommon")),
        O("ims_emergency_support", FLAG),
        O("ecall_over_ims_support", FLAG),
        O("ue_timers_and_consts", UE_TIMERS_AND_CONSTS),
        O("uac_barr_info", _Unsupported("uac-BarringInfo")),
        O("use_full_resume_id", FLAG),
        O("late_non_crit_ext", OctStr()),
        O("non_crit_ext", Seq([])),
    ]
)

BCCH_DL_SCH_MESSAGE = Seq(
    [
        M("message", Choice([
            ("c1", Choice([("sys_info", _Unsupported("systemInformation")),
                           ("sib_type1", SIB1)])),
            ("msg_class_ext", Seq([])),
        ]))
    ]
)

# ------------------------------------------------------- bearer / security

CIPHERING_ALGORITHM = Enum(
    ["nea0", "nea1", "nea2", "nea3", "spare4", "spare3", "spare2", "spare1"], ext=True
)
INTEGRITY_PROT_ALGORITHM = Enum(
    ["nia0", "nia1", "nia2", "nia3", "spare4", "spare3", "spare2", "spare1"], ext=True
)

SECURITY_ALGORITHM_CFG = Seq(
    [
        M("ciphering_algorithm", CIPHERING_ALGORITHM),
        O("integrity_prot_algorithm", INTEGRITY_PROT_ALGORITHM),
    ],
    ext=True,
)

SECURITY_CFG = Seq(
    [
        O("security_algorithm_cfg", SECURITY_ALGORITHM_CFG),
        O("key_to_use", Enum(["master", "secondary"])),
    ],
    ext=True,
)

PDCP_CFG_DRB = Seq(
    [
        O("discard_timer",
          Enum(["ms10", "ms20", "ms30", "ms40", "ms50", "ms60", "ms75", "ms100", "ms150",
                "ms200", "ms250", "ms300", "ms500", "ms750", "ms1500", "infinity"])),
        O("pdcp_sn_size_ul", Enum(["len12bits", "len18bits"])),
        O("pdcp_sn_size_dl", Enum(["len12bits", "len18bits"])),
        M("hdr_compress", Choice([("not_used", Null()),
                                  ("rohc", _Unsupported("rohc")),
                                  ("ul_only_rohc", _Unsupported("uplinkOnlyROHC"))],
                                 ext=True)),
        O("integrity_protection", FLAG),
        O("status_report_required", FLAG),
        O("out_of_order_delivery", FLAG),
    ]
)

T_REORDERING = Enum(
    ["ms0", "ms1", "ms2", "ms4", "ms5", "ms8", "ms10", "ms15", "ms20", "ms30", "ms40",
     "ms50", "ms60", "ms80", "ms100", "ms120", "ms140", "ms160", "ms180", "ms200", "ms220",
     "ms240", "ms260", "ms280", "ms300", "ms500", "ms750", "ms1000", "ms1250", "ms1500",
     "ms1750", "ms2000", "ms2250", "ms2500", "ms2750", "ms3000"]
    + [f"spare{28 - i}" for i in range(28)]
)

PDCP_CFG = Seq(
    [
        O("drb", PDCP_CFG_DRB),
        O("more_than_one_rlc", _Unsupported("moreThanOneRLC")),
        O("t_reordering", T_REORDERING),
    ],
    ext=True,
    ext_additions=[[O("ciphering_disabled", FLAG)]],  # [[ cipheringDisabled ]] v-bracket
)

SRB_TO_ADD_MOD = Seq(
    [
        M("srb_id", Int(1, 3)),
        O("reestablish_pdcp", FLAG),
        O("discard_on_pdcp", FLAG),
        O("pdcp_cfg", PDCP_CFG),
    ],
    ext=True,
)

CN_ASSOC = Choice([("eps_bearer_id", Int(0, 15)), ("sdap_cfg", _Unsupported("sdap-Config"))])

DRB_TO_ADD_MOD = Seq(
    [
        O("cn_assoc", CN_ASSOC),
        M("drb_id", Int(1, 32)),
        O("reestablish_pdcp", FLAG),
        O("recover_pdcp", FLAG),
        O("pdcp_cfg", PDCP_CFG),
    ],
    ext=True,
)

RADIO_BEARER_CFG = Seq(
    [
        O("srb_to_add_mod_list", SeqOf(SRB_TO_ADD_MOD, 1, 2)),
        O("srb3_to_release", FLAG),
        O("drb_to_add_mod_list", SeqOf(DRB_TO_ADD_MOD, 1, 29)),
        O("drb_to_release_list", SeqOf(Int(1, 32), 1, 29)),
        O("security_cfg", SECURITY_CFG),
    ],
    ext=True,
)

# ------------------------------------------------------------------ UL-CCCH

INITIAL_UE_IDENTITY = Choice(
    [("ng_5g_s_tmsi_part1", BitStr(39)), ("random_value", BitStr(39))]
)

ESTABLISHMENT_CAUSE = Enum(
    ["emergency", "high_prio_access", "mt_access", "mo_sig", "mo_data", "mo_voice_call",
     "mo_video_call", "mo_sms", "mps_prio_access", "mcs_prio_access", "spare6", "spare5",
     "spare4", "spare3", "spare2", "spare1"]
)

RRC_SETUP_REQUEST = Seq(
    [M("rrc_setup_request", Seq([
        M("ue_id", INITIAL_UE_IDENTITY),
        M("establishment_cause", ESTABLISHMENT_CAUSE),
        M("spare", BitStr(1)),
    ]))]
)

UL_CCCH_MESSAGE = Seq(
    [M("message", Choice([
        ("c1", Choice([
            ("rrc_setup_request", RRC_SETUP_REQUEST),
            ("rrc_resume_request", _Unsupported("rrcResumeRequest")),
            ("rrc_reest_request", _Unsupported("rrcReestablishmentRequest")),
            ("rrc_sys_info_request", _Unsupported("rrcSystemInfoRequest")),
        ])),
        ("msg_class_ext", Seq([])),
    ]))]
)

# ------------------------------------------------------------------ DL-CCCH


def _crit_exts(name, ies):
    """criticalExtensions CHOICE {<name> IEs, criticalExtensionsFuture {}}."""
    return Choice([(name, ies), ("crit_exts_future", Seq([]))])


RRC_SETUP_IES = Seq(
    [
        M("radio_bearer_cfg", RADIO_BEARER_CFG),
        M("master_cell_group", OctStr()),
        O("late_non_crit_ext", OctStr()),
        O("non_crit_ext", Seq([])),
    ]
)

RRC_SETUP = Seq(
    [M("rrc_transaction_id", Int(0, 3)), M("crit_exts", _crit_exts("rrc_setup", RRC_SETUP_IES))]
)

RRC_REJECT_IES = Seq(
    [O("wait_time", Int(1, 16)), O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))]
)

RRC_REJECT = Seq([M("crit_exts", _crit_exts("rrc_reject", RRC_REJECT_IES))])

DL_CCCH_MESSAGE = Seq(
    [M("message", Choice([
        ("c1", c1_spares([("rrc_reject", RRC_REJECT), ("rrc_setup", RRC_SETUP)], 2)),
        ("msg_class_ext", Seq([])),
    ]))]
)

# ------------------------------------------------------------------ UL-DCCH

REGISTERED_AMF = Seq([O("plmn_id", PLMN_IDENTITY), M("amf_id", BitStr(24))])

S_NSSAI = Choice([("sst", BitStr(8)), ("sst_sd", BitStr(32))])

NG_5G_S_TMSI_VALUE = Choice(
    [("ng_5g_s_tmsi", BitStr(48)), ("ng_5g_s_tmsi_part2", BitStr(9))]
)

RRC_SETUP_COMPLETE_IES = Seq(
    [
        M("sel_plmn_id", Int(1, 12)),
        O("registered_amf", REGISTERED_AMF),
        O("guami_type", Enum(["native", "mapped"])),
        O("s_nssai_list", SeqOf(S_NSSAI, 1, 8)),
        M("ded_nas_msg", OctStr()),
        O("ng_5g_s_tmsi_value", NG_5G_S_TMSI_VALUE),
        O("late_non_crit_ext", OctStr()),
        O("non_crit_ext", Seq([])),
    ]
)

RRC_SETUP_COMPLETE = Seq(
    [M("rrc_transaction_id", Int(0, 3)),
     M("crit_exts", _crit_exts("rrc_setup_complete", RRC_SETUP_COMPLETE_IES))]
)

UL_INFO_TRANSFER_IES = Seq(
    [O("ded_nas_msg", OctStr()), O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))]
)

UL_INFO_TRANSFER = Seq(
    [M("crit_exts", _crit_exts("ul_info_transfer", UL_INFO_TRANSFER_IES))]
)

_UL_DCCH_C1 = [
    ("meas_report", _Unsupported("measurementReport")),
    ("rrc_recfg_complete", _Unsupported("rrcReconfigurationComplete")),
    ("rrc_setup_complete", RRC_SETUP_COMPLETE),
    ("rrc_reest_complete", _Unsupported("rrcReestablishmentComplete")),
    ("rrc_resume_complete", _Unsupported("rrcResumeComplete")),
    ("security_mode_complete", _Unsupported("securityModeComplete")),
    ("security_mode_fail", _Unsupported("securityModeFailure")),
    ("ul_info_transfer", UL_INFO_TRANSFER),
    ("location_meas_ind", _Unsupported("locationMeasurementIndication")),
    ("ue_cap_info", _Unsupported("ueCapabilityInformation")),
    ("counter_check_resp", _Unsupported("counterCheckResponse")),
    ("ue_assist_info", _Unsupported("ueAssistanceInformation")),
    ("fail_info", _Unsupported("failureInformation")),
]

UL_DCCH_MESSAGE = Seq(
    [M("message", Choice([
        ("c1", c1_spares(_UL_DCCH_C1, 3)),
        ("msg_class_ext", Seq([])),
    ]))]
)

# ------------------------------------------------------------------ DL-DCCH

DL_INFO_TRANSFER_IES = Seq(
    [O("ded_nas_msg", OctStr()), O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))]
)

DL_INFO_TRANSFER = Seq(
    [M("rrc_transaction_id", Int(0, 3)),
     M("crit_exts", _crit_exts("dl_info_transfer", DL_INFO_TRANSFER_IES))]
)

RRC_RELEASE_IES = Seq(
    [
        O("redirected_carrier_info", _Unsupported("redirectedCarrierInfo")),
        O("cell_resel_priorities", _Unsupported("cellReselectionPriorities")),
        O("suspend_cfg", _Unsupported("suspendConfig")),
        O("depriorit_req", _Unsupported("deprioritisationReq")),
        O("late_non_crit_ext", OctStr()),
        O("non_crit_ext", Seq([])),
    ]
)

RRC_RELEASE = Seq(
    [M("rrc_transaction_id", Int(0, 3)),
     M("crit_exts", _crit_exts("rrc_release", RRC_RELEASE_IES))]
)

_DL_DCCH_C1 = [
    ("rrc_recfg", _Unsupported("rrcReconfiguration")),
    ("rrc_resume", _Unsupported("rrcResume")),
    ("rrc_release", RRC_RELEASE),
    ("rrc_reest", _Unsupported("rrcReestablishment")),
    ("security_mode_cmd", _Unsupported("securityModeCommand")),
    ("dl_info_transfer", DL_INFO_TRANSFER),
    ("ue_cap_enquiry", _Unsupported("ueCapabilityEnquiry")),
    ("counter_check", _Unsupported("counterCheck")),
    ("mob_from_nr_cmd", _Unsupported("mobilityFromNRCommand")),
]

DL_DCCH_MESSAGE = Seq(
    [M("message", Choice([
        ("c1", c1_spares(_DL_DCCH_C1, 7)),
        ("msg_class_ext", Seq([])),
    ]))]
)

# -------------------------------------------------------------- public API

CHANNELS = {
    "bcch_bch": BCCH_BCH_MESSAGE,
    "bcch_dl_sch": BCCH_DL_SCH_MESSAGE,
    "ul_ccch": UL_CCCH_MESSAGE,
    "dl_ccch": DL_CCCH_MESSAGE,
    "ul_dcch": UL_DCCH_MESSAGE,
    "dl_dcch": DL_DCCH_MESSAGE,
}


def pack(channel: str, value: dict) -> bytes:
    return CHANNELS[channel].to_bytes(value, aligned=False)


def unpack(channel: str, data: bytes) -> dict:
    return CHANNELS[channel].from_bytes(data, aligned=False)
