"""Host copy of `srsran_tpu/stack/asn1/s1ap.py`, held to it by `tests/test_torch_stack.py`.

TS 36.413 S1AP message schemas (ALIGNED PER) on the per.py DSL.

Replaces the reference's generated `s1ap_asn1.cc` (60 kLoC — SURVEY §2.2)
for the procedures the EPC/eNB exchange: S1 Setup, Initial UE Message,
DL/UL NAS Transport, Initial Context Setup, UE Context Release.

S1AP wraps every message in an open-type envelope and carries IEs as
{id, criticality, open-type value} triplets; `IeContainer` models that
with a per-message registry, preserving unknown IEs as raw bytes.
Validated against the golden vectors in the reference's
lib/test/asn1/s1ap_asn1_test.cc (tests/test_asn1_s1ap.py).
"""

from __future__ import annotations

from .per import (
    Asn1Error,
    Asn1Type,
    BitStr,
    Bool,
    CharStr,
    Choice,
    Enum,
    Int,
    M,
    Null,
    O,
    OctStr,
    Seq,
    SeqOf,
    get_constrained,
    get_length,
    put_constrained,
    put_length,
    put_open_type,
    get_open_type,
)

CRITICALITY = ["reject", "ignore", "notify"]


class ExtContainer(Asn1Type):
    """ProtocolExtensionContainer ::= SEQUENCE (SIZE(1..65535)) OF
    {id, criticality, extensionValue(open)} — kept raw and re-emitted so
    unknown extensions round-trip bit-exactly."""

    def encode(self, w, value: list):
        put_constrained(w, len(value), 1, 65535)
        for ie_id, crit, raw in value:
            put_constrained(w, ie_id, 0, 65535)
            put_constrained(w, crit, 0, 2)
            put_length(w, len(raw))
            w.put_bytes(raw)

    def decode(self, r):
        n = get_constrained(r, 1, 65535)
        out = []
        for _ in range(n):
            ie_id = get_constrained(r, 0, 65535)
            crit = get_constrained(r, 0, 2)
            octets = get_length(r)
            out.append((ie_id, crit, r.get_bytes(octets)))
        return out


IE_EXTS = ExtContainer()


# ---------------------------------------------------------------- IE types

PLMN_IDENTITY = OctStr(3, 3)
MME_UE_S1AP_ID = Int(0, 4294967295)
ENB_UE_S1AP_ID = Int(0, 16777215)
NAS_PDU = OctStr()
BIT_RATE = Int(0, 10_000_000_000)

# iE-Extensions containers are modelled as raw-preserving IE containers
# (defined after IeContainer below); messages here never emit them.

GLOBAL_ENB_ID = Seq(
    [
        M("plmn_id", PLMN_IDENTITY),
        M("enb_id", Choice([("macro_enb_id", BitStr(20)), ("home_enb_id", BitStr(28))], ext=True)),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)

ENB_NAME = CharStr(1, 150, ext=True)
MME_NAME = CharStr(1, 150, ext=True)

SUPPORTED_TAS_ITEM = Seq(
    [M("tac", OctStr(2, 2)), M("broadcast_plmns", SeqOf(PLMN_IDENTITY, 1, 6)),
     O("ie_exts", IE_EXTS)], ext=True
)
SUPPORTED_TAS = SeqOf(SUPPORTED_TAS_ITEM, 1, 256)

PAGING_DRX = Enum(["v32", "v64", "v128", "v256"], ext=True)

TAI = Seq([M("plmn_id", PLMN_IDENTITY), M("tac", OctStr(2, 2)), O("ie_exts", IE_EXTS)], ext=True)
EUTRAN_CGI = Seq([M("plmn_id", PLMN_IDENTITY), M("cell_id", BitStr(28)), O("ie_exts", IE_EXTS)], ext=True)

RRC_ESTABLISHMENT_CAUSE = Enum(
    ["emergency", "high_prio_access", "mt_access", "mo_sig", "mo_data"],
    ext=True,
    ext_names=["delay_tolerant_access", "mo_voice_call", "mo_exception_data"],
)

S_TMSI = Seq([M("mmec", OctStr(1, 1)), M("m_tmsi", OctStr(4, 4)), O("ie_exts", IE_EXTS)], ext=True)

CAUSE = Choice(
    [
        (
            "radio_network",
            Enum(
                ["unspecified", "tx2relocoverall_expiry", "successful_ho",
                 "release_due_to_eutran_generated_reason", "ho_cancelled", "partial_ho",
                 "ho_fail_in_target_epc_enb_or_target_sys", "ho_target_not_allowed",
                 "ts1relocoverall_expiry", "ts1relocprep_expiry", "cell_not_available",
                 "unknown_target_id", "no_radio_res_available_in_target_cell",
                 "unknown_mme_ue_s1ap_id", "unknown_enb_ue_s1ap_id", "unknown_pair_ue_s1ap_id",
                 "ho_desirable_for_radio_reason", "time_crit_ho", "res_optim_ho",
                 "reduce_load_in_serving_cell", "user_inactivity", "radio_conn_with_ue_lost",
                 "load_balancing_tau_required", "cs_fallback_triggered",
                 "ue_not_available_for_ps_service", "radio_res_not_available",
                 "fail_in_radio_interface_proc", "invalid_qos_combination",
                 "interrat_redirection", "interaction_with_other_proc", "unknown_erab_id",
                 "multiple_erab_id_instances",
                 "encryption_and_or_integrity_protection_algorithms_not_supported",
                 "s1_intra_sys_ho_triggered", "s1_inter_sys_ho_triggered"],
                ext=True,
                ext_names=["x2_ho_triggered", "not_supported_qci_value", "invalid_csg_id",
                           "release_due_to_pre_emption"],
            ),
        ),
        ("transport", Enum(["transport_res_unavailable", "unspecified"], ext=True)),
        ("nas", Enum(["normal_release", "authentication_fail", "detach", "unspecified"],
                     ext=True, ext_names=["csg_subscription_expiry"])),
        ("protocol", Enum(["transfer_syntax_error", "abstract_syntax_error_reject",
                           "abstract_syntax_error_ignore_and_notify",
                           "msg_not_compatible_with_receiver_state", "semantic_error",
                           "abstract_syntax_error_falsely_constructed_msg", "unspecified"],
                          ext=True)),
        ("misc", Enum(["ctrl_processing_overload", "not_enough_user_plane_processing_res",
                       "hardware_fail", "om_intervention", "unspecified", "unknown_plmn"],
                      ext=True)),
    ],
    ext=True,
)

UE_AGGREGATE_MAXIMUM_BITRATE = Seq(
    [M("ue_aggregate_maximum_bit_rate_dl", BIT_RATE), M("ue_aggregate_maximum_bit_rate_ul", BIT_RATE),
     O("ie_exts", IE_EXTS)],
    ext=True,
)

ALLOCATION_AND_RETENTION_PRIORITY = Seq(
    [
        M("prio_level", Int(0, 15)),
        M("pre_emption_cap", Enum(["shall_not_trigger_pre_emption", "may_trigger_pre_emption"])),
        M("pre_emption_vulnerability", Enum(["not_pre_emptable", "pre_emptable"])),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)

GBR_QOS_INFORMATION = Seq(
    [
        M("erab_maximum_bitrate_dl", BIT_RATE),
        M("erab_maximum_bitrate_ul", BIT_RATE),
        M("erab_guaranteed_bitrate_dl", BIT_RATE),
        M("erab_guaranteed_bitrate_ul", BIT_RATE),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)

ERAB_LEVEL_QOS_PARAMETERS = Seq(
    [
        M("qci", Int(0, 255)),
        M("alloc_retention_prio", ALLOCATION_AND_RETENTION_PRIORITY),
        O("gbr_qos_info", GBR_QOS_INFORMATION),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)

TRANSPORT_LAYER_ADDRESS = BitStr(1, 160, ext=True)
GTP_TEID = OctStr(4, 4)
ERAB_ID = Int(0, 15, ext=True)

UE_SECURITY_CAPABILITIES = Seq(
    [
        M("encryption_algorithms", BitStr(16, ext=True)),
        M("integrity_protection_algorithms", BitStr(16, ext=True)),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)

SECURITY_KEY = BitStr(256)

UE_S1AP_IDS = Choice(
    [
        ("ue_s1ap_id_pair", Seq([M("mme_ue_s1ap_id", MME_UE_S1AP_ID), M("enb_ue_s1ap_id", ENB_UE_S1AP_ID), O("ie_exts", IE_EXTS)], ext=True)),
        ("mme_ue_s1ap_id", MME_UE_S1AP_ID),
    ],
    ext=True,
)

MME_GROUP_ID = OctStr(2, 2)
MME_CODE = OctStr(1, 1)
SERVED_GUMMEIS_ITEM = Seq(
    [
        M("served_plmns", SeqOf(PLMN_IDENTITY, 1, 32)),
        M("served_group_ids", SeqOf(MME_GROUP_ID, 1, 65535)),
        M("served_mmecs", SeqOf(MME_CODE, 1, 256)),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)
SERVED_GUMMEIS = SeqOf(SERVED_GUMMEIS_ITEM, 1, 8)

RELATIVE_MME_CAPACITY = Int(0, 255)

TIME_TO_WAIT = Enum(["v1s", "v2s", "v5s", "v10s", "v20s", "v60s"], ext=True)


# ---------------------------------------------- protocol IE field machinery


class Ie:
    """One ProtocolIE-Field spec entry: (id, criticality, type)."""

    def __init__(self, ie_id: int, name: str, crit: str, typ: Asn1Type):
        self.ie_id, self.name, self.crit, self.typ = ie_id, name, crit, typ


class IeContainer(Asn1Type):
    """ProtocolIE-Container ::= SEQUENCE (SIZE(0..65535)) OF ProtocolIE-Field.

    Value = dict name → IE value, in wire order (python dicts preserve
    insertion order).  Unknown IEs decode to "_ie<id>" → (crit_idx, raw
    octets) and re-encode verbatim.
    """

    def __init__(self, ies: list[Ie], lo: int = 0, hi: int = 65535):
        self.by_name = {ie.name: ie for ie in ies}
        self.by_id = {ie.ie_id: ie for ie in ies}
        self.lo, self.hi = lo, hi

    def encode(self, w, value: dict):
        items = list(value.items())
        put_constrained(w, len(items), self.lo, self.hi)
        for name, v in items:
            if name.startswith("_ie"):
                crit_idx, raw = v
                put_constrained(w, int(name[3:]), 0, 65535)
                put_constrained(w, crit_idx, 0, 2)
                put_length(w, len(raw))
                w.put_bytes(raw)
                continue
            ie = self.by_name[name]
            put_constrained(w, ie.ie_id, 0, 65535)
            put_constrained(w, CRITICALITY.index(ie.crit), 0, 2)
            put_open_type(w, ie.typ, v)

    def decode(self, r):
        n = get_constrained(r, self.lo, self.hi)
        out = {}
        for _ in range(n):
            ie_id = get_constrained(r, 0, 65535)
            crit = get_constrained(r, 0, 2)
            ie = self.by_id.get(ie_id)
            if ie is None:
                octets = get_length(r)
                out[f"_ie{ie_id}"] = (crit, r.get_bytes(octets))
            else:
                out[ie.name] = get_open_type(r, ie.typ)
        return out


def ie_message(*ies: Ie) -> Seq:
    """A top-level S1AP message: SEQUENCE {protocolIEs <container>, ...}."""
    return Seq([M("protocol_ies", IeContainer(list(ies)))], ext=True)


# E-RAB item lists are SEQUENCE OF ProtocolIE-SingleContainer — each element
# is one (id, crit, open-type) triplet.
class SingleContainerList(Asn1Type):
    def __init__(self, ie: Ie, lo: int = 1, hi: int = 256):
        self.ie, self.lo, self.hi = ie, lo, hi

    def encode(self, w, value: list):
        put_constrained(w, len(value), self.lo, self.hi)
        for v in value:
            put_constrained(w, self.ie.ie_id, 0, 65535)
            put_constrained(w, CRITICALITY.index(self.ie.crit), 0, 2)
            put_open_type(w, self.ie.typ, v)

    def decode(self, r):
        n = get_constrained(r, self.lo, self.hi)
        out = []
        for _ in range(n):
            ie_id = get_constrained(r, 0, 65535)
            get_constrained(r, 0, 2)  # criticality
            if ie_id != self.ie.ie_id:
                raise Asn1Error(f"unexpected item IE id {ie_id}")
            out.append(get_open_type(r, self.ie.typ))
        return out


ERAB_TO_BE_SETUP_ITEM_CTXT_SU_REQ = Seq(
    [
        M("erab_id", ERAB_ID),
        M("erab_level_qos_params", ERAB_LEVEL_QOS_PARAMETERS),
        M("transport_layer_address", TRANSPORT_LAYER_ADDRESS),
        M("gtp_teid", GTP_TEID),
        O("nas_pdu", NAS_PDU),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)

ERAB_SETUP_ITEM_CTXT_SU_RES = Seq(
    [
        M("erab_id", ERAB_ID),
        M("transport_layer_address", TRANSPORT_LAYER_ADDRESS),
        M("gtp_teid", GTP_TEID),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)

ERAB_ITEM = Seq([M("erab_id", ERAB_ID), M("cause", CAUSE), O("ie_exts", IE_EXTS)], ext=True)

ERAB_TO_BE_SETUP_LIST_CTXT_SU_REQ = SingleContainerList(
    Ie(52, "erab_to_be_setup_item_ctxt_su_req", "reject", ERAB_TO_BE_SETUP_ITEM_CTXT_SU_REQ)
)
ERAB_SETUP_LIST_CTXT_SU_RES = SingleContainerList(
    Ie(50, "erab_setup_item_ctxt_su_res", "ignore", ERAB_SETUP_ITEM_CTXT_SU_RES)
)

HANDOVER_TYPE = Enum(["intralte", "ltetoutran", "ltetogeran", "utrantolte", "gerantolte"],
                     ext=True)

TARGET_ENB_ID = Seq(
    [M("global_enb_id", GLOBAL_ENB_ID), M("sel_tai", TAI), O("ie_exts", IE_EXTS)], ext=True
)
TARGET_ID = Choice(
    [("targetenb_id", TARGET_ENB_ID), ("target_rnc_id", OctStr()), ("cgi", OctStr())],
    ext=True,
)

SECURITY_CONTEXT = Seq(
    [
        M("next_hop_chaining_count", Int(0, 7)),
        M("next_hop_param", BitStr(256)),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)

ERAB_TO_BE_SETUP_ITEM_HO_REQ = Seq(
    [
        M("erab_id", ERAB_ID),
        M("transport_layer_address", TRANSPORT_LAYER_ADDRESS),
        M("gtp_teid", GTP_TEID),
        M("erab_level_qos_params", ERAB_LEVEL_QOS_PARAMETERS),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)
ERAB_TO_BE_SETUP_LIST_HO_REQ = SingleContainerList(
    Ie(27, "erab_to_be_setup_item_ho_req", "reject", ERAB_TO_BE_SETUP_ITEM_HO_REQ)
)

ERAB_ADMITTED_ITEM = Seq(
    [
        M("erab_id", ERAB_ID),
        M("transport_layer_address", TRANSPORT_LAYER_ADDRESS),
        M("gtp_teid", GTP_TEID),
        O("dl_transport_layer_address", TRANSPORT_LAYER_ADDRESS),
        O("dl_gtp_teid", GTP_TEID),
        O("ul_transport_layer_address", TRANSPORT_LAYER_ADDRESS),
        O("ul_gtp_teid", GTP_TEID),
        O("ie_exts", IE_EXTS),
    ],
    ext=True,
)
ERAB_ADMITTED_LIST = SingleContainerList(Ie(20, "erab_admitted_item", "ignore", ERAB_ADMITTED_ITEM))

# ------------------------------------------------------------ the messages

S1_SETUP_REQUEST = ie_message(
    Ie(59, "global_enb_id", "reject", GLOBAL_ENB_ID),
    Ie(60, "enbname", "ignore", ENB_NAME),
    Ie(64, "supported_tas", "reject", SUPPORTED_TAS),
    Ie(137, "default_paging_drx", "ignore", PAGING_DRX),
)

S1_SETUP_RESPONSE = ie_message(
    Ie(61, "mmename", "ignore", MME_NAME),
    Ie(105, "served_gummeis", "reject", SERVED_GUMMEIS),
    Ie(87, "relative_mme_capacity", "ignore", RELATIVE_MME_CAPACITY),
)

S1_SETUP_FAILURE = ie_message(
    Ie(2, "cause", "ignore", CAUSE),
    Ie(65, "time_to_wait", "ignore", TIME_TO_WAIT),
)

INITIAL_UE_MESSAGE = ie_message(
    Ie(8, "enb_ue_s1ap_id", "reject", ENB_UE_S1AP_ID),
    Ie(26, "nas_pdu", "reject", NAS_PDU),
    Ie(67, "tai", "reject", TAI),
    Ie(100, "eutran_cgi", "ignore", EUTRAN_CGI),
    Ie(134, "rrc_establishment_cause", "ignore", RRC_ESTABLISHMENT_CAUSE),
    Ie(96, "s_tmsi", "reject", S_TMSI),
)

DOWNLINK_NAS_TRANSPORT = ie_message(
    Ie(0, "mme_ue_s1ap_id", "reject", MME_UE_S1AP_ID),
    Ie(8, "enb_ue_s1ap_id", "reject", ENB_UE_S1AP_ID),
    Ie(26, "nas_pdu", "reject", NAS_PDU),
)

UPLINK_NAS_TRANSPORT = ie_message(
    Ie(0, "mme_ue_s1ap_id", "reject", MME_UE_S1AP_ID),
    Ie(8, "enb_ue_s1ap_id", "reject", ENB_UE_S1AP_ID),
    Ie(26, "nas_pdu", "reject", NAS_PDU),
    Ie(100, "eutran_cgi", "ignore", EUTRAN_CGI),
    Ie(67, "tai", "ignore", TAI),
)

INITIAL_CONTEXT_SETUP_REQUEST = ie_message(
    Ie(0, "mme_ue_s1ap_id", "reject", MME_UE_S1AP_ID),
    Ie(8, "enb_ue_s1ap_id", "reject", ENB_UE_S1AP_ID),
    Ie(66, "ue_aggregate_maximum_bitrate", "reject", UE_AGGREGATE_MAXIMUM_BITRATE),
    Ie(24, "erab_to_be_setup_list_ctxt_su_req", "reject", ERAB_TO_BE_SETUP_LIST_CTXT_SU_REQ),
    Ie(107, "ue_security_cap", "reject", UE_SECURITY_CAPABILITIES),
    Ie(73, "security_key", "reject", SECURITY_KEY),
)

INITIAL_CONTEXT_SETUP_RESPONSE = ie_message(
    Ie(0, "mme_ue_s1ap_id", "ignore", MME_UE_S1AP_ID),
    Ie(8, "enb_ue_s1ap_id", "ignore", ENB_UE_S1AP_ID),
    Ie(51, "erab_setup_list_ctxt_su_res", "ignore", ERAB_SETUP_LIST_CTXT_SU_RES),
)

UE_CONTEXT_RELEASE_REQUEST = ie_message(
    Ie(0, "mme_ue_s1ap_id", "reject", MME_UE_S1AP_ID),
    Ie(8, "enb_ue_s1ap_id", "reject", ENB_UE_S1AP_ID),
    Ie(2, "cause", "ignore", CAUSE),
)

UE_CONTEXT_RELEASE_COMMAND = ie_message(
    Ie(99, "ue_s1ap_ids", "reject", UE_S1AP_IDS),
    Ie(2, "cause", "ignore", CAUSE),
)

UE_CONTEXT_RELEASE_COMPLETE = ie_message(
    Ie(0, "mme_ue_s1ap_id", "ignore", MME_UE_S1AP_ID),
    Ie(8, "enb_ue_s1ap_id", "ignore", ENB_UE_S1AP_ID),
)

# Paging (36.413 §9.1.6); UEPagingID §9.2.3.13, CNDomain §9.2.3.22
UE_PAGING_ID = Choice([("s_tmsi", S_TMSI), ("imsi", OctStr(3, 8))], ext=True)
CN_DOMAIN = Enum(["ps", "cs"])
TAI_ITEM = Seq([M("tai", TAI), O("ie_exts", IE_EXTS)], ext=True)
TAI_LIST = SingleContainerList(Ie(47, "tai_item", "ignore", TAI_ITEM))

PAGING = ie_message(
    Ie(80, "ue_id_idx_value", "ignore", BitStr(10, 10)),
    Ie(43, "ue_paging_id", "ignore", UE_PAGING_ID),
    Ie(44, "paging_drx", "ignore", PAGING_DRX),
    Ie(109, "cn_domain", "reject", CN_DOMAIN),
    Ie(46, "tai_list", "ignore", TAI_LIST),
)

# S1 handover signalling (36.413 §8.4; rrc_mobility.cc S1 handover path)
HANDOVER_REQUIRED = ie_message(
    Ie(0, "mme_ue_s1ap_id", "reject", MME_UE_S1AP_ID),
    Ie(8, "enb_ue_s1ap_id", "reject", ENB_UE_S1AP_ID),
    Ie(1, "handov_type", "reject", HANDOVER_TYPE),
    Ie(2, "cause", "ignore", CAUSE),
    Ie(4, "target_id", "reject", TARGET_ID),
    Ie(104, "source_to_target_transparent_container", "reject", OctStr()),
)

HANDOVER_COMMAND = ie_message(
    Ie(0, "mme_ue_s1ap_id", "reject", MME_UE_S1AP_ID),
    Ie(8, "enb_ue_s1ap_id", "reject", ENB_UE_S1AP_ID),
    Ie(1, "handov_type", "reject", HANDOVER_TYPE),
    Ie(123, "target_to_source_transparent_container", "reject", OctStr()),
)

HANDOVER_REQUEST = ie_message(
    Ie(0, "mme_ue_s1ap_id", "reject", MME_UE_S1AP_ID),
    Ie(1, "handov_type", "reject", HANDOVER_TYPE),
    Ie(2, "cause", "ignore", CAUSE),
    Ie(66, "ue_aggregate_maximum_bitrate", "reject", UE_AGGREGATE_MAXIMUM_BITRATE),
    Ie(53, "erab_to_be_setup_list_ho_req", "reject", ERAB_TO_BE_SETUP_LIST_HO_REQ),
    Ie(104, "source_to_target_transparent_container", "reject", OctStr()),
    Ie(107, "ue_security_cap", "reject", UE_SECURITY_CAPABILITIES),
    Ie(40, "security_context", "reject", SECURITY_CONTEXT),
)

HANDOVER_REQUEST_ACKNOWLEDGE = ie_message(
    Ie(0, "mme_ue_s1ap_id", "ignore", MME_UE_S1AP_ID),
    Ie(8, "enb_ue_s1ap_id", "ignore", ENB_UE_S1AP_ID),
    Ie(18, "erab_admitted_list", "ignore", ERAB_ADMITTED_LIST),
    Ie(123, "target_to_source_transparent_container", "reject", OctStr()),
)

HANDOVER_NOTIFY = ie_message(
    Ie(0, "mme_ue_s1ap_id", "reject", MME_UE_S1AP_ID),
    Ie(8, "enb_ue_s1ap_id", "reject", ENB_UE_S1AP_ID),
    Ie(100, "eutran_cgi", "ignore", EUTRAN_CGI),
    Ie(67, "tai", "ignore", TAI),
)

# procedure code → per-class message type (36.413 §9.1; elementary
# procedure registry, the analog of s1ap_elem_procs_o)
PROCEDURES = {
    ("init_msg", 0): ("ho_required", HANDOVER_REQUIRED),
    ("successful_outcome", 0): ("ho_cmd", HANDOVER_COMMAND),
    ("init_msg", 1): ("ho_request", HANDOVER_REQUEST),
    ("successful_outcome", 1): ("ho_request_ack", HANDOVER_REQUEST_ACKNOWLEDGE),
    ("init_msg", 2): ("ho_notify", HANDOVER_NOTIFY),
    ("init_msg", 9): ("init_context_setup_request", INITIAL_CONTEXT_SETUP_REQUEST),
    ("successful_outcome", 9): ("init_context_setup_response", INITIAL_CONTEXT_SETUP_RESPONSE),
    ("init_msg", 11): ("dl_nas_transport", DOWNLINK_NAS_TRANSPORT),
    ("init_msg", 12): ("init_ue_msg", INITIAL_UE_MESSAGE),
    ("init_msg", 13): ("ul_nas_transport", UPLINK_NAS_TRANSPORT),
    ("init_msg", 17): ("s1_setup_request", S1_SETUP_REQUEST),
    ("successful_outcome", 17): ("s1_setup_response", S1_SETUP_RESPONSE),
    ("unsuccessful_outcome", 17): ("s1_setup_failure", S1_SETUP_FAILURE),
    ("init_msg", 10): ("paging", PAGING),
    ("init_msg", 18): ("ue_context_release_request", UE_CONTEXT_RELEASE_REQUEST),
    ("init_msg", 23): ("ue_context_release_cmd", UE_CONTEXT_RELEASE_COMMAND),
    ("successful_outcome", 23): ("ue_context_release_complete", UE_CONTEXT_RELEASE_COMPLETE),
}
_BY_NAME = {name: (cls, code, typ) for (cls, code), (name, typ) in PROCEDURES.items()}
_CLASSES = ["init_msg", "successful_outcome", "unsuccessful_outcome"]

# default criticality per procedure code (36.413 §9.3.7 value assignments)
_PROC_CRIT = {0: "reject", 1: "reject", 2: "ignore", 9: "reject", 10: "ignore",
              11: "ignore", 12: "ignore", 13: "ignore", 17: "reject", 18: "ignore",
              23: "reject"}


class S1apPdu(Asn1Type):
    """S1AP-PDU ::= CHOICE {initiatingMessage, successfulOutcome,
    unsuccessfulOutcome} with {procedureCode, criticality, value(open)}.

    Value = (message_name, protocol_ies_dict), e.g.
    ("init_ue_msg", {"enb_ue_s1ap_id": 1, "nas_pdu": b"...", ...}).
    """

    def encode(self, w, value):
        name, ies = value
        cls, code, typ = _BY_NAME[name]
        w.put(0, 1)  # CHOICE extension bit
        put_constrained(w, _CLASSES.index(cls), 0, 2)
        put_constrained(w, code, 0, 255)
        put_constrained(w, CRITICALITY.index(_PROC_CRIT[code]), 0, 2)
        put_open_type(w, typ, {"protocol_ies": ies})

    def decode(self, r):
        if r.get(1):
            raise Asn1Error("extended S1AP-PDU class")
        cls = _CLASSES[get_constrained(r, 0, 2)]
        code = get_constrained(r, 0, 255)
        get_constrained(r, 0, 2)  # criticality
        entry = PROCEDURES.get((cls, code))
        if entry is None:
            octets = get_length(r)
            return (f"_unknown_{cls}_{code}", r.get_bytes(octets))
        name, typ = entry
        return (name, get_open_type(r, typ)["protocol_ies"])


S1AP_PDU = S1apPdu()


def pack(name: str, ies: dict) -> bytes:
    return S1AP_PDU.to_bytes((name, ies), aligned=True)


def unpack(data: bytes):
    return S1AP_PDU.from_bytes(data, aligned=True)
