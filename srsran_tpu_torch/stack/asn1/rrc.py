"""Host copy of `srsran_tpu/stack/asn1/rrc.py`, held to it by `tests/test_torch_stack.py`.

TS 36.331 RRC message schemas (UPER), hand-written on the per.py DSL.

Replaces the reference's generated `rrc_asn1.cc` (119 kLoC — SURVEY §2.2,
reference lib/src/asn1/rrc_asn1.cc) for the message subset the stack and
the conformance tests actually exercise: BCCH-BCH (MIB), BCCH-DL-SCH
(SIB1/SIB2...), DL-CCCH (connection setup/reject/re-establishment),
DL-DCCH (reconfiguration incl. handover, security mode command, release),
UL-CCCH / UL-DCCH (requests, complete messages, measurement reports) and
MCCH (MBSFNAreaConfiguration-r9).

Encodings are validated bit-exactly against the golden UPER vectors from
the reference's ASN.1 tests (lib/test/asn1/srslte_asn1_rrc_*.cc) in
tests/test_asn1_rrc.py.

Field names follow the reference's snake_case (cqi_pmi_cfg_idx, ...) so
parity with its test assertions is greppable.  Values are plain Python
data per per.py's value model.
"""

from .per import (
    BitStr,
    Bool,
    Choice,
    D,
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

# --------------------------------------------------------------- helpers


def setup_release(setup_type):
    """The 36.331 `CHOICE {release NULL, setup ...}` pattern."""
    return Choice([("release", Null()), ("setup", setup_type)])


def explicit_default(explicit_type):
    """`CHOICE {explicitValue X, defaultValue NULL}` pattern."""
    return Choice([("explicit_value", explicit_type), ("default_value", Null())])


def crit_ext_c1(name, r8_type, n_spares):
    """criticalExtensions CHOICE{c1 CHOICE{<name>-r8, spares}, future}."""
    return Choice(
        [
            ("c1", c1_spares([(name + "_r8", r8_type)], n_spares)),
            ("crit_exts_future", Seq([])),
        ]
    )


def crit_ext_c1_alt(alt_name, typ, n_spares):
    """Same c1+spares+future shell but with the alternative name given
    verbatim (r9/r10 messages whose IEs aren't named *-r8)."""
    return Choice(
        [
            ("c1", c1_spares([(alt_name, typ)], n_spares)),
            ("crit_exts_future", Seq([])),
        ]
    )


# ------------------------------------------------------------- RLC-Config

T_POLL_RETX = Enum(
    [f"ms{v}" for v in range(5, 251, 5)] + [f"ms{v}" for v in range(300, 501, 50)]
    + [f"spare{i}" for i in range(9, 0, -1)]
)
assert len(T_POLL_RETX.names) == 64
POLL_PDU = Enum(["p4", "p8", "p16", "p32", "p64", "p128", "p256", "pinfinity"])
POLL_BYTE = Enum(
    ["kb25", "kb50", "kb75", "kb100", "kb125", "kb250", "kb375", "kb500",
     "kb750", "kb1000", "kb1250", "kb1500", "kb2000", "kb3000", "kbinfinity", "spare1"]
)
MAX_RETX_THRES = Enum(["t1", "t2", "t3", "t4", "t6", "t8", "t16", "t32"])
T_REORDERING = Enum(
    [f"ms{v}" for v in range(0, 101, 5)] + [f"ms{v}" for v in range(110, 201, 10)]
    + ["ms1600_v1310"]
)
assert len(T_REORDERING.names) == 32
T_STATUS_PROHIBIT = Enum(
    [f"ms{v}" for v in range(0, 251, 5)] + [f"ms{v}" for v in range(300, 501, 50)]
    + [f"spare{i}" for i in range(8, 0, -1)]
)
assert len(T_STATUS_PROHIBIT.names) == 64
SN_FIELD_LEN = Enum(["size5", "size10"])

UL_AM_RLC = Seq(
    [
        M("t_poll_retx", T_POLL_RETX),
        M("poll_pdu", POLL_PDU),
        M("poll_byte", POLL_BYTE),
        M("max_retx_thres", MAX_RETX_THRES),
    ]
)
DL_AM_RLC = Seq([M("t_reordering", T_REORDERING), M("t_status_prohibit", T_STATUS_PROHIBIT)])
UL_UM_RLC = Seq([M("sn_field_len", SN_FIELD_LEN)])
DL_UM_RLC = Seq([M("sn_field_len", SN_FIELD_LEN), M("t_reordering", T_REORDERING)])

RLC_CONFIG = Choice(
    [
        ("am", Seq([M("ul_am_rlc", UL_AM_RLC), M("dl_am_rlc", DL_AM_RLC)])),
        ("um_bi_dir", Seq([M("ul_um_rlc", UL_UM_RLC), M("dl_um_rlc", DL_UM_RLC)])),
        ("um_uni_dir_ul", Seq([M("ul_um_rlc", UL_UM_RLC)])),
        ("um_uni_dir_dl", Seq([M("dl_um_rlc", DL_UM_RLC)])),
    ],
    ext=True,
)

# --------------------------------------------------- LogicalChannelConfig

PRIORITISED_BIT_RATE = Enum(
    ["kbps0", "kbps8", "kbps16", "kbps32", "kbps64", "kbps128", "kbps256", "infinity",
     "kbps512_v1020", "kbps1024_v1020", "kbps2048_v1020", "spare5", "spare4", "spare3",
     "spare2", "spare1"]
)
BUCKET_SIZE_DUR = Enum(["ms50", "ms100", "ms150", "ms300", "ms500", "ms1000", "spare2", "spare1"])

LOGICAL_CHANNEL_CONFIG = Seq(
    [
        O(
            "ul_specific_params",
            Seq(
                [
                    M("prio", Int(1, 16)),
                    M("prioritised_bit_rate", PRIORITISED_BIT_RATE),
                    M("bucket_size_dur", BUCKET_SIZE_DUR),
                    O("lc_ch_group", Int(0, 3)),
                ]
            ),
        ),
    ],
    ext=True,
    ext_additions=[
        M("lc_ch_sr_mask_r9", Enum(["setup"])),
        M("lc_ch_sr_prohibit_r12", Bool()),
    ],
)

# -------------------------------------------------------------- PDCP-Config

DISCARD_TIMER = Enum(["ms50", "ms100", "ms150", "ms300", "ms500", "ms750", "ms1500", "infinity"])

ROHC_PROFILES = Seq(
    [
        M("profile0x0001", Bool()),
        M("profile0x0002", Bool()),
        M("profile0x0003", Bool()),
        M("profile0x0004", Bool()),
        M("profile0x0006", Bool()),
        M("profile0x0101", Bool()),
        M("profile0x0102", Bool()),
        M("profile0x0103", Bool()),
        M("profile0x0104", Bool()),
    ]
)

HEADER_COMPRESSION = Choice(
    [
        ("not_used", Null()),
        ("rohc", Seq([D("max_cid", Int(1, 16383), 15), M("profiles", ROHC_PROFILES)], ext=True)),
    ]
)

PDCP_CONFIG = Seq(
    [
        O("discard_timer", DISCARD_TIMER),
        O("rlc_am", Seq([M("status_report_required", Bool())])),
        O("rlc_um", Seq([M("pdcp_sn_size", Enum(["len7bits", "len12bits"]))])),
        M("hdr_compress", HEADER_COMPRESSION),
    ],
    ext=True,
    ext_additions=[
        M("rn_integrity_protection_r10", Enum(["enabled"])),
        M("pdcp_sn_size_v1130", Enum(["len15bits"])),
    ],
)

# ----------------------------------------------------------- MAC-MainConfig

MAX_HARQ_TX = Enum(
    ["n1", "n2", "n3", "n4", "n5", "n6", "n7", "n8", "n10", "n12", "n16", "n20",
     "n24", "n28", "spare2", "spare1"]
)
PERIODIC_BSR_TIMER = Enum(
    ["sf5", "sf10", "sf16", "sf20", "sf32", "sf40", "sf64", "sf80", "sf128",
     "sf160", "sf320", "sf640", "sf1280", "sf2560", "infinity", "spare1"]
)
RETX_BSR_TIMER = Enum(["sf320", "sf640", "sf1280", "sf2560", "sf5120", "sf10240", "spare2", "spare1"])
TIME_ALIGN_TIMER = Enum(["sf500", "sf750", "sf1280", "sf1920", "sf2560", "sf5120", "sf10240", "infinity"])

ON_DUR_TIMER = Enum(
    ["psf1", "psf2", "psf3", "psf4", "psf5", "psf6", "psf8", "psf10", "psf20",
     "psf30", "psf40", "psf50", "psf60", "psf80", "psf100", "psf200"]
)
DRX_INACTIVITY_TIMER = Enum(
    ["psf1", "psf2", "psf3", "psf4", "psf5", "psf6", "psf8", "psf10", "psf20",
     "psf30", "psf40", "psf50", "psf60", "psf80", "psf100", "psf200", "psf300",
     "psf500", "psf750", "psf1280", "psf1920", "psf2560", "psf0_v1020",
     "spare9", "spare8", "spare7", "spare6", "spare5", "spare4", "spare3",
     "spare2", "spare1"]
)
DRX_RETX_TIMER = Enum(["psf1", "psf2", "psf4", "psf6", "psf8", "psf16", "psf24", "psf33"])
SHORT_DRX_CYCLE = Enum(
    ["sf2", "sf5", "sf8", "sf10", "sf16", "sf20", "sf32", "sf40", "sf64",
     "sf80", "sf128", "sf160", "sf256", "sf320", "sf512", "sf640"]
)
LONG_DRX_CYCLE_START_OFFSET = Choice(
    [(f"sf{n}", Int(0, n - 1)) for n in (10, 20, 32, 40, 64, 80, 128, 160, 256, 320, 512, 640, 1024, 1280, 2048, 2560)]
)

DRX_CONFIG = setup_release(
    Seq(
        [
            M("on_dur_timer", ON_DUR_TIMER),
            M("drx_inactivity_timer", DRX_INACTIVITY_TIMER),
            M("drx_retx_timer", DRX_RETX_TIMER),
            M("long_drx_cycle_start_offset", LONG_DRX_CYCLE_START_OFFSET),
            O("short_drx", Seq([M("short_drx_cycle", SHORT_DRX_CYCLE), M("drx_short_cycle_timer", Int(1, 16))])),
        ]
    )
)

PHR_CONFIG = setup_release(
    Seq(
        [
            M("periodic_phr_timer", Enum(["sf10", "sf20", "sf50", "sf100", "sf200", "sf500", "sf1000", "infinity"])),
            M("prohibit_phr_timer", Enum(["sf0", "sf10", "sf20", "sf50", "sf100", "sf200", "sf500", "sf1000"])),
            M("dl_pathloss_change", Enum(["db1", "db3", "db6", "infinity"])),
        ]
    )
)

MAC_MAIN_CONFIG = Seq(
    [
        O(
            "ul_sch_cfg",
            Seq(
                [
                    O("max_harq_tx", MAX_HARQ_TX),
                    O("periodic_bsr_timer", PERIODIC_BSR_TIMER),
                    M("retx_bsr_timer", RETX_BSR_TIMER),
                    M("tti_bundling", Bool()),
                ]
            ),
        ),
        O("drx_cfg", DRX_CONFIG),
        M("time_align_timer_ded", TIME_ALIGN_TIMER),
        O("phr_cfg", PHR_CONFIG),
    ],
    ext=True,
    ext_additions=[
        M("sr_prohibit_timer_r9", Int(0, 7)),
    ],
)

# --------------------------------------------------------------- SPS-Config

SPS_INTERVAL = Enum(
    ["sf10", "sf20", "sf32", "sf40", "sf64", "sf80", "sf128", "sf160", "sf320",
     "sf640", "spare6", "spare5", "spare4", "spare3", "spare2", "spare1"]
)

SPS_CONFIG_DL = setup_release(
    Seq(
        [
            M("semi_persist_sched_interv_dl", SPS_INTERVAL),
            M("nof_conf_sps_processes", Int(1, 8)),
            M("n1_pucch_an_persistent_list", SeqOf(Int(0, 2047), 1, 4)),
        ],
        ext=True,
    )
)

SPS_CONFIG_UL = setup_release(
    Seq(
        [
            M("semi_persist_sched_interv_ul", SPS_INTERVAL),
            M("implicit_release_after", Enum(["e2", "e3", "e4", "e8"])),
            O(
                "p0_persistent",
                Seq([M("p0_nominal_pusch_persistent", Int(-126, 24)), M("p0_ue_pusch_persistent", Int(-8, 7))]),
            ),
            O("two_intervals_cfg", Enum(["true_value"])),
        ],
        ext=True,
    )
)

SPS_CONFIG = Seq(
    [
        O("semi_persist_sched_c_rnti", BitStr(16)),
        O("sps_cfg_dl", SPS_CONFIG_DL),
        O("sps_cfg_ul", SPS_CONFIG_UL),
    ]
)

# ------------------------------------------------- PhysicalConfigDedicated

PDSCH_CONFIG_DEDICATED = Seq(
    [M("p_a", Enum(["db_minus6", "db_minus4dot77", "db_minus3", "db_minus1dot77", "db0", "db1", "db2", "db3"]))]
)

PUCCH_CONFIG_DEDICATED = Seq(
    [
        M(
            "ack_nack_repeat",
            setup_release(
                Seq([M("repeat_factor", Enum(["n2", "n4", "n6", "spare1"])), M("n1_pucch_an_rep", Int(0, 2047))])
            ),
        ),
        O("tdd_ack_nack_feedback_mode", Enum(["bundling", "mux"])),
    ]
)

PUSCH_CONFIG_DEDICATED = Seq(
    [
        M("beta_offset_ack_idx", Int(0, 15)),
        M("beta_offset_ri_idx", Int(0, 15)),
        M("beta_offset_cqi_idx", Int(0, 15)),
    ]
)

FILTER_COEFFICIENT = Enum(
    ["fc0", "fc1", "fc2", "fc3", "fc4", "fc5", "fc6", "fc7", "fc8", "fc9",
     "fc11", "fc13", "fc15", "fc17", "fc19", "spare1"],
    ext=True,
)

UL_POWER_CONTROL_DEDICATED = Seq(
    [
        M("p0_ue_pusch", Int(-8, 7)),
        M("delta_mcs_enabled", Enum(["en0", "en1"])),
        M("accumulation_enabled", Bool()),
        M("p0_ue_pucch", Int(-8, 7)),
        M("psrs_offset", Int(0, 15)),
        D("filt_coef", FILTER_COEFFICIENT, "fc4"),
    ]
)

TPC_PDCCH_CONFIG = setup_release(
    Seq(
        [
            M("tpc_rnti", BitStr(16)),
            M("tpc_idx", Choice([("idx_of_format3", Int(1, 15)), ("idx_of_format3a", Int(1, 31))])),
        ]
    )
)

CQI_REPORT_PERIODIC = setup_release(
    Seq(
        [
            M("cqi_pucch_res_idx", Int(0, 1185)),
            M("cqi_pmi_cfg_idx", Int(0, 1023)),
            M(
                "cqi_format_ind_periodic",
                Choice([("wideband_cqi", Null()), ("subband_cqi", Seq([M("k", Int(1, 4))]))]),
            ),
            O("ri_cfg_idx", Int(0, 1023)),
            M("simul_ack_nack_and_cqi", Bool()),
        ]
    )
)

CQI_REPORT_CONFIG = Seq(
    [
        O(
            "cqi_report_mode_aperiodic",
            Enum(["rm12", "rm20", "rm22", "rm30", "rm31", "rm32_v1250", "rm10_v1310", "rm11_v1310"]),
        ),
        M("nom_pdsch_rs_epre_offset", Int(-1, 6)),
        O("cqi_report_periodic", CQI_REPORT_PERIODIC),
    ]
)

SRS_UL_CONFIG_DEDICATED = setup_release(
    Seq(
        [
            M("srs_bw", Enum(["bw0", "bw1", "bw2", "bw3"])),
            M("srs_hop_bw", Enum(["hbw0", "hbw1", "hbw2", "hbw3"])),
            M("freq_domain_position", Int(0, 23)),
            M("dur", Bool()),
            M("srs_cfg_idx", Int(0, 1023)),
            M("tx_comb", Int(0, 1)),
            M("cyclic_shift", Enum(["cs0", "cs1", "cs2", "cs3", "cs4", "cs5", "cs6", "cs7"])),
        ]
    )
)

ANTENNA_INFO_DEDICATED = Seq(
    [
        M("tx_mode", Enum(["tm1", "tm2", "tm3", "tm4", "tm5", "tm6", "tm7", "tm8_v920"])),
        O(
            "codebook_subset_restrict",
            Choice(
                [
                    ("n2_tx_ant_tm3", BitStr(2)),
                    ("n4_tx_ant_tm3", BitStr(4)),
                    ("n2_tx_ant_tm4", BitStr(6)),
                    ("n4_tx_ant_tm4", BitStr(64)),
                    ("n2_tx_ant_tm5", BitStr(4)),
                    ("n4_tx_ant_tm5", BitStr(16)),
                    ("n2_tx_ant_tm6", BitStr(4)),
                    ("n4_tx_ant_tm6", BitStr(16)),
                ]
            ),
        ),
        M("ue_tx_ant_sel", setup_release(Enum(["closed_loop", "open_loop"]))),
    ]
)

SCHEDULING_REQUEST_CONFIG = setup_release(
    Seq(
        [
            M("sr_pucch_res_idx", Int(0, 2047)),
            M("sr_cfg_idx", Int(0, 157)),
            M("dsr_trans_max", Enum(["n4", "n8", "n16", "n32", "n64", "spare3", "spare2", "spare1"])),
        ]
    )
)

PHYSICAL_CONFIG_DEDICATED = Seq(
    [
        O("pdsch_cfg_ded", PDSCH_CONFIG_DEDICATED),
        O("pucch_cfg_ded", PUCCH_CONFIG_DEDICATED),
        O("pusch_cfg_ded", PUSCH_CONFIG_DEDICATED),
        O("ul_pwr_ctrl_ded", UL_POWER_CONTROL_DEDICATED),
        O("tpc_pdcch_cfg_pucch", TPC_PDCCH_CONFIG),
        O("tpc_pdcch_cfg_pusch", TPC_PDCCH_CONFIG),
        O("cqi_report_cfg", CQI_REPORT_CONFIG),
        O("srs_ul_cfg_ded", SRS_UL_CONFIG_DEDICATED),
        O("ant_info", explicit_default(ANTENNA_INFO_DEDICATED)),
        O("sched_request_cfg", SCHEDULING_REQUEST_CONFIG),
    ],
    ext=True,
)

# ------------------------------------------- RadioResourceConfigDedicated

SRB_TO_ADD_MOD = Seq(
    [
        M("srb_id", Int(1, 2)),
        O("rlc_cfg", explicit_default(RLC_CONFIG)),
        O("lc_ch_cfg", explicit_default(LOGICAL_CHANNEL_CONFIG)),
    ],
    ext=True,
)

DRB_TO_ADD_MOD = Seq(
    [
        O("eps_bearer_id", Int(0, 15)),
        M("drb_id", Int(1, 32)),
        O("pdcp_cfg", PDCP_CONFIG),
        O("rlc_cfg", RLC_CONFIG),
        O("lc_ch_id", Int(3, 10)),
        O("lc_ch_cfg", LOGICAL_CHANNEL_CONFIG),
    ],
    ext=True,
)

RLF_TIMERS_AND_CONSTANTS_R9 = setup_release(
    Seq(
        [
            M("t301_r9", Enum(["ms100", "ms200", "ms300", "ms400", "ms600", "ms1000", "ms1500", "ms2000"])),
            M("t310_r9", Enum(["ms0", "ms50", "ms100", "ms200", "ms500", "ms1000", "ms2000"])),
            M("n310_r9", Enum(["n1", "n2", "n3", "n4", "n6", "n8", "n10", "n20"])),
            M("t311_r9", Enum(["ms1000", "ms3000", "ms5000", "ms10000", "ms15000", "ms20000", "ms30000"])),
            M("n311_r9", Enum(["n1", "n2", "n3", "n4", "n5", "n6", "n8", "n10"])),
        ],
        ext=True,
    )
)

RADIO_RESOURCE_CONFIG_DEDICATED = Seq(
    [
        O("srb_to_add_mod_list", SeqOf(SRB_TO_ADD_MOD, 1, 2)),
        O("drb_to_add_mod_list", SeqOf(DRB_TO_ADD_MOD, 1, 11)),
        O("drb_to_release_list", SeqOf(Int(1, 32), 1, 11)),
        O("mac_main_cfg", explicit_default(MAC_MAIN_CONFIG)),
        O("sps_cfg", SPS_CONFIG),
        O("phys_cfg_ded", PHYSICAL_CONFIG_DEDICATED),
    ],
    ext=True,
    ext_additions=[
        M("rlf_timers_and_consts_r9", RLF_TIMERS_AND_CONSTANTS_R9),
    ],
)

# --------------------------------------------------------- DL-CCCH messages

RRC_CONN_SETUP = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1(
                "rrc_conn_setup",
                Seq(
                    [
                        M("rr_cfg_ded", RADIO_RESOURCE_CONFIG_DEDICATED),
                        O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])),
                    ]
                ),
                7,
            ),
        ),
    ]
)

RRC_CONN_REJECT = Seq(
    [
        M(
            "crit_exts",
            crit_ext_c1(
                "rrc_conn_reject",
                Seq([M("wait_time", Int(1, 16)), O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))]))]),
                3,
            ),
        ),
    ]
)

RRC_CONN_REEST = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1(
                "rrc_conn_reest",
                Seq(
                    [
                        M("rr_cfg_ded", RADIO_RESOURCE_CONFIG_DEDICATED),
                        M("next_hop_chaining_count", Int(0, 7)),
                        O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])),
                    ]
                ),
                7,
            ),
        ),
    ]
)

RRC_CONN_REEST_REJECT = Seq(
    [
        M(
            "crit_exts",
            Choice(
                [
                    (
                        "rrc_conn_reest_reject_r8",
                        Seq([O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))]))]),
                    ),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        ),
    ]
)

DL_CCCH_MESSAGE = Seq(
    [
        M(
            "msg",
            Choice(
                [
                    (
                        "c1",
                        Choice(
                            [
                                ("rrc_conn_reest", RRC_CONN_REEST),
                                ("rrc_conn_reest_reject", RRC_CONN_REEST_REJECT),
                                ("rrc_conn_reject", RRC_CONN_REJECT),
                                ("rrc_conn_setup", RRC_CONN_SETUP),
                            ]
                        ),
                    ),
                    ("msg_class_ext", Seq([])),
                ]
            ),
        )
    ]
)

# ----------------------------------------------------------------- MIB/BCCH

MIB = Seq(
    [
        M("dl_bw", Enum(["n6", "n15", "n25", "n50", "n75", "n100"])),
        M(
            "phich_cfg",
            Seq(
                [
                    M("phich_dur", Enum(["normal", "extended"])),
                    M("phich_res", Enum(["one_sixth", "half", "one", "two"])),
                ]
            ),
        ),
        M("sys_frame_num", BitStr(8)),
        M("sched_info_sib1_br_r13", Int(0, 31)),
        M("sys_info_unchanged_br_r15", Bool()),
        M("spare", BitStr(4)),
    ]
)

BCCH_BCH_MESSAGE = Seq([M("msg", MIB)])

# ======================================================================
# Common configuration (HO variant) — RadioResourceConfigCommon tree
# ======================================================================

PHICH_CONFIG = Seq(
    [
        M("phich_dur", Enum(["normal", "extended"])),
        M("phich_res", Enum(["one_sixth", "half", "one", "two"])),
    ]
)

RACH_CONFIG_COMMON = Seq(
    [
        M(
            "preamb_info",
            Seq(
                [
                    M("nof_ra_preambs", Enum([f"n{v}" for v in range(4, 65, 4)])),
                    O(
                        "preambs_group_a_cfg",
                        Seq(
                            [
                                M("size_of_ra_preambs_group_a", Enum([f"n{v}" for v in range(4, 61, 4)])),
                                M("msg_size_group_a", Enum(["b56", "b144", "b208", "b256"])),
                                M(
                                    "msg_pwr_offset_group_b",
                                    Enum(["minusinfinity", "db0", "db5", "db8", "db10", "db12", "db15", "db18"]),
                                ),
                            ],
                            ext=True,
                        ),
                    ),
                ]
            ),
        ),
        M(
            "pwr_ramp_params",
            Seq(
                [
                    M("pwr_ramp_step", Enum(["db0", "db2", "db4", "db6"])),
                    M(
                        "preamb_init_rx_target_pwr",
                        Enum([f"dbm_minus{v}" for v in range(120, 89, -2)]),
                    ),
                ]
            ),
        ),
        M(
            "ra_supervision_info",
            Seq(
                [
                    M(
                        "preamb_trans_max",
                        Enum(["n3", "n4", "n5", "n6", "n7", "n8", "n10", "n20", "n50", "n100", "n200"]),
                    ),
                    M("ra_resp_win_size", Enum(["sf2", "sf3", "sf4", "sf5", "sf6", "sf7", "sf8", "sf10"])),
                    M(
                        "mac_contention_resolution_timer",
                        Enum(["sf8", "sf16", "sf24", "sf32", "sf40", "sf48", "sf56", "sf64"]),
                    ),
                ]
            ),
        ),
        M("max_harq_msg3_tx", Int(1, 8)),
    ],
    ext=True,
)

PRACH_CONFIG_INFO = Seq(
    [
        M("prach_cfg_idx", Int(0, 63)),
        M("high_speed_flag", Bool()),
        M("zero_correlation_zone_cfg", Int(0, 15)),
        M("prach_freq_offset", Int(0, 94)),
    ]
)

PRACH_CONFIG = Seq([M("root_seq_idx", Int(0, 837)), O("prach_cfg_info", PRACH_CONFIG_INFO)])
PRACH_CONFIG_SIB = Seq([M("root_seq_idx", Int(0, 837)), M("prach_cfg_info", PRACH_CONFIG_INFO)])

PDSCH_CONFIG_COMMON = Seq([M("ref_sig_pwr", Int(-60, 50)), M("p_b", Int(0, 3))])

PUSCH_CONFIG_COMMON = Seq(
    [
        M(
            "pusch_cfg_basic",
            Seq(
                [
                    M("n_sb", Int(1, 4)),
                    M("hop_mode", Enum(["inter_sub_frame", "intra_and_inter_sub_frame"])),
                    M("pusch_hop_offset", Int(0, 98)),
                    M("enable64_qam", Bool()),
                ]
            ),
        ),
        M(
            "ul_ref_sigs_pusch",
            Seq(
                [
                    M("group_hop_enabled", Bool()),
                    M("group_assign_pusch", Int(0, 29)),
                    M("seq_hop_enabled", Bool()),
                    M("cyclic_shift", Int(0, 7)),
                ]
            ),
        ),
    ]
)

PUCCH_CONFIG_COMMON = Seq(
    [
        M("delta_pucch_shift", Enum(["ds1", "ds2", "ds3"])),
        M("nrb_cqi", Int(0, 98)),
        M("ncs_an", Int(0, 7)),
        M("n1_pucch_an", Int(0, 2047)),
    ]
)

SRS_UL_CONFIG_COMMON = setup_release(
    Seq(
        [
            M("srs_bw_cfg", Enum([f"bw{i}" for i in range(8)])),
            M("srs_sf_cfg", Enum([f"sc{i}" for i in range(16)])),
            M("ack_nack_srs_simul_tx", Bool()),
            O("srs_max_up_pts", Enum(["true_value"])),
        ]
    )
)

UL_POWER_CONTROL_COMMON = Seq(
    [
        M("p0_nominal_pusch", Int(-126, 24)),
        M("alpha", Enum(["al0", "al04", "al05", "al06", "al07", "al08", "al09", "al1"])),
        M("p0_nominal_pucch", Int(-127, -96)),
        M(
            "delta_flist_pucch",
            Seq(
                [
                    M("delta_f_pucch_format1", Enum(["delta_f_minus2", "delta_f0", "delta_f2"])),
                    M("delta_f_pucch_format1b", Enum(["delta_f1", "delta_f3", "delta_f5"])),
                    M("delta_f_pucch_format2", Enum(["delta_f_minus2", "delta_f0", "delta_f1", "delta_f2"])),
                    M("delta_f_pucch_format2a", Enum(["delta_f_minus2", "delta_f0", "delta_f2"])),
                    M("delta_f_pucch_format2b", Enum(["delta_f_minus2", "delta_f0", "delta_f2"])),
                ]
            ),
        ),
        M("delta_preamb_msg3", Int(-1, 6)),
    ]
)

ANTENNA_INFO_COMMON = Seq([M("ant_ports_count", Enum(["an1", "an2", "an4", "spare1"]))])

TDD_CONFIG = Seq(
    [
        M("sf_assign", Enum([f"sa{i}" for i in range(7)])),
        M("special_sf_patterns", Enum([f"ssp{i}" for i in range(9)])),
    ]
)

RADIO_RESOURCE_CONFIG_COMMON = Seq(
    [
        O("rach_cfg_common", RACH_CONFIG_COMMON),
        M("prach_cfg", PRACH_CONFIG),
        O("pdsch_cfg_common", PDSCH_CONFIG_COMMON),
        M("pusch_cfg_common", PUSCH_CONFIG_COMMON),
        O("phich_cfg", PHICH_CONFIG),
        O("pucch_cfg_common", PUCCH_CONFIG_COMMON),
        O("srs_ul_cfg_common", SRS_UL_CONFIG_COMMON),
        O("ul_pwr_ctrl_common", UL_POWER_CONTROL_COMMON),
        O("ant_info_common", ANTENNA_INFO_COMMON),
        O("p_max", Int(-30, 33)),
        O("tdd_cfg", TDD_CONFIG),
        M("ul_cp_len", Enum(["len1", "len2"])),
    ],
    ext=True,
)

# ======================================================================
# Measurement configuration & results (36.331 §5.5 / §6.3.5)
# ======================================================================

Q_OFFSET_RANGE = Enum(
    ["db_minus24", "db_minus22", "db_minus20", "db_minus18", "db_minus16", "db_minus14",
     "db_minus12", "db_minus10", "db_minus8", "db_minus6", "db_minus5", "db_minus4",
     "db_minus3", "db_minus2", "db_minus1", "db0", "db1", "db2", "db3", "db4", "db5",
     "db6", "db8", "db10", "db12", "db14", "db16", "db18", "db20", "db22", "db24"]
)
assert len(Q_OFFSET_RANGE.names) == 31

PHYS_CELL_ID = Int(0, 503)
ARFCN = Int(0, 65535)
CELL_INDEX_LIST = SeqOf(Int(1, 32), 1, 32)

CELLS_TO_ADD_MOD = Seq(
    [
        M("cell_idx", Int(1, 32)),
        M("pci", PHYS_CELL_ID),
        M("cell_individual_offset", Q_OFFSET_RANGE),
    ]
)

PHYS_CELL_ID_RANGE = Seq(
    [
        M("start", PHYS_CELL_ID),
        O(
            "range",
            Enum(["n4", "n8", "n12", "n16", "n24", "n32", "n48", "n64", "n84", "n96",
                  "n128", "n168", "n252", "n504", "spare2", "spare1"]),
        ),
    ]
)

BLACK_CELLS_TO_ADD_MOD = Seq([M("cell_idx", Int(1, 32)), M("pci_range", PHYS_CELL_ID_RANGE)])

# ------------------------------------------------ inter-RAT primitives
# (TS 36.331 §6.3.4/§6.3.1; reference rrc_asn1.cc carrier_freqs_geran_s,
# carrier_freq_cdma2000_s, cell_global_id_*_s, bandclass_cdma2000_opts)

PHYS_CELL_ID_UTRA_FDD = Int(0, 511)
PHYS_CELL_ID_UTRA_TDD = Int(0, 127)
PHYS_CELL_ID_GERAN = Seq(
    [M("network_colour_code", BitStr(3)), M("base_station_colour_code", BitStr(3))]
)
PHYS_CELL_ID_CDMA2000 = Int(0, 511)
ARFCN_VALUE_UTRA = Int(0, 16383)
ARFCN_VALUE_GERAN = Int(0, 1023)
ARFCN_VALUE_CDMA2000 = Int(0, 2047)
BAND_INDICATOR_GERAN = Enum(["dcs1800", "pcs1900"])
CDMA2000_TYPE = Enum(["type1_xrtt", "type_hrpd"])

BANDCLASS_CDMA2000 = Enum(
    [f"bc{i}" for i in range(18)] + [f"spare{i}" for i in range(14, 0, -1)],
    ext=True,
)
assert len(BANDCLASS_CDMA2000.names) == 32

CARRIER_FREQ_CDMA2000 = Seq(
    [M("band_class", BANDCLASS_CDMA2000), M("arfcn", ARFCN_VALUE_CDMA2000)]
)

CARRIER_FREQ_GERAN = Seq(
    [M("arfcn", ARFCN_VALUE_GERAN), M("band_ind", BAND_INDICATOR_GERAN)]
)

CARRIER_FREQS_GERAN = Seq(
    [
        M("start_arfcn", ARFCN_VALUE_GERAN),
        M("band_ind", BAND_INDICATOR_GERAN),
        M(
            "following_arfcns",
            Choice(
                [
                    ("explicit_list_of_arfcns", SeqOf(ARFCN_VALUE_GERAN, 0, 31)),
                    (
                        "equally_spaced_arfcns",
                        Seq(
                            [
                                M("arfcn_spacing", Int(1, 8)),
                                M("nof_following_arfcns", Int(0, 31)),
                            ]
                        ),
                    ),
                    # SIZE(1..16) in the spec; reference encodes
                    # unconstrained (dyn_octstring)
                    ("variable_bit_map_of_arfcns", OctStr()),
                ]
            ),
        ),
    ]
)

CELL_GLOBAL_ID_CDMA2000 = Choice(
    [("cell_global_id1_xrtt", BitStr(47)), ("cell_global_id_hrpd", BitStr(128))]
)

MEAS_OBJECT_EUTRA = Seq(
    [
        M("carrier_freq", ARFCN),
        M("allowed_meas_bw", Enum(["mbw6", "mbw15", "mbw25", "mbw50", "mbw75", "mbw100"])),
        M("presence_ant_port1", Bool()),
        M("neigh_cell_cfg", BitStr(2)),
        D("offset_freq", Q_OFFSET_RANGE, "db0"),
        O("cells_to_rem_list", CELL_INDEX_LIST),
        O("cells_to_add_mod_list", SeqOf(CELLS_TO_ADD_MOD, 1, 32)),
        O("black_cells_to_rem_list", CELL_INDEX_LIST),
        O("black_cells_to_add_mod_list", SeqOf(BLACK_CELLS_TO_ADD_MOD, 1, 32)),
        O("cell_for_which_to_report_cgi", PHYS_CELL_ID),
    ],
    ext=True,
)

# MeasObjectUTRA / GERAN / CDMA2000 (TS 36.331 §6.3.5; reference
# rrc_asn1.cc meas_obj_utra_s / meas_obj_geran_s / meas_obj_cdma2000_s)

MEAS_OBJECT_UTRA = Seq(
    [
        M("carrier_freq", ARFCN_VALUE_UTRA),
        D("offset_freq", Int(-15, 15), 0),
        O("cells_to_rem_list", CELL_INDEX_LIST),
        O(
            "cells_to_add_mod_list",
            Choice(
                [
                    (
                        "cells_to_add_mod_list_utra_fdd",
                        SeqOf(Seq([M("cell_idx", Int(1, 32)),
                                   M("pci", PHYS_CELL_ID_UTRA_FDD)]), 1, 32),
                    ),
                    (
                        "cells_to_add_mod_list_utra_tdd",
                        SeqOf(Seq([M("cell_idx", Int(1, 32)),
                                   M("pci", PHYS_CELL_ID_UTRA_TDD)]), 1, 32),
                    ),
                ]
            ),
        ),
        O(
            "cell_for_which_to_report_cgi",
            Choice([("utra_fdd", PHYS_CELL_ID_UTRA_FDD),
                    ("utra_tdd", PHYS_CELL_ID_UTRA_TDD)]),
        ),
    ],
    ext=True,
)

MEAS_OBJECT_GERAN = Seq(
    [
        M("carrier_freqs", CARRIER_FREQS_GERAN),
        D("offset_freq", Int(-15, 15), 0),
        D("ncc_permitted", BitStr(8), 0b11111111),
        O("cell_for_which_to_report_cgi", PHYS_CELL_ID_GERAN),
    ],
    ext=True,
)

MEAS_OBJECT_CDMA2000 = Seq(
    [
        M("cdma2000_type", CDMA2000_TYPE),
        M("carrier_freq", CARRIER_FREQ_CDMA2000),
        O("search_win_size", Int(0, 15)),
        D("offset_freq", Int(-15, 15), 0),
        O("cells_to_rem_list", CELL_INDEX_LIST),
        O(
            "cells_to_add_mod_list",
            SeqOf(Seq([M("cell_idx", Int(1, 32)),
                       M("pci", PHYS_CELL_ID_CDMA2000)]), 1, 32),
        ),
        O("cell_for_which_to_report_cgi", PHYS_CELL_ID_CDMA2000),
    ],
    ext=True,
)

MEAS_OBJECT_TO_ADD_MOD = Seq(
    [
        M("meas_obj_id", Int(1, 32)),
        M(
            "meas_obj",
            Choice(
                [
                    ("meas_obj_eutra", MEAS_OBJECT_EUTRA),
                    ("meas_obj_utra", MEAS_OBJECT_UTRA),
                    ("meas_obj_geran", MEAS_OBJECT_GERAN),
                    ("meas_obj_cdma2000", MEAS_OBJECT_CDMA2000),
                ],
                ext=True,
            ),
        ),
    ]
)

THRESHOLD_EUTRA = Choice([("thres_rsrp", Int(0, 97)), ("thres_rsrq", Int(0, 34))])
TIME_TO_TRIGGER = Enum(
    ["ms0", "ms40", "ms64", "ms80", "ms100", "ms128", "ms160", "ms256", "ms320",
     "ms480", "ms512", "ms640", "ms1024", "ms1280", "ms2560", "ms5120"]
)

REPORT_CONFIG_EUTRA = Seq(
    [
        M(
            "trigger_type",
            Choice(
                [
                    (
                        "event",
                        Seq(
                            [
                                M(
                                    "event_id",
                                    Choice(
                                        [
                                            ("event_a1", Seq([M("a1_thres", THRESHOLD_EUTRA)])),
                                            ("event_a2", Seq([M("a2_thres", THRESHOLD_EUTRA)])),
                                            (
                                                "event_a3",
                                                Seq([M("a3_offset", Int(-30, 30)), M("report_on_leave", Bool())]),
                                            ),
                                            ("event_a4", Seq([M("a4_thres", THRESHOLD_EUTRA)])),
                                            (
                                                "event_a5",
                                                Seq([M("a5_thres1", THRESHOLD_EUTRA), M("a5_thres2", THRESHOLD_EUTRA)]),
                                            ),
                                        ],
                                        ext=True,
                                        ext_alts=[
                                            ("event_a6_r10", Seq([M("a6_offset_r10", Int(-30, 30)), M("a6_report_on_leave_r10", Bool())])),
                                        ],
                                    ),
                                ),
                                M("hysteresis", Int(0, 30)),
                                M("time_to_trigger", TIME_TO_TRIGGER),
                            ]
                        ),
                    ),
                    (
                        "periodical",
                        Seq([M("purpose", Enum(["report_strongest_cells", "report_cgi"]))]),
                    ),
                ]
            ),
        ),
        M("trigger_quant", Enum(["rsrp", "rsrq"])),
        M("report_quant", Enum(["same_as_trigger_quant", "both"])),
        M("max_report_cells", Int(1, 8)),
        M(
            "report_interv",
            Enum(["ms120", "ms240", "ms480", "ms640", "ms1024", "ms2048", "ms5120", "ms10240",
                  "min1", "min6", "min12", "min30", "min60", "spare3", "spare2", "spare1"]),
        ),
        M("report_amount", Enum(["r1", "r2", "r4", "r8", "r16", "r32", "r64", "infinity"])),
    ],
    ext=True,
)

# ReportConfigInterRAT (TS 36.331 §6.3.5; reference rrc_asn1.cc
# report_cfg_inter_rat_s — events b1/b2 with per-RAT thresholds)

THRESHOLD_UTRA = Choice([("utra_rscp", Int(-5, 91)), ("utra_ec_n0", Int(0, 49))])
THRESHOLD_GERAN = Int(0, 63)
THRESHOLD_CDMA2000 = Int(0, 63)

_B_THRES_INTER_RAT = Choice(
    [
        ("b1_thres_utra", THRESHOLD_UTRA),
        ("b1_thres_geran", THRESHOLD_GERAN),
        ("b1_thres_cdma2000", THRESHOLD_CDMA2000),
    ]
)
_B2_THRES2_INTER_RAT = Choice(
    [
        ("b2_thres2_utra", THRESHOLD_UTRA),
        ("b2_thres2_geran", THRESHOLD_GERAN),
        ("b2_thres2_cdma2000", THRESHOLD_CDMA2000),
    ]
)

REPORT_CONFIG_INTER_RAT = Seq(
    [
        M(
            "trigger_type",
            Choice(
                [
                    (
                        "event",
                        Seq(
                            [
                                M(
                                    "event_id",
                                    Choice(
                                        [
                                            ("event_b1", Seq([M("b1_thres", _B_THRES_INTER_RAT)])),
                                            (
                                                "event_b2",
                                                Seq(
                                                    [
                                                        M("b2_thres1", THRESHOLD_EUTRA),
                                                        M("b2_thres2", _B2_THRES2_INTER_RAT),
                                                    ]
                                                ),
                                            ),
                                        ],
                                        ext=True,
                                    ),
                                ),
                                M("hysteresis", Int(0, 30)),
                                M("time_to_trigger", TIME_TO_TRIGGER),
                            ]
                        ),
                    ),
                    (
                        "periodical",
                        Seq(
                            [
                                M(
                                    "purpose",
                                    Enum(["report_strongest_cells",
                                          "report_strongest_cells_for_son",
                                          "report_cgi"]),
                                )
                            ]
                        ),
                    ),
                ]
            ),
        ),
        M("max_report_cells", Int(1, 8)),
        M(
            "report_interv",
            Enum(["ms120", "ms240", "ms480", "ms640", "ms1024", "ms2048", "ms5120", "ms10240",
                  "min1", "min6", "min12", "min30", "min60", "spare3", "spare2", "spare1"]),
        ),
        M("report_amount", Enum(["r1", "r2", "r4", "r8", "r16", "r32", "r64", "infinity"])),
    ],
    ext=True,
)

REPORT_CONFIG_TO_ADD_MOD = Seq(
    [
        M("report_cfg_id", Int(1, 32)),
        M(
            "report_cfg",
            Choice(
                [
                    ("report_cfg_eutra", REPORT_CONFIG_EUTRA),
                    ("report_cfg_inter_rat", REPORT_CONFIG_INTER_RAT),
                ]
            ),
        ),
    ]
)

MEAS_ID_TO_ADD_MOD = Seq(
    [M("meas_id", Int(1, 32)), M("meas_obj_id", Int(1, 32)), M("report_cfg_id", Int(1, 32))]
)

# QuantityConfig inter-RAT branches (reference quant_cfg_{utra,geran,
# cdma2000}_s; single-enumerator measQuantityGERAN encodes in 0 bits)
QUANTITY_CONFIG_UTRA = Seq(
    [
        M("meas_quant_utra_fdd", Enum(["cpich_rscp", "cpich_ec_n0"])),
        D("filt_coef", FILTER_COEFFICIENT, "fc4"),
    ]
)
QUANTITY_CONFIG_GERAN = Seq(
    [
        M("meas_quant_geran", Enum(["rssi"])),
        D("filt_coef", FILTER_COEFFICIENT, "fc2"),
    ]
)
QUANTITY_CONFIG_CDMA2000 = Seq(
    [
        M(
            "meas_quant_cdma2000",
            Enum(["pilot_strength", "pilot_pn_phase_and_pilot_strength"]),
        )
    ]
)

QUANTITY_CONFIG = Seq(
    [
        O(
            "quant_cfg_eutra",
            Seq([D("filt_coef_rsrp", FILTER_COEFFICIENT, "fc4"), D("filt_coef_rsrq", FILTER_COEFFICIENT, "fc4")]),
        ),
        O("quant_cfg_utra", QUANTITY_CONFIG_UTRA),
        O("quant_cfg_geran", QUANTITY_CONFIG_GERAN),
        O("quant_cfg_cdma2000", QUANTITY_CONFIG_CDMA2000),
    ],
    ext=True,
)

MEAS_GAP_CONFIG = setup_release(
    Seq([M("gap_offset", Choice([("gp0", Int(0, 39)), ("gp1", Int(0, 79))], ext=True))])
)

# PreRegistrationInfoHRPD (reference pre_regist_info_hrpd_s)
PRE_REGISTRATION_INFO_HRPD = Seq(
    [
        M("pre_regist_allowed", Bool()),
        O("pre_regist_zone_id", Int(0, 255)),
        O("secondary_pre_regist_zone_id_list", SeqOf(Int(0, 255), 1, 2)),
    ]
)

SPEED_STATE_PARS = setup_release(
    Seq(
        [
            M(
                "mob_state_params",
                Seq(
                    [
                        M("t_eval", Enum(["s30", "s60", "s120", "s180", "s240", "spare3", "spare2", "spare1"])),
                        M("t_hyst_normal", Enum(["s30", "s60", "s120", "s180", "s240", "spare3", "spare2", "spare1"])),
                        M("n_cell_change_medium", Int(1, 16)),
                        M("n_cell_change_high", Int(1, 16)),
                    ]
                ),
            ),
            M(
                "time_to_trigger_sf",
                Seq(
                    [
                        M("sf_medium", Enum(["o_dot25", "o_dot5", "o_dot75", "l_dot0"])),
                        M("sf_high", Enum(["o_dot25", "o_dot5", "o_dot75", "l_dot0"])),
                    ]
                ),
            ),
        ]
    )
)

MEAS_CONFIG = Seq(
    [
        O("meas_obj_to_rem_list", SeqOf(Int(1, 32), 1, 32)),
        O("meas_obj_to_add_mod_list", SeqOf(MEAS_OBJECT_TO_ADD_MOD, 1, 32)),
        O("report_cfg_to_rem_list", SeqOf(Int(1, 32), 1, 32)),
        O("report_cfg_to_add_mod_list", SeqOf(REPORT_CONFIG_TO_ADD_MOD, 1, 32)),
        O("meas_id_to_rem_list", SeqOf(Int(1, 32), 1, 32)),
        O("meas_id_to_add_mod_list", SeqOf(MEAS_ID_TO_ADD_MOD, 1, 32)),
        O("quant_cfg", QUANTITY_CONFIG),
        O("meas_gap_cfg", MEAS_GAP_CONFIG),
        O("s_measure", Int(0, 97)),
        O("pre_regist_info_hrpd", PRE_REGISTRATION_INFO_HRPD),
        O("speed_state_pars", SPEED_STATE_PARS),
    ],
    ext=True,
)

# ------------------------------------------------------------ MeasResults

MCC_MNC_DIGIT = Int(0, 9)
PLMN_IDENTITY = Seq(
    [O("mcc", SeqOf(MCC_MNC_DIGIT, 3, 3)), M("mnc", SeqOf(MCC_MNC_DIGIT, 2, 3))]
)
CELL_GLOBAL_ID_EUTRA = Seq([M("plmn_id", PLMN_IDENTITY), M("cell_id", BitStr(28))])

MEAS_RESULT_EUTRA = Seq(
    [
        M("pci", PHYS_CELL_ID),
        O(
            "cgi_info",
            Seq(
                [
                    M("cell_global_id", CELL_GLOBAL_ID_EUTRA),
                    M("tac", BitStr(16)),
                    O("plmn_id_list", SeqOf(PLMN_IDENTITY, 1, 5)),
                ]
            ),
        ),
        M(
            "meas_result",
            Seq([O("rsrp_result", Int(0, 97)), O("rsrq_result", Int(0, 34))], ext=True),
        ),
    ]
)

# Inter-RAT measurement results (reference meas_result_utra_s,
# meas_result_geran_s, meas_results_cdma2000_s)

CELL_GLOBAL_ID_UTRA = Seq([M("plmn_id", PLMN_IDENTITY), M("cell_id", BitStr(28))])
CELL_GLOBAL_ID_GERAN = Seq(
    [
        M("plmn_id", PLMN_IDENTITY),
        M("location_area_code", BitStr(16)),
        M("cell_id", BitStr(16)),
    ]
)

MEAS_RESULT_UTRA = Seq(
    [
        M("pci", Choice([("fdd", PHYS_CELL_ID_UTRA_FDD), ("tdd", PHYS_CELL_ID_UTRA_TDD)])),
        O(
            "cgi_info",
            Seq(
                [
                    M("cell_global_id", CELL_GLOBAL_ID_UTRA),
                    O("location_area_code", BitStr(16)),
                    O("routing_area_code", BitStr(8)),
                    O("plmn_id_list", SeqOf(PLMN_IDENTITY, 1, 5)),
                ]
            ),
        ),
        M(
            "meas_result",
            Seq([O("utra_rscp", Int(-5, 91)), O("utra_ec_n0", Int(0, 49))], ext=True),
        ),
    ]
)
MEAS_RESULT_LIST_UTRA = SeqOf(MEAS_RESULT_UTRA, 1, 8)

MEAS_RESULT_GERAN = Seq(
    [
        M("carrier_freq", CARRIER_FREQ_GERAN),
        M("pci", PHYS_CELL_ID_GERAN),
        O(
            "cgi_info",
            Seq(
                [
                    M("cell_global_id", CELL_GLOBAL_ID_GERAN),
                    O("routing_area_code", BitStr(8)),
                ]
            ),
        ),
        M("meas_result", Seq([M("rssi", Int(0, 63))], ext=True)),
    ]
)
MEAS_RESULT_LIST_GERAN = SeqOf(MEAS_RESULT_GERAN, 1, 8)

MEAS_RESULT_CDMA2000 = Seq(
    [
        M("pci", PHYS_CELL_ID_CDMA2000),
        O("cgi_info", CELL_GLOBAL_ID_CDMA2000),
        M(
            "meas_result",
            Seq(
                [
                    O("pilot_pn_phase", Int(0, 32767)),
                    M("pilot_strength", Int(0, 63)),
                ],
                ext=True,
            ),
        ),
    ]
)
MEAS_RESULTS_CDMA2000 = Seq(
    [
        M("pre_regist_status_hrpd", Bool()),
        M("meas_result_list_cdma2000", SeqOf(MEAS_RESULT_CDMA2000, 1, 8)),
    ]
)

MEAS_RESULTS = Seq(
    [
        M("meas_id", Int(1, 32)),
        M("meas_result_pcell", Seq([M("rsrp_result", Int(0, 97)), M("rsrq_result", Int(0, 34))])),
        O(
            "meas_result_neigh_cells",
            Choice(
                [
                    ("meas_result_list_eutra", SeqOf(MEAS_RESULT_EUTRA, 1, 8)),
                    ("meas_result_list_utra", MEAS_RESULT_LIST_UTRA),
                    ("meas_result_list_geran", MEAS_RESULT_LIST_GERAN),
                    ("meas_results_cdma2000", MEAS_RESULTS_CDMA2000),
                ],
                ext=True,
            ),
        ),
    ],
    ext=True,
)

# ======================================================================
# DL-DCCH messages
# ======================================================================

SECURITY_ALGORITHM_CONFIG = Seq(
    [
        M(
            "ciphering_algorithm",
            Enum(["eea0", "eea1", "eea2", "eea3_v1130", "spare4", "spare3", "spare2", "spare1"], ext=True),
        ),
        M(
            "integrity_prot_algorithm",
            Enum(["eia0_v920", "eia1", "eia2", "eia3_v1130", "spare4", "spare3", "spare2", "spare1"], ext=True),
        ),
    ]
)

SECURITY_CONFIG_HO = Seq(
    [
        M(
            "handov_type",
            Choice(
                [
                    (
                        "intra_lte",
                        Seq(
                            [
                                O("security_algorithm_cfg", SECURITY_ALGORITHM_CONFIG),
                                M("key_change_ind", Bool()),
                                M("next_hop_chaining_count", Int(0, 7)),
                            ]
                        ),
                    ),
                    (
                        "inter_rat",
                        Seq(
                            [
                                M("security_algorithm_cfg", SECURITY_ALGORITHM_CONFIG),
                                M("nas_security_param_to_eutra", OctStr(6, 6)),
                            ]
                        ),
                    ),
                ]
            ),
        ),
    ],
    ext=True,
)

RACH_CONFIG_DEDICATED = Seq([M("ra_preamb_idx", Int(0, 63)), M("ra_prach_mask_idx", Int(0, 15))])

CARRIER_BANDWIDTH_EUTRA = Seq(
    [
        M("dl_bw", Enum(["n6", "n15", "n25", "n50", "n75", "n100"] + [f"spare{i}" for i in range(10, 0, -1)])),
        O("ul_bw", Enum(["n6", "n15", "n25", "n50", "n75", "n100"] + [f"spare{i}" for i in range(10, 0, -1)])),
    ]
)

CARRIER_FREQ_EUTRA = Seq([M("dl_carrier_freq", ARFCN), O("ul_carrier_freq", ARFCN)])

MOBILITY_CONTROL_INFO = Seq(
    [
        M("target_pci", PHYS_CELL_ID),
        O("carrier_freq", CARRIER_FREQ_EUTRA),
        O("carrier_bw", CARRIER_BANDWIDTH_EUTRA),
        O("add_spec_emission", Int(1, 32)),
        M("t304", Enum(["ms50", "ms100", "ms150", "ms200", "ms500", "ms1000", "ms2000", "ms10000_v1310"])),
        M("new_ue_id", BitStr(16)),
        M("rr_cfg_common", RADIO_RESOURCE_CONFIG_COMMON),
        O("rach_cfg_ded", RACH_CONFIG_DEDICATED),
    ],
    ext=True,
)

DEDICATED_INFO_NAS = OctStr()

# --- carrier aggregation (R10): SCellToAddMod-r10 et al (TS 36.331 §6.3.2,
# the srsLTE rrc_asn1 scell_to_add_mod_r10_s) --------------------------------

SCELL_INDEX = Int(1, 7)

_MBSFN_SUBFRAME_CONFIG = Seq(
    [
        M("radioframe_alloc_period", Enum(["n1", "n2", "n4", "n8", "n16", "n32"])),
        M("radioframe_alloc_offset", Int(0, 7)),
        M("sf_alloc", Choice([("one_frame", BitStr(6)), ("four_frames", BitStr(24))])),
    ]
)

# UL-Configuration of RadioResourceConfigCommonSCell-r10 (TS 36.331
# §6.3.2; reference rr_cfg_common_scell_r10_s ul_cfg_r10 inline struct)
UL_CONFIGURATION_R10 = Seq(
    [
        M(
            "ul_freq_info",
            Seq(
                [
                    O("ul_carrier_freq", ARFCN),
                    O("ul_bw", Enum(["n6", "n15", "n25", "n50", "n75", "n100"])),
                    M("add_spec_emission_scell", Int(1, 32)),
                ]
            ),
        ),
        O("p_max", Int(-30, 33)),
        M(
            "ul_pwr_ctrl_common_scell",
            Seq(
                [
                    M("p0_nominal_pusch", Int(-126, 24)),
                    M("alpha", Enum(["al0", "al04", "al05", "al06", "al07", "al08", "al09", "al1"])),
                ]
            ),
        ),
        M("srs_ul_cfg_common", SRS_UL_CONFIG_COMMON),
        M("ul_cp_len", Enum(["len1", "len2"])),
        O("prach_cfg_scell", Seq([M("prach_cfg_idx", Int(0, 63))])),
        M("pusch_cfg_common", PUSCH_CONFIG_COMMON),
    ]
)

RADIO_RESOURCE_CONFIG_COMMON_SCELL = Seq(
    [
        M(
            "non_ul_cfg",
            Seq(
                [
                    M("dl_bw", Enum(["n6", "n15", "n25", "n50", "n75", "n100"])),
                    M("ant_info_common", ANTENNA_INFO_COMMON),
                    O("mbsfn_sf_cfg_list", SeqOf(_MBSFN_SUBFRAME_CONFIG, 1, 8)),
                    M("phich_cfg", PHICH_CONFIG),
                    M("pdsch_cfg_common", PDSCH_CONFIG_COMMON),
                    O("tdd_cfg", TDD_CONFIG),
                ]
            ),
        ),
        O("ul_cfg", UL_CONFIGURATION_R10),
    ],
    ext=True,
)

# --- RadioResourceConfigDedicatedSCell-r10 subtree (TS 36.331 §6.3.2;
# reference rr_cfg_ded_scell_r10_s / phys_cfg_ded_scell_r10_s) ---

ANTENNA_INFO_DEDICATED_R10 = Seq(
    [
        M(
            "tx_mode_r10",
            Enum(["tm1", "tm2", "tm3", "tm4", "tm5", "tm6", "tm7", "tm8_v920",
                  "tm9_v1020", "spare7", "spare6", "spare5", "spare4", "spare3",
                  "spare2", "spare1"]),
        ),
        # codebookSubsetRestriction-r10 is an unconstrained BIT STRING
        # (value model: (int, nbits)); the large hi routes the length
        # through the general determinant per X.691 §10.9.3.3
        O("codebook_subset_restrict_r10", BitStr(0, 1 << 20)),
        M("ue_tx_ant_sel", setup_release(Enum(["closed_loop", "open_loop"]))),
    ]
)

ANTENNA_INFO_UL_R10 = Seq(
    [
        O("tx_mode_ul_r10", Enum(["tm1", "tm2", "spare6", "spare5", "spare4",
                                  "spare3", "spare2", "spare1"])),
        O("four_ant_port_activ_r10", Enum(["setup"])),
    ]
)

CROSS_CARRIER_SCHED_CONFIG_R10 = Seq(
    [
        M(
            "sched_cell_info_r10",
            Choice(
                [
                    ("own_r10", Seq([M("cif_presence_r10", Bool())])),
                    (
                        "other_r10",
                        Seq(
                            [
                                M("sched_cell_id_r10", Int(0, 7)),
                                M("pdsch_start_r10", Int(1, 4)),
                            ]
                        ),
                    ),
                ]
            ),
        )
    ]
)

CSI_RS_CONFIG_R10 = Seq(
    [
        O(
            "csi_rs_r10",
            setup_release(
                Seq(
                    [
                        M("ant_ports_count_r10", Enum(["an1", "an2", "an4", "an8"])),
                        M("res_cfg_r10", Int(0, 31)),
                        M("sf_cfg_r10", Int(0, 154)),
                        M("p_c_r10", Int(-8, 15)),
                    ]
                )
            ),
        ),
        O(
            "zero_tx_pwr_csi_rs_r10",
            setup_release(
                Seq(
                    [
                        M("zero_tx_pwr_res_cfg_list_r10", BitStr(16)),
                        M("zero_tx_pwr_sf_cfg_r10", Int(0, 154)),
                    ]
                )
            ),
        ),
    ]
)

CQI_REPORT_PERIODIC_SCELL_R10 = setup_release(
    Seq(
        [
            M("cqi_pucch_res_idx_r10", Int(0, 1184)),
            O("cqi_pucch_res_idx_p1_r10", Int(0, 1184)),
            M("cqi_pmi_cfg_idx", Int(0, 1023)),
            M(
                "cqi_format_ind_periodic_r10",
                Choice(
                    [
                        (
                            "wideband_cqi_r10",
                            Seq([O("csi_report_mode_r10", Enum(["submode1", "submode2"]))]),
                        ),
                        (
                            "subband_cqi_r10",
                            Seq(
                                [
                                    M("k", Int(1, 4)),
                                    M("periodicity_factor_r10", Enum(["n2", "n4"])),
                                ]
                            ),
                        ),
                    ]
                ),
            ),
            O("ri_cfg_idx", Int(0, 1023)),
            M("simul_ack_nack_and_cqi", Bool()),
            O("cqi_mask_r9", Enum(["setup"])),
            O(
                "csi_cfg_idx_r10",
                setup_release(
                    Seq(
                        [
                            M("cqi_pmi_cfg_idx2_r10", Int(0, 1023)),
                            O("ri_cfg_idx2_r10", Int(0, 1023)),
                        ]
                    )
                ),
            ),
        ]
    )
)

CQI_REPORT_CONFIG_SCELL_R10 = Seq(
    [
        O(
            "cqi_report_mode_aperiodic_r10",
            Enum(["rm12", "rm20", "rm22", "rm30", "rm31", "rm32_v1250",
                  "rm10_v1310", "rm11_v1310"]),
        ),
        M("nom_pdsch_rs_epre_offset_r10", Int(-1, 6)),
        O("cqi_report_periodic_scell_r10", CQI_REPORT_PERIODIC_SCELL_R10),
        O("pmi_ri_report_r10", Enum(["setup"])),
    ]
)

PUSCH_CONFIG_DEDICATED_SCELL_R10 = Seq(
    [
        O("group_hop_disabled_r10", Enum(["true_value"])),
        O("dmrs_with_occ_activ_r10", Enum(["true_value"])),
    ]
)

UL_POWER_CONTROL_DEDICATED_SCELL_R10 = Seq(
    [
        M("p0_ue_pusch_r10", Int(-8, 7)),
        M("delta_mcs_enabled_r10", Enum(["en0", "en1"])),
        M("accumulation_enabled_r10", Bool()),
        M("psrs_offset_r10", Int(0, 15)),
        O("psrs_offset_ap_r10", Int(0, 15)),
        D("filt_coef_r10", FILTER_COEFFICIENT, "fc4"),
        M("pathloss_ref_linking_r10", Enum(["pcell", "scell"])),
    ]
)

SRS_CONFIG_AP_R10 = Seq(
    [
        M("srs_ant_port_ap_r10", Enum(["an1", "an2", "an4", "spare1"])),
        M("srs_bw_ap_r10", Enum(["bw0", "bw1", "bw2", "bw3"])),
        M("freq_domain_position_ap_r10", Int(0, 23)),
        M("tx_comb_ap_r10", Int(0, 1)),
        M("cyclic_shift_ap_r10", Enum(["cs0", "cs1", "cs2", "cs3", "cs4", "cs5", "cs6", "cs7"])),
    ]
)

SRS_UL_CONFIG_DEDICATED_V1020 = Seq(
    [M("srs_ant_port_r10", Enum(["an1", "an2", "an4", "spare1"]))]
)

SRS_UL_CONFIG_DEDICATED_APERIODIC_R10 = setup_release(
    Seq(
        [
            M("srs_cfg_idx_ap_r10", Int(0, 31)),
            O("srs_cfg_ap_dci_format4_r10", SeqOf(SRS_CONFIG_AP_R10, 1, 3)),
            O(
                "srs_activ_ap_r10",
                setup_release(Seq([M("srs_cfg_ap_r10", SRS_CONFIG_AP_R10)])),
            ),
        ]
    )
)

PHYSICAL_CONFIG_DEDICATED_SCELL_R10 = Seq(
    [
        O(
            "non_ul_cfg",
            Seq(
                [
                    O("ant_info_r10", ANTENNA_INFO_DEDICATED_R10),
                    O("cross_carrier_sched_cfg_r10", CROSS_CARRIER_SCHED_CONFIG_R10),
                    O("csi_rs_cfg_r10", CSI_RS_CONFIG_R10),
                    O("pdsch_cfg_ded_r10", PDSCH_CONFIG_DEDICATED),
                ]
            ),
        ),
        O(
            "ul_cfg",
            Seq(
                [
                    O("ant_info_ul_r10", ANTENNA_INFO_UL_R10),
                    O("pusch_cfg_ded_scell_r10", PUSCH_CONFIG_DEDICATED_SCELL_R10),
                    O("ul_pwr_ctrl_ded_scell_r10", UL_POWER_CONTROL_DEDICATED_SCELL_R10),
                    O("cqi_report_cfg_scell_r10", CQI_REPORT_CONFIG_SCELL_R10),
                    O("srs_ul_cfg_ded_r10", SRS_UL_CONFIG_DEDICATED),
                    O("srs_ul_cfg_ded_v1020", SRS_UL_CONFIG_DEDICATED_V1020),
                    O("srs_ul_cfg_ded_aperiodic_r10", SRS_UL_CONFIG_DEDICATED_APERIODIC_R10),
                ]
            ),
        ),
    ],
    ext=True,
)

RADIO_RESOURCE_CONFIG_DEDICATED_SCELL_R10 = Seq(
    [O("phys_cfg_ded_scell_r10", PHYSICAL_CONFIG_DEDICATED_SCELL_R10)],
    ext=True,
)

SCELL_TO_ADD_MOD = Seq(
    [
        M("scell_idx", SCELL_INDEX),
        O(
            "cell_identif",
            Seq([M("phys_cell_id", PHYS_CELL_ID), M("dl_carrier_freq", ARFCN)]),
        ),
        O("rr_cfg_common_scell", RADIO_RESOURCE_CONFIG_COMMON_SCELL),
        O("rr_cfg_ded_scell", RADIO_RESOURCE_CONFIG_DEDICATED_SCELL_R10),
    ],
    ext=True,
)

# OtherConfig-r9 (reference other_cfg_r9_s root; r11+ additions arrive
# as unknown extension groups and round-trip via the raw preservation)
OTHER_CONFIG_R9 = Seq(
    [
        O(
            "report_proximity_cfg_r9",
            Seq(
                [
                    O("proximity_ind_eutra_r9", Enum(["enabled"])),
                    O("proximity_ind_utra_r9", Enum(["enabled"])),
                ]
            ),
        )
    ],
    ext=True,
)

# RRCConnectionReconfiguration-v890/v920/v1020-IEs nonCriticalExtension chain
RECFG_V1020 = Seq(
    [
        O("scell_to_release_list", SeqOf(SCELL_INDEX, 1, 4)),
        O("scell_to_add_mod_list", SeqOf(SCELL_TO_ADD_MOD, 1, 4)),
        O("non_crit_ext", Seq([])),
    ]
)

RECFG_V920 = Seq(
    [
        O("other_cfg", OTHER_CONFIG_R9),
        O("full_cfg", Enum(["true"])),
        O("non_crit_ext", RECFG_V1020),
    ]
)

RECFG_V890 = Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", RECFG_V920)])

RRC_CONN_RECFG = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1(
                "rrc_conn_recfg",
                Seq(
                    [
                        O("meas_cfg", MEAS_CONFIG),
                        O("mob_ctrl_info", MOBILITY_CONTROL_INFO),
                        O("ded_info_nas_list", SeqOf(DEDICATED_INFO_NAS, 1, 11)),
                        O("rr_cfg_ded", RADIO_RESOURCE_CONFIG_DEDICATED),
                        O("security_cfg_ho", SECURITY_CONFIG_HO),
                        O("non_crit_ext", RECFG_V890),
                    ]
                ),
                7,
            ),
        ),
    ]
)

REDIRECTED_CARRIER_INFO = Choice(
    [
        ("eutra", ARFCN),
        ("geran", CARRIER_FREQS_GERAN),
        ("utra_fdd", Int(0, 16383)),
        ("utra_tdd", Int(0, 16383)),
        ("cdma2000_hrpd", CARRIER_FREQ_CDMA2000),
        ("cdma2000_1x_rtt", CARRIER_FREQ_CDMA2000),
    ],
    ext=True,
)

FREQ_PRIORITY_EUTRA = Seq([M("carrier_freq", ARFCN), M("cell_resel_prio", Int(0, 7))])

IDLE_MODE_MOBILITY_CONTROL_INFO = Seq(
    [
        O("freq_prio_list_eutra", SeqOf(FREQ_PRIORITY_EUTRA, 1, 8)),
        O("freq_prio_list_geran", SeqOf(Seq([
            M("carrier_freqs", CARRIER_FREQS_GERAN),
            M("cell_resel_prio", Int(0, 7))]), 1, 16)),
        O("freq_prio_list_utra_fdd", SeqOf(Seq([
            M("carrier_freq", ARFCN_VALUE_UTRA),
            M("cell_resel_prio", Int(0, 7))]), 1, 16)),
        O("freq_prio_list_utra_tdd", SeqOf(Seq([
            M("carrier_freq", ARFCN_VALUE_UTRA),
            M("cell_resel_prio", Int(0, 7))]), 1, 16)),
        O("band_class_prio_list_hrpd", SeqOf(Seq([
            M("band_class", BANDCLASS_CDMA2000),
            M("cell_resel_prio", Int(0, 7))]), 1, 32)),
        O("band_class_prio_list1_xrtt", SeqOf(Seq([
            M("band_class", BANDCLASS_CDMA2000),
            M("cell_resel_prio", Int(0, 7))]), 1, 32)),
        O("t320", Enum(["min5", "min10", "min20", "min30", "min60", "min120", "min180", "spare1"])),
    ],
    ext=True,
)

RRC_CONN_RELEASE = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1(
                "rrc_conn_release",
                Seq(
                    [
                        M(
                            "release_cause",
                            Enum(["load_balancing_ta_urequired", "other", "cs_fallback_high_prio_v1020", "rrc_suspend_v1320"]),
                        ),
                        O("redirected_carrier_info", REDIRECTED_CARRIER_INFO),
                        O("idle_mode_mob_ctrl_info", IDLE_MODE_MOBILITY_CONTROL_INFO),
                        O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])),
                    ]
                ),
                3,
            ),
        ),
    ]
)

SECURITY_MODE_COMMAND = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1(
                "security_mode_cmd",
                Seq(
                    [
                        M("security_cfg_smc", Seq([M("security_algorithm_cfg", SECURITY_ALGORITHM_CONFIG)], ext=True)),
                        O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])),
                    ]
                ),
                3,
            ),
        ),
    ]
)

RAT_TYPE = Enum(
    ["eutra", "utra", "geran_cs", "geran_ps", "cdma2000_1xrtt", "nr", "eutra_nr", "spare1"], ext=True
)

UE_CAPABILITY_ENQUIRY = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1(
                "ue_cap_enquiry",
                Seq(
                    [
                        M("ue_cap_request", SeqOf(RAT_TYPE, 1, 8)),
                        O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])),
                    ]
                ),
                3,
            ),
        ),
    ]
)

DEDICATED_INFO_TYPE = Choice(
    [
        ("ded_info_nas", DEDICATED_INFO_NAS),
        ("ded_info_cdma2000_1xrtt", OctStr()),
        ("ded_info_cdma2000_hrpd", OctStr()),
    ]
)

DL_INFO_TRANSFER = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1(
                "dl_info_transfer",
                Seq(
                    [
                        M("ded_info_type", DEDICATED_INFO_TYPE),
                        O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])),
                    ]
                ),
                3,
            ),
        ),
    ]
)

# ---------------------------------------------------------------------
# Inter-RAT mobility + miscellaneous DL-DCCH messages (TS 36.331 §6.2.2;
# reference mob_from_eutra_cmd_s, csfb_params_resp_cdma2000_s,
# ho_from_eutra_prep_request_s, counter_check_s, ue_info_request_r9_s,
# logged_meas_cfg_r10_s, rn_recfg_r10_s)
# ---------------------------------------------------------------------

_LATE_NONCRIT = Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])

# element SIZE(1..23) in the spec; reference encodes each element as an
# unconstrained octet string (bounded_array<dyn_octstring, 10>)
SYS_INFO_LIST_GERAN = SeqOf(OctStr(), 1, 10)
SI_OR_PSI_GERAN = Choice(
    [("si", SYS_INFO_LIST_GERAN), ("psi", SYS_INFO_LIST_GERAN)]
)

_HANDOVER = Seq(
    [
        # NOTE: Handover.targetRAT-Type is its own enumeration (reference
        # ho_s::target_rat_type_opts), NOT the RAT-Type IE
        M("target_rat_type", Enum(["utra", "geran", "cdma2000_1xrtt",
                                   "cdma2000_hrpd", "nr", "eutra",
                                   "spare2", "spare1"], ext=True)),
        M("target_rat_msg_container", OctStr()),
        O("nas_security_param_from_eutra", OctStr(1, 1)),
        O("sys_info", SI_OR_PSI_GERAN),
    ]
)

_CELL_CHANGE_ORDER = Seq(
    [
        M("t304", Enum(["ms100", "ms200", "ms500", "ms1000", "ms2000",
                        "ms4000", "ms8000", "ms10000_v1310"])),
        M(
            "target_rat",
            Choice(
                [
                    (
                        "geran",
                        Seq(
                            [
                                M("pci", PHYS_CELL_ID_GERAN),
                                M("carrier_freq", CARRIER_FREQ_GERAN),
                                O("network_ctrl_order", BitStr(2)),
                                O("sys_info", SI_OR_PSI_GERAN),
                            ]
                        ),
                    )
                ],
                ext=True,
            ),
        ),
    ]
)

E_CSFB_R9 = Seq(
    [
        O("msg_cont_cdma2000_1xrtt_r9", OctStr()),
        O("mob_cdma2000_hrpd_r9", Enum(["ho", "redirection"])),
        O("msg_cont_cdma2000_hrpd_r9", OctStr()),
        O("redirect_carrier_cdma2000_hrpd_r9", CARRIER_FREQ_CDMA2000),
    ]
)

MOBILITY_FROM_EUTRA_COMMAND = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            Choice(
                [
                    (
                        "c1",
                        Choice(
                            [
                                (
                                    "mob_from_eutra_cmd_r8",
                                    Seq(
                                        [
                                            M("cs_fallback_ind", Bool()),
                                            M("purpose", Choice([
                                                ("handover", _HANDOVER),
                                                ("cell_change_order", _CELL_CHANGE_ORDER),
                                            ])),
                                            O("non_crit_ext", _LATE_NONCRIT),
                                        ]
                                    ),
                                ),
                                (
                                    "mob_from_eutra_cmd_r9",
                                    Seq(
                                        [
                                            M("cs_fallback_ind", Bool()),
                                            M("purpose", Choice([
                                                ("handover", _HANDOVER),
                                                ("cell_change_order", _CELL_CHANGE_ORDER),
                                                ("e_csfb_r9", E_CSFB_R9),
                                            ], ext=True)),
                                            O("non_crit_ext", _LATE_NONCRIT),
                                        ]
                                    ),
                                ),
                                ("spare2", Null()),
                                ("spare1", Null()),
                            ]
                        ),
                    ),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        ),
    ]
)

CSFB_PARAMETERS_RESPONSE_CDMA2000 = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            Choice(
                [
                    (
                        "csfb_params_resp_cdma2000_r8",
                        Seq(
                            [
                                M("rand", BitStr(32)),
                                M("mob_params", OctStr()),
                                O("non_crit_ext", _LATE_NONCRIT),
                            ]
                        ),
                    ),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        ),
    ]
)

HANDOVER_FROM_EUTRA_PREPARATION_REQUEST = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1(
                "ho_from_eutra_prep_request",
                Seq(
                    [
                        M("cdma2000_type", CDMA2000_TYPE),
                        O("rand", BitStr(32)),
                        O("mob_params", OctStr()),
                        O("non_crit_ext", _LATE_NONCRIT),
                    ]
                ),
                3,
            ),
        ),
    ]
)

DRB_COUNT_MSB_INFO = Seq(
    [
        M("drb_id", Int(1, 32)),
        M("count_msb_ul", Int(0, 33554431)),
        M("count_msb_dl", Int(0, 33554431)),
    ]
)

COUNTER_CHECK = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1(
                "counter_check",
                Seq(
                    [
                        M("drb_count_msb_info_list", SeqOf(DRB_COUNT_MSB_INFO, 1, 11)),
                        O("non_crit_ext", _LATE_NONCRIT),
                    ]
                ),
                3,
            ),
        ),
    ]
)

UE_INFORMATION_REQUEST_R9 = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1_alt(
                "ue_info_request_r9",
                Seq(
                    [
                        M("rach_report_req_r9", Bool()),
                        M("rlf_report_req_r9", Bool()),
                        O("non_crit_ext", _LATE_NONCRIT),
                    ]
                ),
                3,
            ),
        ),
    ]
)

TRACE_REFERENCE_R10 = Seq(
    [M("plmn_id_r10", PLMN_IDENTITY), M("trace_id_r10", OctStr(3, 3))]
)

AREA_CONFIGURATION_R10 = Choice(
    [
        ("cell_global_id_list_r10", SeqOf(CELL_GLOBAL_ID_EUTRA, 1, 32)),
        ("tac_list_r10", SeqOf(BitStr(16), 1, 8)),
    ]
)

LOGGED_MEASUREMENT_CONFIGURATION_R10 = Seq(
    [
        M(
            "crit_exts",
            crit_ext_c1_alt(
                "logged_meas_cfg_r10",
                Seq(
                    [
                        M("trace_ref_r10", TRACE_REFERENCE_R10),
                        M("trace_recording_session_ref_r10", OctStr(2, 2)),
                        M("tce_id_r10", OctStr(1, 1)),
                        M("absolute_time_info_r10", BitStr(48)),
                        O("area_cfg_r10", AREA_CONFIGURATION_R10),
                        M("logging_dur_r10", Enum(["min10", "min20", "min40", "min60",
                                                   "min90", "min120", "spare2", "spare1"])),
                        M("logging_interv_r10", Enum(["ms1280", "ms2560", "ms5120", "ms10240",
                                                      "ms20480", "ms30720", "ms40960", "ms61440"])),
                        O("non_crit_ext", _LATE_NONCRIT),
                    ]
                ),
                3,
            ),
        ),
    ]
)

RN_SUBFRAME_CONFIG_R10 = Seq(
    [
        O(
            "sf_cfg_pattern_r10",
            Choice(
                [
                    ("sf_cfg_pattern_fdd_r10", BitStr(8)),
                    ("sf_cfg_pattern_tdd_r10", Int(0, 31)),
                ]
            ),
        ),
        O(
            "rpdcch_cfg_r10",
            Seq(
                [
                    M("res_alloc_type_r10", Enum(["type0", "type1", "type2_localized",
                                                  "type2_distributed", "spare4", "spare3",
                                                  "spare2", "spare1"])),
                    M(
                        "res_block_assign_r10",
                        # extensible CHOICE (ext bit + index on the wire)
                        Choice(
                            ext=True,
                            alts=[
                                (
                                    "type01_r10",
                                    Choice(
                                        [("nrb6_r10", BitStr(6)), ("nrb15_r10", BitStr(8)),
                                         ("nrb25_r10", BitStr(13)), ("nrb50_r10", BitStr(17)),
                                         ("nrb75_r10", BitStr(19)), ("nrb100_r10", BitStr(25))]
                                    ),
                                ),
                                (
                                    "type2_r10",
                                    Choice(
                                        [("nrb6_r10", BitStr(5)), ("nrb15_r10", BitStr(7)),
                                         ("nrb25_r10", BitStr(9)), ("nrb50_r10", BitStr(11)),
                                         ("nrb75_r10", BitStr(12)), ("nrb100_r10", BitStr(13))]
                                    ),
                                ),
                            ]
                        ),
                    ),
                    M(
                        "demod_rs_r10",
                        Choice(
                            [
                                ("interleaving_r10", Enum(["crs"])),
                                ("no_interleaving_r10", Enum(["crs", "dmrs"])),
                            ]
                        ),
                    ),
                    M("pdsch_start_r10", Int(1, 3)),
                    M(
                        "pucch_cfg_r10",
                        Choice(
                            [
                                (
                                    "tdd",
                                    Choice(
                                        [
                                            ("ch_sel_r10", SeqOf(Int(0, 2047), 1, 4)),
                                            ("fallback_for_format3", Seq([
                                                M("n1_pucch_an_p0_r10", Int(0, 2047)),
                                                O("n1_pucch_an_p1_r10", Int(0, 2047)),
                                            ])),
                                        ]
                                    ),
                                ),
                                (
                                    "fdd",
                                    Seq(
                                        [
                                            M("n1_pucch_an_p0_r10", Int(0, 2047)),
                                            O("n1_pucch_an_p1_r10", Int(0, 2047)),
                                        ]
                                    ),
                                ),
                            ]
                        ),
                    ),
                ],
                ext=True,
            ),
        ),
    ],
    ext=True,
)

# sib_type2_r10 carries the full SIB2 schema, defined later in the BCCH
# section — the field is patched in right after SIB2 (Python objects are
# late-bound; the schema tree is only walked at encode/decode time)
RN_SYSTEM_INFORMATION_R10 = Seq(
    [
        O("sib_type1_r10", OctStr()),
        O("sib_type2_r10", Seq([])),  # patched to SIB2 below
    ],
    ext=True,
)

RN_RECONFIGURATION_R10 = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1_alt(
                "rn_recfg_r10",
                Seq(
                    [
                        O("rn_sys_info_r10", RN_SYSTEM_INFORMATION_R10),
                        O("rn_sf_cfg_r10", RN_SUBFRAME_CONFIG_R10),
                        O("late_non_crit_ext", OctStr()),
                        O("non_crit_ext", Seq([])),
                    ]
                ),
                3,
            ),
        ),
    ]
)

DL_DCCH_MESSAGE = Seq(
    [
        M(
            "msg",
            Choice(
                [
                    (
                        "c1",
                        Choice(
                            [
                                ("csfb_params_resp_cdma2000", CSFB_PARAMETERS_RESPONSE_CDMA2000),
                                ("dl_info_transfer", DL_INFO_TRANSFER),
                                ("ho_from_eutra_prep_request", HANDOVER_FROM_EUTRA_PREPARATION_REQUEST),
                                ("mob_from_eutra_cmd", MOBILITY_FROM_EUTRA_COMMAND),
                                ("rrc_conn_recfg", RRC_CONN_RECFG),
                                ("rrc_conn_release", RRC_CONN_RELEASE),
                                ("security_mode_cmd", SECURITY_MODE_COMMAND),
                                ("ue_cap_enquiry", UE_CAPABILITY_ENQUIRY),
                                ("counter_check", COUNTER_CHECK),
                                ("ue_info_request_r9", UE_INFORMATION_REQUEST_R9),
                                ("logged_meas_cfg_r10", LOGGED_MEASUREMENT_CONFIGURATION_R10),
                                ("rn_recfg_r10", RN_RECONFIGURATION_R10),
                                ("spare4", Null()),
                                ("spare3", Null()),
                                ("spare2", Null()),
                                ("spare1", Null()),
                            ]
                        ),
                    ),
                    ("msg_class_ext", Seq([])),
                ]
            ),
        )
    ]
)

# ======================================================================
# UL-CCCH / UL-DCCH messages
# ======================================================================

S_TMSI = Seq([M("mmec", BitStr(8)), M("m_tmsi", BitStr(32))])

RRC_CONN_REQUEST = Seq(
    [
        M(
            "crit_exts",
            Choice(
                [
                    (
                        "rrc_conn_request_r8",
                        Seq(
                            [
                                M("ue_id", Choice([("s_tmsi", S_TMSI), ("random_value", BitStr(40))])),
                                M(
                                    "establishment_cause",
                                    Enum(["emergency", "high_prio_access", "mt_access", "mo_sig",
                                          "mo_data", "delay_tolerant_access_v1020", "mo_voice_call_v1280", "spare1"]),
                                ),
                                M("spare", BitStr(1)),
                            ]
                        ),
                    ),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        ),
    ]
)

REESTAB_UE_IDENTITY = Seq(
    [M("c_rnti", BitStr(16)), M("pci", PHYS_CELL_ID), M("short_mac_i", BitStr(16))]
)

RRC_CONN_REEST_REQUEST = Seq(
    [
        M(
            "crit_exts",
            Choice(
                [
                    (
                        "rrc_conn_reest_request_r8",
                        Seq(
                            [
                                M("ue_id", REESTAB_UE_IDENTITY),
                                M(
                                    "reest_cause",
                                    Enum(["recfg_fail", "ho_fail", "other_fail", "spare1"]),
                                ),
                                M("spare", BitStr(2)),
                            ]
                        ),
                    ),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        ),
    ]
)

UL_CCCH_MESSAGE = Seq(
    [
        M(
            "msg",
            Choice(
                [
                    (
                        "c1",
                        Choice(
                            [
                                ("rrc_conn_reest_request", RRC_CONN_REEST_REQUEST),
                                ("rrc_conn_request", RRC_CONN_REQUEST),
                            ]
                        ),
                    ),
                    ("msg_class_ext", Seq([])),
                ]
            ),
        )
    ]
)

MEASUREMENT_REPORT = Seq(
    [
        M(
            "crit_exts",
            crit_ext_c1(
                "meas_report",
                Seq([M("meas_results", MEAS_RESULTS), O("non_crit_ext", Seq([]))]),
                7,
            ),
        ),
    ]
)

RRC_CONN_RECFG_COMPLETE = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            Choice(
                [
                    ("rrc_conn_recfg_complete_r8", Seq([O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))]))])),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        ),
    ]
)

RRC_CONN_REEST_COMPLETE = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            Choice(
                [
                    ("rrc_conn_reest_complete_r8", Seq([O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))]))])),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        ),
    ]
)

REGISTERED_MME = Seq([O("plmn_id", PLMN_IDENTITY), M("mmegi", BitStr(16)), M("mmec", BitStr(8))])

RRC_CONN_SETUP_COMPLETE = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            Choice(
                [
                    (
                        "c1",
                        c1_spares(
                            [
                                (
                                    "rrc_conn_setup_complete_r8",
                                    Seq(
                                        [
                                            M("sel_plmn_id", Int(1, 6)),
                                            O("registered_mme", REGISTERED_MME),
                                            M("ded_info_nas", DEDICATED_INFO_NAS),
                                            O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])),
                                        ]
                                    ),
                                )
                            ],
                            3,
                        ),
                    ),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        ),
    ]
)

SECURITY_MODE_COMPLETE = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            Choice(
                [
                    ("security_mode_complete_r8", Seq([O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))]))])),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        ),
    ]
)

SECURITY_MODE_FAILURE = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            Choice(
                [
                    ("security_mode_fail_r8", Seq([O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))]))])),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        ),
    ]
)

UE_CAPABILITY_RAT_CONTAINER = Seq([M("rat_type", RAT_TYPE), M("ue_cap_rat_container", OctStr())])

UE_CAPABILITY_INFORMATION = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            Choice(
                [
                    (
                        "c1",
                        c1_spares(
                            [
                                (
                                    "ue_cap_info_r8",
                                    Seq(
                                        [
                                            M("ue_cap_rat_container_list", SeqOf(UE_CAPABILITY_RAT_CONTAINER, 0, 8)),
                                            O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])),
                                        ]
                                    ),
                                )
                            ],
                            7,
                        ),
                    ),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        ),
    ]
)

UL_INFO_TRANSFER = Seq(
    [
        M(
            "crit_exts",
            crit_ext_c1(
                "ul_info_transfer",
                Seq(
                    [
                        M("ded_info_type", DEDICATED_INFO_TYPE),
                        O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])),
                    ]
                ),
                3,
            ),
        ),
    ]
)

# ---------------------------------------------------------------------
# Remaining UL-DCCH messages (TS 36.331 §6.2.2; reference
# csfb_params_request_cdma2000_s, ul_ho_prep_transfer_s,
# counter_check_resp_s, ue_info_resp_r9_s (incl. rlf_report_r9_s),
# proximity_ind_r9_s, rn_recfg_complete_r10_s, mbms_count_resp_r10_s,
# inter_freq_rstd_meas_ind_r10_s)
# ---------------------------------------------------------------------

CSFB_PARAMETERS_REQUEST_CDMA2000 = Seq(
    [
        M(
            "crit_exts",
            Choice(
                [
                    ("csfb_params_request_cdma2000_r8",
                     Seq([O("non_crit_ext", _LATE_NONCRIT)])),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        )
    ]
)

UL_HANDOVER_PREPARATION_TRANSFER = Seq(
    [
        M(
            "crit_exts",
            Choice(
                [
                    (
                        "c1",
                        c1_spares(
                            [
                                (
                                    "ul_ho_prep_transfer_r8",
                                    Seq(
                                        [
                                            M("cdma2000_type", CDMA2000_TYPE),
                                            O("meid", BitStr(56)),
                                            M("ded_info", OctStr()),
                                            O("non_crit_ext", _LATE_NONCRIT),
                                        ]
                                    ),
                                )
                            ],
                            3,
                        ),
                    ),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        )
    ]
)

DRB_COUNT_INFO = Seq(
    [
        M("drb_id", Int(1, 32)),
        M("count_ul", Int(0, 4294967295)),
        M("count_dl", Int(0, 4294967295)),
    ]
)

COUNTER_CHECK_RESPONSE = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            Choice(
                [
                    (
                        "counter_check_resp_r8",
                        Seq(
                            [
                                M("drb_count_info_list", SeqOf(DRB_COUNT_INFO, 0, 11)),
                                O("non_crit_ext", _LATE_NONCRIT),
                            ]
                        ),
                    ),
                    ("crit_exts_future", Seq([])),
                ]
            ),
        ),
    ]
)

# RLF-Report-r9 root + the per-carrier MeasResult2 element types the
# r10+ extensions reference (reference rlf_report_r9_s,
# meas_result2_{eutra,utra,cdma2000}_r9_s)
MEAS_RESULT2_EUTRA_R9 = Seq(
    [
        M("carrier_freq_r9", ARFCN),
        M("meas_result_list_r9", SeqOf(MEAS_RESULT_EUTRA, 1, 8)),
    ]
)
MEAS_RESULT2_UTRA_R9 = Seq(
    [
        M("carrier_freq_r9", ARFCN_VALUE_UTRA),
        M("meas_result_list_r9", SeqOf(MEAS_RESULT_UTRA, 1, 8)),
    ]
)
MEAS_RESULT2_CDMA2000_R9 = Seq(
    [
        M("carrier_freq_r9", CARRIER_FREQ_CDMA2000),
        # the inner "list" is the full MeasResultsCDMA2000 struct
        # (pre-registration flag + list), per reference
        # meas_result2_cdma2000_r9_s
        M("meas_result_list_r9", MEAS_RESULTS_CDMA2000),
    ]
)

RLF_REPORT_R9 = Seq(
    [
        M(
            "meas_result_last_serv_cell_r9",
            Seq([M("rsrp_result_r9", Int(0, 97)), O("rsrq_result_r9", Int(0, 34))]),
        ),
        O(
            "meas_result_neigh_cells_r9",
            Seq(
                [
                    O("meas_result_list_eutra_r9", SeqOf(MEAS_RESULT2_EUTRA_R9, 1, 8)),
                    O("meas_result_list_utra_r9", SeqOf(MEAS_RESULT2_UTRA_R9, 1, 8)),
                    O("meas_result_list_geran_r9", SeqOf(MEAS_RESULT_GERAN, 1, 8)),
                    O("meas_results_cdma2000_r9", SeqOf(MEAS_RESULT2_CDMA2000_R9, 1, 8)),
                ]
            ),
        ),
    ],
    ext=True,
)

UE_INFORMATION_RESPONSE_R9 = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1_alt(
                "ue_info_resp_r9",
                Seq(
                    [
                        O(
                            "rach_report_r9",
                            Seq(
                                [
                                    M("nof_preambs_sent_r9", Int(1, 200)),
                                    M("contention_detected_r9", Bool()),
                                ]
                            ),
                        ),
                        O("rlf_report_r9", RLF_REPORT_R9),
                        O("non_crit_ext", _LATE_NONCRIT),
                    ]
                ),
                3,
            ),
        ),
    ]
)

PROXIMITY_INDICATION_R9 = Seq(
    [
        M(
            "crit_exts",
            crit_ext_c1_alt(
                "proximity_ind_r9",
                Seq(
                    [
                        M("type_r9", Enum(["entering", "leaving"])),
                        M(
                            "carrier_freq_r9",
                            Choice(
                                [("eutra_r9", ARFCN), ("utra_r9", ARFCN_VALUE_UTRA)],
                                ext=True,
                                ext_alts=[("eutra2_v9e0", Int(65536, 262143))],
                            ),
                        ),
                        O("non_crit_ext", _LATE_NONCRIT),
                    ]
                ),
                3,
            ),
        ),
    ]
)

RN_RECONFIGURATION_COMPLETE_R10 = Seq(
    [
        M("rrc_transaction_id", Int(0, 3)),
        M(
            "crit_exts",
            crit_ext_c1_alt(
                "rn_recfg_complete_r10",
                Seq(
                    [
                        O("late_non_crit_ext", OctStr()),
                        O("non_crit_ext", Seq([])),
                    ]
                ),
                3,
            ),
        ),
    ]
)

MBMS_COUNTING_RESPONSE_R10 = Seq(
    [
        M(
            "crit_exts",
            crit_ext_c1_alt(
                "count_resp_r10",
                Seq(
                    [
                        O("mbsfn_area_idx_r10", Int(0, 7)),
                        O(
                            "count_resp_list_r10",
                            SeqOf(Seq([M("count_resp_service_r10", Int(0, 15))],
                                      ext=True), 1, 16),
                        ),
                        O("late_non_crit_ext", OctStr()),
                        O("non_crit_ext", Seq([])),
                    ]
                ),
                3,
            ),
        ),
    ]
)

RSTD_INTER_FREQ_INFO_R10 = Seq(
    [
        M("carrier_freq_r10", ARFCN),
        M("meas_prs_offset_r10", Int(0, 39)),
    ],
    ext=True,
)

INTER_FREQ_RSTD_MEASUREMENT_INDICATION_R10 = Seq(
    [
        M(
            "crit_exts",
            crit_ext_c1_alt(
                "inter_freq_rstd_meas_ind_r10",
                Seq(
                    [
                        M(
                            "rstd_inter_freq_ind_r10",
                            Choice(
                                [
                                    (
                                        "start",
                                        Seq(
                                            [
                                                M(
                                                    "rstd_inter_freq_info_list_r10",
                                                    SeqOf(RSTD_INTER_FREQ_INFO_R10, 1, 3),
                                                )
                                            ]
                                        ),
                                    ),
                                    ("stop", Null()),
                                ]
                            ),
                        ),
                        O("late_non_crit_ext", OctStr()),
                        O("non_crit_ext", Seq([])),
                    ]
                ),
                3,
            ),
        ),
    ]
)

UL_DCCH_MESSAGE = Seq(
    [
        M(
            "msg",
            Choice(
                [
                    (
                        "c1",
                        Choice(
                            [
                                ("csfb_params_request_cdma2000", CSFB_PARAMETERS_REQUEST_CDMA2000),
                                ("meas_report", MEASUREMENT_REPORT),
                                ("rrc_conn_recfg_complete", RRC_CONN_RECFG_COMPLETE),
                                ("rrc_conn_reest_complete", RRC_CONN_REEST_COMPLETE),
                                ("rrc_conn_setup_complete", RRC_CONN_SETUP_COMPLETE),
                                ("security_mode_complete", SECURITY_MODE_COMPLETE),
                                ("security_mode_fail", SECURITY_MODE_FAILURE),
                                ("ue_cap_info", UE_CAPABILITY_INFORMATION),
                                ("ul_ho_prep_transfer", UL_HANDOVER_PREPARATION_TRANSFER),
                                ("ul_info_transfer", UL_INFO_TRANSFER),
                                ("counter_check_resp", COUNTER_CHECK_RESPONSE),
                                ("ue_info_resp_r9", UE_INFORMATION_RESPONSE_R9),
                                ("proximity_ind_r9", PROXIMITY_INDICATION_R9),
                                ("rn_recfg_complete_r10", RN_RECONFIGURATION_COMPLETE_R10),
                                ("mbms_count_resp_r10", MBMS_COUNTING_RESPONSE_R10),
                                ("inter_freq_rstd_meas_ind_r10", INTER_FREQ_RSTD_MEASUREMENT_INDICATION_R10),
                            ]
                        ),
                    ),
                    ("msg_class_ext", Seq([])),
                ]
            ),
        )
    ]
)

# ======================================================================
# System information: BCCH-DL-SCH (SIB1, SystemInformation/SIB2+)
# ======================================================================

AC_BARRING_CONFIG = Seq(
    [
        M(
            "ac_barr_factor",
            Enum(["p00", "p05", "p10", "p15", "p20", "p25", "p30", "p40",
                  "p50", "p60", "p70", "p75", "p80", "p85", "p90", "p95"]),
        ),
        M("ac_barr_time", Enum(["s4", "s8", "s16", "s32", "s64", "s128", "s256", "s512"])),
        M("ac_barr_for_special_ac", BitStr(5)),
    ]
)

BCCH_CONFIG = Seq([M("mod_period_coeff", Enum(["n2", "n4", "n8", "n16"]))])

PCCH_CONFIG = Seq(
    [
        M("default_paging_cycle", Enum(["rf32", "rf64", "rf128", "rf256"])),
        M(
            "nb",
            Enum(["four_t", "two_t", "one_t", "half_t", "quarter_t", "one_eighth_t",
                  "one_sixteenth_t", "one_thirty_second_t"]),
        ),
    ]
)

RADIO_RESOURCE_CONFIG_COMMON_SIB = Seq(
    [
        M("rach_cfg_common", RACH_CONFIG_COMMON),
        M("bcch_cfg", BCCH_CONFIG),
        M("pcch_cfg", PCCH_CONFIG),
        M("prach_cfg", PRACH_CONFIG_SIB),
        M("pdsch_cfg_common", PDSCH_CONFIG_COMMON),
        M("pusch_cfg_common", PUSCH_CONFIG_COMMON),
        M("pucch_cfg_common", PUCCH_CONFIG_COMMON),
        M("srs_ul_cfg_common", SRS_UL_CONFIG_COMMON),
        M("ul_pwr_ctrl_common", UL_POWER_CONTROL_COMMON),
        M("ul_cp_len", Enum(["len1", "len2"])),
    ],
    ext=True,
)

UE_TIMERS_AND_CONSTANTS = Seq(
    [
        M("t300", Enum(["ms100", "ms200", "ms300", "ms400", "ms600", "ms1000", "ms1500", "ms2000"])),
        M("t301", Enum(["ms100", "ms200", "ms300", "ms400", "ms600", "ms1000", "ms1500", "ms2000"])),
        M("t310", Enum(["ms0", "ms50", "ms100", "ms200", "ms500", "ms1000", "ms2000"])),
        M("n310", Enum(["n1", "n2", "n3", "n4", "n6", "n8", "n10", "n20"])),
        M("t311", Enum(["ms1000", "ms3000", "ms5000", "ms10000", "ms15000", "ms20000", "ms30000"])),
        M("n311", Enum(["n1", "n2", "n3", "n4", "n5", "n6", "n8", "n10"])),
    ],
    ext=True,
)

MBSFN_SUBFRAME_CONFIG = _MBSFN_SUBFRAME_CONFIG  # defined with the SCell section above

SIB2 = Seq(
    [
        O(
            "ac_barr_info",
            Seq(
                [
                    M("ac_barr_for_emergency", Bool()),
                    O("ac_barr_for_mo_sig", AC_BARRING_CONFIG),
                    O("ac_barr_for_mo_data", AC_BARRING_CONFIG),
                ]
            ),
        ),
        M("rr_cfg_common", RADIO_RESOURCE_CONFIG_COMMON_SIB),
        M("ue_timers_and_consts", UE_TIMERS_AND_CONSTANTS),
        M(
            "freq_info",
            Seq(
                [
                    O("ul_carrier_freq", ARFCN),
                    O("ul_bw", Enum(["n6", "n15", "n25", "n50", "n75", "n100"])),
                    M("add_spec_emission", Int(1, 32)),
                ]
            ),
        ),
        O("mbsfn_sf_cfg_list", SeqOf(MBSFN_SUBFRAME_CONFIG, 1, 8)),
        M("time_align_timer_common", TIME_ALIGN_TIMER),
    ],
    ext=True,
    ext_additions=[
        M("late_non_crit_ext", OctStr()),
    ],
)

# late-bind the full SIB2 schema into RN-SystemInformation-r10
RN_SYSTEM_INFORMATION_R10.fields[1] = O("sib_type2_r10", SIB2)

SIB_TYPE = Enum(
    ["sib_type3", "sib_type4", "sib_type5", "sib_type6", "sib_type7", "sib_type8",
     "sib_type9", "sib_type10", "sib_type11", "sib_type12_v920", "sib_type13_v920",
     "sib_type14_v1130", "sib_type15_v1130", "sib_type16_v1130", "sib_type17_v1250",
     "sib_type18_v1250"],
    ext=True,
    ext_names=["sib_type19_v1250", "sib_type20_v1310", "sib_type21_v1430",
               "sib_type24_v1530", "sib_type25_v1530", "sib_type26_v1530"],
)

SCHEDULING_INFO = Seq(
    [
        M("si_periodicity", Enum(["rf8", "rf16", "rf32", "rf64", "rf128", "rf256", "rf512"])),
        M("sib_map_info", SeqOf(SIB_TYPE, 0, 31)),
    ]
)

PLMN_IDENTITY_INFO = Seq(
    [
        M("plmn_id", PLMN_IDENTITY),
        M("cell_reserved_for_oper", Enum(["reserved", "not_reserved"])),
    ]
)

SIB1 = Seq(
    [
        M(
            "cell_access_related_info",
            Seq(
                [
                    M("plmn_id_list", SeqOf(PLMN_IDENTITY_INFO, 1, 6)),
                    M("tac", BitStr(16)),
                    M("cell_id", BitStr(28)),
                    M("cell_barred", Enum(["barred", "not_barred"])),
                    M("intra_freq_resel", Enum(["allowed", "not_allowed"])),
                    M("csg_ind", Bool()),
                    O("csg_id", BitStr(27)),
                ]
            ),
        ),
        M(
            "cell_sel_info",
            Seq([M("q_rx_lev_min", Int(-70, -22)), O("q_rx_lev_min_offset", Int(1, 8))]),
        ),
        O("p_max", Int(-30, 33)),
        M("freq_band_ind", Int(1, 64)),
        M("sched_info_list", SeqOf(SCHEDULING_INFO, 1, 32)),
        O("tdd_cfg", TDD_CONFIG),
        M("si_win_len", Enum(["ms1", "ms2", "ms5", "ms10", "ms15", "ms20", "ms40"])),
        M("sys_info_value_tag", Int(0, 31)),
        O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])),
    ]
)


SPEED_STATE_SCALE_FACTORS = Seq(
    [
        M("sf_medium", Enum(["o_dot25", "o_dot5", "o_dot75", "l_dot0"])),
        M("sf_high", Enum(["o_dot25", "o_dot5", "o_dot75", "l_dot0"])),
    ]
)

SIB3 = Seq(
    [
        M(
            "cell_resel_info_common",
            Seq(
                [
                    M(
                        "q_hyst",
                        Enum(["db0", "db1", "db2", "db3", "db4", "db5", "db6", "db8", "db10",
                              "db12", "db14", "db16", "db18", "db20", "db22", "db24"]),
                    ),
                    O(
                        "speed_state_resel_pars",
                        Seq(
                            [
                                M(
                                    "mob_state_params",
                                    Seq(
                                        [
                                            M("t_eval", Enum(["s30", "s60", "s120", "s180", "s240", "spare3", "spare2", "spare1"])),
                                            M("t_hyst_normal", Enum(["s30", "s60", "s120", "s180", "s240", "spare3", "spare2", "spare1"])),
                                            M("n_cell_change_medium", Int(1, 16)),
                                            M("n_cell_change_high", Int(1, 16)),
                                        ]
                                    ),
                                ),
                                M(
                                    "q_hyst_sf",
                                    Seq(
                                        [
                                            M("sf_medium", Enum(["db_minus6", "db_minus4", "db_minus2", "db0"])),
                                            M("sf_high", Enum(["db_minus6", "db_minus4", "db_minus2", "db0"])),
                                        ]
                                    ),
                                ),
                            ]
                        ),
                    ),
                ]
            ),
        ),
        M(
            "cell_resel_serving_freq_info",
            Seq(
                [
                    O("s_non_intra_search", Int(0, 31)),
                    M("thresh_serving_low", Int(0, 31)),
                    M("cell_resel_prio", Int(0, 7)),
                ]
            ),
        ),
        M(
            "intra_freq_cell_resel_info",
            Seq(
                [
                    M("q_rx_lev_min", Int(-70, -22)),
                    O("p_max", Int(-30, 33)),
                    O("s_intra_search", Int(0, 31)),
                    O("allowed_meas_bw", Enum(["mbw6", "mbw15", "mbw25", "mbw50", "mbw75", "mbw100"])),
                    M("presence_ant_port1", Bool()),
                    M("neigh_cell_cfg", BitStr(2)),
                    M("t_resel_eutra", Int(0, 7)),
                    O("t_resel_eutra_sf", SPEED_STATE_SCALE_FACTORS),
                ]
            ),
        ),
    ],
    ext=True,
    ext_additions=[
        M("late_non_crit_ext", OctStr()),
    ],
)

# ---------------------------------------------------------------------
# SIB4-SIB13 (TS 36.331 §6.3.1; reference sib_type{4..13}_s).  Root
# fields are complete; release-10+ extension-addition groups arrive as
# unknown groups and round-trip bit-exactly via the engine's raw
# preservation (per.py Seq "_extN").
# ---------------------------------------------------------------------

INTRA_FREQ_NEIGH_CELL_INFO = Seq(
    [M("pci", PHYS_CELL_ID), M("q_offset_cell", Q_OFFSET_RANGE)], ext=True
)

SIB4 = Seq(
    [
        O("intra_freq_neigh_cell_list", SeqOf(INTRA_FREQ_NEIGH_CELL_INFO, 1, 16)),
        O("intra_freq_black_cell_list", SeqOf(PHYS_CELL_ID_RANGE, 1, 16)),
        O("csg_pci_range", PHYS_CELL_ID_RANGE),
    ],
    ext=True,
    ext_additions=[
        [O("late_non_crit_ext", OctStr())],
        [O("intra_freq_neigh_hsdn_cell_list_r15", SeqOf(PHYS_CELL_ID_RANGE, 1, 16))],
    ],
)

INTER_FREQ_NEIGH_CELL_INFO = Seq(
    [M("pci", PHYS_CELL_ID), M("q_offset_cell", Q_OFFSET_RANGE)]
)

INTER_FREQ_CARRIER_FREQ_INFO = Seq(
    [
        M("dl_carrier_freq", ARFCN),
        M("q_rx_lev_min", Int(-70, -22)),
        O("p_max", Int(-30, 33)),
        M("t_resel_eutra", Int(0, 7)),
        O("t_resel_eutra_sf", SPEED_STATE_SCALE_FACTORS),
        M("thresh_x_high", Int(0, 31)),
        M("thresh_x_low", Int(0, 31)),
        M("allowed_meas_bw", Enum(["mbw6", "mbw15", "mbw25", "mbw50", "mbw75", "mbw100"])),
        M("presence_ant_port1", Bool()),
        O("cell_resel_prio", Int(0, 7)),
        M("neigh_cell_cfg", BitStr(2)),
        D("q_offset_freq", Q_OFFSET_RANGE, "db0"),
        O("inter_freq_neigh_cell_list", SeqOf(INTER_FREQ_NEIGH_CELL_INFO, 1, 16)),
        O("inter_freq_black_cell_list", SeqOf(PHYS_CELL_ID_RANGE, 1, 16)),
    ],
    ext=True,
    ext_additions=[
        [
            O("q_qual_min_r9", Int(-34, -3)),
            O("thresh_x_q_r9", Seq([M("thresh_x_high_q_r9", Int(0, 31)),
                                    M("thresh_x_low_q_r9", Int(0, 31))])),
        ],
        [O("q_qual_min_wb_r11", Int(-34, -3))],
    ],
)

SIB5 = Seq(
    [M("inter_freq_carrier_freq_list", SeqOf(INTER_FREQ_CARRIER_FREQ_INFO, 1, 8))],
    ext=True,
    ext_additions=[[O("late_non_crit_ext", OctStr())]],
)

CARRIER_FREQ_UTRA_FDD = Seq(
    [
        M("carrier_freq", ARFCN_VALUE_UTRA),
        O("cell_resel_prio", Int(0, 7)),
        M("thresh_x_high", Int(0, 31)),
        M("thresh_x_low", Int(0, 31)),
        M("q_rx_lev_min", Int(-60, -13)),
        M("p_max_utra", Int(-50, 33)),
        M("q_qual_min", Int(-24, 0)),
    ],
    ext=True,
    ext_additions=[
        [O("thresh_x_q_r9", Seq([M("thresh_x_high_q_r9", Int(0, 31)),
                                 M("thresh_x_low_q_r9", Int(0, 31))]))],
    ],
)

CARRIER_FREQ_UTRA_TDD = Seq(
    [
        M("carrier_freq", ARFCN_VALUE_UTRA),
        O("cell_resel_prio", Int(0, 7)),
        M("thresh_x_high", Int(0, 31)),
        M("thresh_x_low", Int(0, 31)),
        M("q_rx_lev_min", Int(-60, -13)),
        M("p_max_utra", Int(-50, 33)),
    ],
    ext=True,
)

SIB6 = Seq(
    [
        O("carrier_freq_list_utra_fdd", SeqOf(CARRIER_FREQ_UTRA_FDD, 1, 16)),
        O("carrier_freq_list_utra_tdd", SeqOf(CARRIER_FREQ_UTRA_TDD, 1, 16)),
        M("t_resel_utra", Int(0, 7)),
        O("t_resel_utra_sf", SPEED_STATE_SCALE_FACTORS),
    ],
    ext=True,
    ext_additions=[[O("late_non_crit_ext", OctStr())]],
)

CARRIER_FREQS_INFO_GERAN = Seq(
    [
        M("carrier_freqs", CARRIER_FREQS_GERAN),
        M(
            "common_info",
            Seq(
                [
                    O("cell_resel_prio", Int(0, 7)),
                    M("ncc_permitted", BitStr(8)),
                    M("q_rx_lev_min", Int(0, 45)),
                    O("p_max_geran", Int(0, 39)),
                    M("thresh_x_high", Int(0, 31)),
                    M("thresh_x_low", Int(0, 31)),
                ]
            ),
        ),
    ],
    ext=True,
)

SIB7 = Seq(
    [
        M("t_resel_geran", Int(0, 7)),
        O("t_resel_geran_sf", SPEED_STATE_SCALE_FACTORS),
        O("carrier_freqs_info_list", SeqOf(CARRIER_FREQS_INFO_GERAN, 1, 16)),
    ],
    ext=True,
    ext_additions=[O("late_non_crit_ext", OctStr())],
)

# --- SIB8 (CDMA2000) supporting structures ---

SYS_TIME_INFO_CDMA2000 = Seq(
    [
        M("cdma_eutra_synchronisation", Bool()),
        M(
            "cdma_sys_time",
            Choice([("sync_sys_time", BitStr(39)), ("async_sys_time", BitStr(49))]),
        ),
    ]
)

BAND_CLASS_INFO_CDMA2000 = Seq(
    [
        M("band_class", BANDCLASS_CDMA2000),
        O("cell_resel_prio", Int(0, 7)),
        M("thresh_x_high", Int(0, 63)),
        M("thresh_x_low", Int(0, 63)),
    ],
    ext=True,
)

NEIGH_CELLS_PER_BANDCLASS_CDMA2000 = Seq(
    [
        M("arfcn", ARFCN_VALUE_CDMA2000),
        M("pci_list", SeqOf(PHYS_CELL_ID_CDMA2000, 1, 16)),
    ]
)

NEIGH_CELL_CDMA2000 = Seq(
    [
        M("band_class", BANDCLASS_CDMA2000),
        M("neigh_cells_per_freq_list", SeqOf(NEIGH_CELLS_PER_BANDCLASS_CDMA2000, 1, 16)),
    ]
)

CELL_RESELECTION_PARAMS_CDMA2000 = Seq(
    [
        M("band_class_list", SeqOf(BAND_CLASS_INFO_CDMA2000, 1, 32)),
        M("neigh_cell_list", SeqOf(NEIGH_CELL_CDMA2000, 1, 16)),
        M("t_resel_cdma2000", Int(0, 7)),
        O("t_resel_cdma2000_sf", SPEED_STATE_SCALE_FACTORS),
    ]
)

CSFB_REGISTRATION_PARAM_1XRTT = Seq(
    [
        M("sid", BitStr(15)),
        M("nid", BitStr(16)),
        M("multiple_sid", Bool()),
        M("multiple_nid", Bool()),
        M("home_reg", Bool()),
        M("foreign_sid_reg", Bool()),
        M("foreign_nid_reg", Bool()),
        M("param_reg", Bool()),
        M("pwr_up_reg", Bool()),
        M("regist_period", BitStr(7)),
        M("regist_zone", BitStr(12)),
        M("total_zone", BitStr(3)),
        M("zone_timer", BitStr(3)),
    ]
)

SIB8 = Seq(
    [
        O("sys_time_info", SYS_TIME_INFO_CDMA2000),
        O("search_win_size", Int(0, 15)),
        O(
            "params_hrpd",
            Seq(
                [
                    M("pre_regist_info_hrpd", PRE_REGISTRATION_INFO_HRPD),
                    O("cell_resel_params_hrpd", CELL_RESELECTION_PARAMS_CDMA2000),
                ]
            ),
        ),
        O(
            "params1_xrtt",
            Seq(
                [
                    O("csfb_regist_param1_xrtt", CSFB_REGISTRATION_PARAM_1XRTT),
                    O("long_code_state1_xrtt", BitStr(42)),
                    O("cell_resel_params1_xrtt", CELL_RESELECTION_PARAMS_CDMA2000),
                ]
            ),
        ),
    ],
    ext=True,
    ext_additions=[[O("late_non_crit_ext", OctStr())]],
)

SIB9 = Seq(
    # SIZE(1..48) in the spec; the reference's generator encodes it as an
    # UNCONSTRAINED octet string (dyn_octstring, 8-bit length) — match it
    [O("hnb_name", OctStr())],
    ext=True,
    ext_additions=[O("late_non_crit_ext", OctStr())],
)

SIB10 = Seq(
    [
        M("msg_id", BitStr(16)),
        M("serial_num", BitStr(16)),
        M("warning_type", OctStr(2, 2)),
        O("dummy", OctStr(50, 50)),
    ],
    ext=True,
    ext_additions=[O("late_non_crit_ext", OctStr())],
)

WARNING_MSG_SEGMENT_TYPE = Enum(["not_last_segment", "last_segment"])

SIB11 = Seq(
    [
        M("msg_id", BitStr(16)),
        M("serial_num", BitStr(16)),
        M("warning_msg_segment_type", WARNING_MSG_SEGMENT_TYPE),
        M("warning_msg_segment_num", Int(0, 63)),
        M("warning_msg_segment", OctStr()),
        O("data_coding_scheme", OctStr(1, 1)),
    ],
    ext=True,
    ext_additions=[O("late_non_crit_ext", OctStr())],
)

SIB12_R9 = Seq(
    [
        M("msg_id_r9", BitStr(16)),
        M("serial_num_r9", BitStr(16)),
        M("warning_msg_segment_type_r9", WARNING_MSG_SEGMENT_TYPE),
        M("warning_msg_segment_num_r9", Int(0, 63)),
        M("warning_msg_segment_r9", OctStr()),
        O("data_coding_scheme_r9", OctStr(1, 1)),
        O("late_non_crit_ext", OctStr()),
    ],
    ext=True,
    ext_additions=[
        [O("warning_area_coordinates_segment_r15", OctStr())],
    ],
)

MBSFN_AREA_INFO_R9 = Seq(
    [
        M("mbsfn_area_id_r9", Int(0, 255)),
        M("non_mbsfn_region_len", Enum(["s1", "s2"])),
        M("notif_ind_r9", Int(0, 7)),
        M(
            "mcch_cfg_r9",
            Seq(
                [
                    M("mcch_repeat_period_r9", Enum(["rf32", "rf64", "rf128", "rf256"])),
                    M("mcch_offset_r9", Int(0, 10)),
                    M("mcch_mod_period_r9", Enum(["rf512", "rf1024"])),
                    M("sf_alloc_info_r9", BitStr(6)),
                    M("sig_mcs_r9", Enum(["n2", "n7", "n13", "n19"])),
                ]
            ),
        ),
    ],
    ext=True,
)

MBMS_NOTIFICATION_CONFIG_R9 = Seq(
    [
        M("notif_repeat_coeff_r9", Enum(["n2", "n4"])),
        M("notif_offset_r9", Int(0, 10)),
        M("notif_sf_idx_r9", Int(1, 6)),
    ]
)

SIB13_R9 = Seq(
    [
        M("mbsfn_area_info_list_r9", SeqOf(MBSFN_AREA_INFO_R9, 1, 8)),
        M("notif_cfg_r9", MBMS_NOTIFICATION_CONFIG_R9),
        O("late_non_crit_ext", OctStr()),
    ],
    ext=True,
)

SIB_TYPE_AND_INFO_ITEM = Choice(
    [
        ("sib2", SIB2),
        ("sib3", SIB3),
        ("sib4", SIB4),
        ("sib5", SIB5),
        ("sib6", SIB6),
        ("sib7", SIB7),
        ("sib8", SIB8),
        ("sib9", SIB9),
        ("sib10", SIB10),
        ("sib11", SIB11),
    ],
    ext=True,
    ext_alts=[
        ("sib12_v920", SIB12_R9),
        ("sib13_v920", SIB13_R9),
    ],
)

SYSTEM_INFORMATION = Seq(
    [
        M(
            "crit_exts",
            Choice(
                [
                    (
                        "sys_info_r8",
                        Seq(
                            [
                                M("sib_type_and_info", SeqOf(SIB_TYPE_AND_INFO_ITEM, 1, 32)),
                                O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])),
                            ]
                        ),
                    ),
                    ("crit_exts_future_r15", Seq([])),
                ]
            ),
        ),
    ]
)

BCCH_DL_SCH_MESSAGE = Seq(
    [
        M(
            "msg",
            Choice(
                [
                    ("c1", Choice([("sys_info", SYSTEM_INFORMATION), ("sib_type1", SIB1)])),
                    ("msg_class_ext", Seq([])),
                ]
            ),
        )
    ]
)

# ======================================================================
# MCCH (MBSFNAreaConfiguration-r9) and PCCH (Paging)
# ======================================================================

TMGI_R9 = Seq(
    [
        M("plmn_id_r9", Choice([("plmn_idx_r9", Int(1, 6)), ("explicit_value_r9", PLMN_IDENTITY)])),
        M("service_id_r9", OctStr(3, 3)),
    ]
)

MBMS_SESSION_INFO_R9 = Seq(
    [
        M("tmgi_r9", TMGI_R9),
        O("session_id_r9", OctStr(1, 1)),
        M("lc_ch_id_r9", Int(0, 28)),
    ],
    ext=True,
)

PMCH_CONFIG_R9 = Seq(
    [
        M("sf_alloc_end_r9", Int(0, 1535)),
        M("data_mcs_r9", Int(0, 28)),
        M("mch_sched_period_r9", Enum(["rf8", "rf16", "rf32", "rf64", "rf128", "rf256", "rf512", "rf1024"])),
    ],
    ext=True,
)

PMCH_INFO_R9 = Seq(
    [
        M("pmch_cfg_r9", PMCH_CONFIG_R9),
        M("mbms_session_info_list_r9", SeqOf(MBMS_SESSION_INFO_R9, 0, 29)),
    ],
    ext=True,
)

MBSFN_AREA_CONFIGURATION_R9 = Seq(
    [
        M("common_sf_alloc_r9", SeqOf(MBSFN_SUBFRAME_CONFIG, 1, 8)),
        M("common_sf_alloc_period_r9", Enum(["rf4", "rf8", "rf16", "rf32", "rf64", "rf128", "rf256"])),
        M("pmch_info_list_r9", SeqOf(PMCH_INFO_R9, 0, 15)),
        O("non_crit_ext", Seq([])),
    ]
)

# MBMSCountingRequest-r10 (reference mbms_count_request_r10_s)
MBMS_COUNTING_REQUEST_R10 = Seq(
    [
        M(
            "count_request_list_r10",
            SeqOf(Seq([M("tmgi_r10", TMGI_R9)], ext=True), 1, 16),
        ),
        O("late_non_crit_ext", OctStr()),
        O("non_crit_ext", Seq([])),
    ]
)

MCCH_MESSAGE = Seq(
    [
        M(
            "msg",
            Choice(
                [
                    ("c1", Choice([("mbsfn_area_cfg_r9", MBSFN_AREA_CONFIGURATION_R9)])),
                    (
                        "later",
                        Choice(
                            [
                                ("c2", Choice([("mbms_count_request_r10", MBMS_COUNTING_REQUEST_R10)])),
                                ("msg_class_ext", Seq([])),
                            ]
                        ),
                    ),
                ]
            ),
        )
    ]
)

IMSI = SeqOf(MCC_MNC_DIGIT, 6, 21)

PAGING_RECORD = Seq(
    [
        M("ue_id", Choice([("s_tmsi", S_TMSI), ("imsi", IMSI)], ext=True)),
        M("cn_domain", Enum(["ps", "cs"])),
    ],
    ext=True,
)

PAGING = Seq(
    [
        O("paging_record_list", SeqOf(PAGING_RECORD, 1, 16)),
        O("sys_info_mod", Enum(["true_value"])),
        O("etws_ind", Enum(["true_value"])),
        O("non_crit_ext", Seq([O("late_non_crit_ext", OctStr()), O("non_crit_ext", Seq([]))])),
    ]
)

PCCH_MESSAGE = Seq(
    [M("msg", Choice([("c1", Choice([("paging", PAGING)])), ("msg_class_ext", Seq([]))]))]
)
