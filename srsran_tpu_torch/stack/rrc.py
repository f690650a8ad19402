"""Host copy of `srsran_tpu/stack/rrc.py`, held to it by `tests/test_torch_stack.py`.

RRC message plane: real TS 36.331 UPER encodings over asn1.rrc.

Replaces the reference's generated codec usage in `srsue/src/stack/rrc/
rrc.cc` and `srsenb/src/stack/rrc/rrc.cc` with builder/parser helpers for
the procedure set the stack runs: connection establishment, NAS transfer,
AS security activation, reconfiguration with DRB setup, release.

CCCH messages (ConnectionRequest/Setup) ride SRB0 = RLC TM; everything
else rides SRB1 = RLC AM under PDCP with integrity.  Contention
resolution uses the MAC UE Contention Resolution Identity CE (first 48
bits of the UL CCCH SDU, TS 36.321 §6.1.3.4) — see stack/mac_pdu.py.
"""

from __future__ import annotations

from .asn1 import rrc as asn1

# indices map the stack's integer algorithm ids (security.py: 0=EEA0/EIA0,
# 1=SNOW3G, 2=AES, 3=ZUC) onto the 36.331 enumerators
CIPHER_ALGS = ["eea0", "eea1", "eea2", "eea3_v1130"]
INTEG_ALGS = ["eia0_v920", "eia1", "eia2", "eia3_v1130"]

_NON_CRIT = "non_crit_ext"


# ----------------------------------------------------------- UL-CCCH / Msg3


def pack_conn_request(ue_identity: bytes, cause: str = "mo_data",
                      s_tmsi: tuple[int, int] | None = None) -> bytes:
    """RRCConnectionRequest: 40-bit random ue-Identity, or the (mmec,
    m_tmsi) S-TMSI when the UE has a registered NAS context (idle-mode
    resume — the eNB forwards it in the S1AP Initial UE Message)."""
    if s_tmsi is not None:
        ue_id = ("s_tmsi", {"mmec": s_tmsi[0], "m_tmsi": s_tmsi[1]})
    else:
        assert len(ue_identity) == 5
        ue_id = ("random_value", int.from_bytes(ue_identity, "big"))
    v = {
        "msg": ("c1", ("rrc_conn_request", {
            "crit_exts": ("rrc_conn_request_r8", {
                "ue_id": ue_id,
                "establishment_cause": cause,
                "spare": 0,
            }),
        })),
    }
    return asn1.UL_CCCH_MESSAGE.to_bytes(v)


def unpack_ul_ccch(data: bytes):
    v = asn1.UL_CCCH_MESSAGE.from_bytes(data)
    kind, msg = v["msg"][1]
    return kind, msg["crit_exts"][1]


def conn_request_identity(fields: dict) -> bytes:
    """The ue-Identity of a decoded ConnectionRequest, as bytes."""
    kind, val = fields["ue_id"]
    if kind == "random_value":
        return val.to_bytes(5, "big")
    return val["mmec"].to_bytes(1, "big") + val["m_tmsi"].to_bytes(4, "big")


def contention_resolution_id(ccch_sdu: bytes) -> bytes:
    """UE Contention Resolution Identity = first 48 bits of the UL CCCH SDU
    (TS 36.321 §6.1.3.4)."""
    return (ccch_sdu + b"\x00" * 6)[:6]


# ----------------------------------------------------------- DL-CCCH / Msg4

# Default SRB1 + dedicated-PHY configuration carried by ConnectionSetup —
# values mirror srsenb's defaults (rr.conf.example / rrc_ue.cc).
_SRB1_CFG = {
    "srb_id": 1,
    "rlc_cfg": ("explicit_value", ("am", {
        "ul_am_rlc": {"t_poll_retx": "ms60", "poll_pdu": "pinfinity",
                      "poll_byte": "kbinfinity", "max_retx_thres": "t32"},
        "dl_am_rlc": {"t_reordering": "ms45", "t_status_prohibit": "ms0"},
    })),
    "lc_ch_cfg": ("default_value", None),
}


def default_rr_cfg_ded() -> dict:
    return {
        "srb_to_add_mod_list": [dict(_SRB1_CFG)],
        "mac_main_cfg": ("explicit_value", {
            "ul_sch_cfg": {"max_harq_tx": "n5", "periodic_bsr_timer": "sf20",
                           "retx_bsr_timer": "sf320", "tti_bundling": False},
            "time_align_timer_ded": "infinity",
            "phr_cfg": ("release", None),
        }),
        "phys_cfg_ded": {
            "pdsch_cfg_ded": {"p_a": "db0"},
            "pusch_cfg_ded": {"beta_offset_ack_idx": 9, "beta_offset_ri_idx": 6,
                              "beta_offset_cqi_idx": 6},
            "sched_request_cfg": ("setup", {"sr_pucch_res_idx": 0, "sr_cfg_idx": 15,
                                            "dsr_trans_max": "n64"}),
        },
    }


def pack_conn_setup(transaction_id: int = 0) -> bytes:
    v = {
        "msg": ("c1", ("rrc_conn_setup", {
            "rrc_transaction_id": transaction_id,
            "crit_exts": ("c1", ("rrc_conn_setup_r8", {"rr_cfg_ded": default_rr_cfg_ded()})),
        })),
    }
    return asn1.DL_CCCH_MESSAGE.to_bytes(v)


def unpack_dl_ccch(data: bytes):
    v = asn1.DL_CCCH_MESSAGE.from_bytes(data)
    kind, msg = v["msg"][1]
    crit = msg["crit_exts"]
    body = crit[1][1] if crit[0] == "c1" else crit[1]
    return kind, body


# ------------------------------------------------------------------ UL-DCCH


def pack_conn_setup_complete(nas_pdu: bytes, transaction_id: int = 0) -> bytes:
    v = {
        "msg": ("c1", ("rrc_conn_setup_complete", {
            "rrc_transaction_id": transaction_id,
            "crit_exts": ("c1", ("rrc_conn_setup_complete_r8", {
                "sel_plmn_id": 1,
                "ded_info_nas": nas_pdu,
            })),
        })),
    }
    return asn1.UL_DCCH_MESSAGE.to_bytes(v)


def pack_ul_info_transfer(nas_pdu: bytes) -> bytes:
    v = {
        "msg": ("c1", ("ul_info_transfer", {
            "crit_exts": ("c1", ("ul_info_transfer_r8", {
                "ded_info_type": ("ded_info_nas", nas_pdu),
            })),
        })),
    }
    return asn1.UL_DCCH_MESSAGE.to_bytes(v)


def pack_security_mode_complete(transaction_id: int = 0) -> bytes:
    v = {
        "msg": ("c1", ("security_mode_complete", {
            "rrc_transaction_id": transaction_id,
            "crit_exts": ("security_mode_complete_r8", {}),
        })),
    }
    return asn1.UL_DCCH_MESSAGE.to_bytes(v)


def pack_reconfiguration_complete(transaction_id: int = 0) -> bytes:
    v = {
        "msg": ("c1", ("rrc_conn_recfg_complete", {
            "rrc_transaction_id": transaction_id,
            "crit_exts": ("rrc_conn_recfg_complete_r8", {}),
        })),
    }
    return asn1.UL_DCCH_MESSAGE.to_bytes(v)


def unpack_ul_dcch(data: bytes):
    v = asn1.UL_DCCH_MESSAGE.from_bytes(data)
    kind, msg = v["msg"][1]
    crit = msg.get("crit_exts")
    body = crit[1][1] if crit[0] == "c1" else crit[1]
    return kind, body


# ------------------------------------------------------------------ DL-DCCH


def pack_dl_info_transfer(nas_pdu: bytes, transaction_id: int = 0) -> bytes:
    v = {
        "msg": ("c1", ("dl_info_transfer", {
            "rrc_transaction_id": transaction_id,
            "crit_exts": ("c1", ("dl_info_transfer_r8", {
                "ded_info_type": ("ded_info_nas", nas_pdu),
            })),
        })),
    }
    return asn1.DL_DCCH_MESSAGE.to_bytes(v)


def pack_security_mode_command(cipher_alg: int, integ_alg: int, transaction_id: int = 0) -> bytes:
    v = {
        "msg": ("c1", ("security_mode_cmd", {
            "rrc_transaction_id": transaction_id,
            "crit_exts": ("c1", ("security_mode_cmd_r8", {
                "security_cfg_smc": {"security_algorithm_cfg": {
                    "ciphering_algorithm": CIPHER_ALGS[cipher_alg],
                    "integrity_prot_algorithm": INTEG_ALGS[integ_alg],
                }},
            })),
        })),
    }
    return asn1.DL_DCCH_MESSAGE.to_bytes(v)


def _default_drb(drb_id: int, lcid: int, eps_bearer_id: int) -> dict:
    return {
        "eps_bearer_id": eps_bearer_id,
        "drb_id": drb_id,
        "pdcp_cfg": {
            "discard_timer": "infinity",
            "rlc_am": {"status_report_required": False},
            "hdr_compress": ("not_used", None),
        },
        "rlc_cfg": ("am", {
            "ul_am_rlc": {"t_poll_retx": "ms120", "poll_pdu": "p64",
                          "poll_byte": "kb750", "max_retx_thres": "t16"},
            "dl_am_rlc": {"t_reordering": "ms50", "t_status_prohibit": "ms50"},
        }),
        "lc_ch_id": lcid,
        "lc_ch_cfg": {
            "ul_specific_params": {"prio": 13, "prioritised_bit_rate": "kbps8",
                                   "bucket_size_dur": "ms100", "lc_ch_group": 2},
        },
    }


# ------------------------------------------------------------------ PCCH


def pack_pcch_paging(m_tmsi: int, mmec: int = 1) -> bytes:
    """One-record PCCH Paging by S-TMSI (TS 36.331 §5.3.2; the PHY-side
    counterpart of the S1AP Paging the MME sends)."""
    v = {"msg": ("c1", ("paging", {
        "paging_record_list": [
            {"ue_id": ("s_tmsi", {"mmec": mmec, "m_tmsi": m_tmsi}), "cn_domain": "ps"},
        ],
    }))}
    return asn1.PCCH_MESSAGE.to_bytes(v)


def unpack_pcch(data: bytes) -> list[tuple]:
    """Decoded paging records: [(kind, id), ...]."""
    v = asn1.PCCH_MESSAGE.from_bytes(data)
    kind, body = v["msg"][1]
    if kind != "paging":
        return []
    return [r["ue_id"] for r in body.get("paging_record_list", [])]


# ---------------------------------------------------------- re-establishment


def short_mac_i(k_enb: bytes, integ_alg: int, pci: int, crnti: int, cell_id: int) -> int:
    """16-bit shortMAC-I over VarShortMAC-Input (TS 36.331 §7.4: cellId,
    physCellId, c-RNTI) with COUNT/bearer/direction all-ones as in the
    reference's rrc.cc re-establishment token."""
    from . import security as sec

    _, k_int, _ = sec.generate_as_keys(k_enb, 0, integ_alg)
    payload = cell_id.to_bytes(4, "big") + pci.to_bytes(2, "big") + crnti.to_bytes(2, "big")
    eia = {1: sec.eia1, 2: sec.eia2, 3: sec.eia3}[integ_alg]
    mac = eia(k_int, 0xFFFFFFFF, 0x1F, 1, payload)
    return int.from_bytes(mac[-2:], "big")


def pack_reest_request(crnti: int, pci: int, mac_i: int, cause: str = "other_fail") -> bytes:
    v = {"msg": ("c1", ("rrc_conn_reest_request", {
        "crit_exts": ("rrc_conn_reest_request_r8", {
            "ue_id": {"c_rnti": crnti, "pci": pci, "short_mac_i": mac_i},
            "reest_cause": cause,
            "spare": 0,
        }),
    }))}
    return asn1.UL_CCCH_MESSAGE.to_bytes(v)


def pack_reest(ncc: int = 0, transaction_id: int = 0) -> bytes:
    v = {"msg": ("c1", ("rrc_conn_reest", {
        "rrc_transaction_id": transaction_id,
        "crit_exts": ("c1", ("rrc_conn_reest_r8", {
            "rr_cfg_ded": {},
            "next_hop_chaining_count": ncc,
        })),
    }))}
    return asn1.DL_CCCH_MESSAGE.to_bytes(v)


def pack_reest_reject() -> bytes:
    v = {"msg": ("c1", ("rrc_conn_reest_reject", {
        "crit_exts": ("rrc_conn_reest_reject_r8", {}),
    }))}
    return asn1.DL_CCCH_MESSAGE.to_bytes(v)


def pack_reest_complete(transaction_id: int = 0) -> bytes:
    v = {"msg": ("c1", ("rrc_conn_reest_complete", {
        "rrc_transaction_id": transaction_id,
        "crit_exts": ("rrc_conn_reest_complete_r8", {}),
    }))}
    return asn1.UL_DCCH_MESSAGE.to_bytes(v)


# ------------------------------------------------------------------ BCCH-DL-SCH


def pack_sib1(cell_id: int, tac: int = 1, freq_band: int = 7,
              si_periodicity: str = "rf8") -> bytes:
    """SystemInformationBlockType1 (rrc_cell_cfg.cc fill of sib.conf): one
    PLMN 001/01, SIB2 in the first SI message (implicit per TS 36.331)."""
    v = {"msg": ("c1", ("sib_type1", {
        "cell_access_related_info": {
            "plmn_id_list": [{"plmn_id": {"mcc": [0, 0, 1], "mnc": [0, 1]},
                              "cell_reserved_for_oper": "not_reserved"}],
            "tac": tac,
            "cell_id": cell_id,
            "cell_barred": "not_barred",
            "intra_freq_resel": "allowed",
            "csg_ind": False,
        },
        "cell_sel_info": {"q_rx_lev_min": -65},
        "freq_band_ind": freq_band,
        "sched_info_list": [{"si_periodicity": si_periodicity, "sib_map_info": []}],
        "si_win_len": "ms5",
        "sys_info_value_tag": 0,
    }))}
    return asn1.BCCH_DL_SCH_MESSAGE.to_bytes(v)


def pack_sib2(nof_ra_preambles: int = 52, prach_config_index: int = 3,
              root_seq_idx: int = 0, n310: int = 4, t310_ms: int = 200,
              zero_corr_zone: int = 1, prach_freq_offset: int = 0,
              sib3: dict | None = None) -> bytes:
    """SystemInformation carrying SIB2 (the rr.conf/sib.conf analog);
    optionally SIB3 in the same SI message (sib.conf.example schedules
    sib2+sib3 together in si_mapping_info)."""
    sib2 = {
        "rr_cfg_common": {
            "rach_cfg_common": {
                "preamb_info": {"nof_ra_preambs": f"n{nof_ra_preambles}"},
                "pwr_ramp_params": {"pwr_ramp_step": "db4",
                                    "preamb_init_rx_target_pwr": "dbm_minus104"},
                "ra_supervision_info": {"preamb_trans_max": "n10",
                                        "ra_resp_win_size": "sf10",
                                        "mac_contention_resolution_timer": "sf64"},
                "max_harq_msg3_tx": 4,
            },
            "bcch_cfg": {"mod_period_coeff": "n2"},
            "pcch_cfg": {"default_paging_cycle": "rf128", "nb": "one_t"},
            "prach_cfg": {"root_seq_idx": root_seq_idx,
                          "prach_cfg_info": {"prach_cfg_idx": prach_config_index,
                                             "high_speed_flag": False,
                                             "zero_correlation_zone_cfg": zero_corr_zone,
                                             "prach_freq_offset": prach_freq_offset}},
            "pdsch_cfg_common": {"ref_sig_pwr": 0, "p_b": 0},
            "pusch_cfg_common": {
                "pusch_cfg_basic": {"n_sb": 1, "hop_mode": "inter_sub_frame",
                                    "pusch_hop_offset": 0, "enable64_qam": True},
                "ul_ref_sigs_pusch": {"group_hop_enabled": False, "group_assign_pusch": 0,
                                      "seq_hop_enabled": False, "cyclic_shift": 0},
            },
            "pucch_cfg_common": {"delta_pucch_shift": "ds2", "nrb_cqi": 1,
                                 "ncs_an": 0, "n1_pucch_an": 0},
            "srs_ul_cfg_common": ("release", None),
            "ul_pwr_ctrl_common": {
                "p0_nominal_pusch": -85, "alpha": "al07", "p0_nominal_pucch": -107,
                "delta_flist_pucch": {"delta_f_pucch_format1": "delta_f0",
                                      "delta_f_pucch_format1b": "delta_f3",
                                      "delta_f_pucch_format2": "delta_f1",
                                      "delta_f_pucch_format2a": "delta_f2",
                                      "delta_f_pucch_format2b": "delta_f2"},
                "delta_preamb_msg3": 4,
            },
            "ul_cp_len": "len1",
        },
        "ue_timers_and_consts": {
            "t300": "ms1000", "t301": "ms1000",
            "t310": f"ms{t310_ms}", "n310": f"n{n310}",
            "t311": "ms1000", "n311": "n1",
        },
        "freq_info": {"add_spec_emission": 1},
        "time_align_timer_common": "sf10240",
    }
    sibs = [("sib2", sib2)]
    if sib3 is not None:
        sibs.append(("sib3", sib3))
    v = {"msg": ("c1", ("sys_info", {
        "crit_exts": ("sys_info_r8", {"sib_type_and_info": sibs}),
    }))}
    return asn1.BCCH_DL_SCH_MESSAGE.to_bytes(v)


_Q_HYST_DB = [0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24]


def make_sib3(q_hyst_db: int = 4, q_rx_lev_min: int = -65,
              t_resel_eutra: int = 0) -> dict:
    """SystemInformationBlockType3 — the intra-frequency idle-mode cell
    reselection parameters (sib.conf [sib3], TS 36.331 §6.3.1).
    `q_rx_lev_min` is the IE value (actual threshold = 2×IE dBm)."""
    assert q_hyst_db in _Q_HYST_DB
    return {
        "cell_resel_info_common": {"q_hyst": f"db{q_hyst_db}"},
        "cell_resel_serving_freq_info": {"thresh_serving_low": 2, "cell_resel_prio": 3},
        "intra_freq_cell_resel_info": {
            "q_rx_lev_min": q_rx_lev_min,
            "presence_ant_port1": True,
            "neigh_cell_cfg": 0b01,
            "t_resel_eutra": t_resel_eutra,
        },
    }


def sib3_resel_params(sib3: dict) -> dict:
    """What the idle UE needs from SIB3 (rrc_cell.cc ranking inputs)."""
    intra = sib3["intra_freq_cell_resel_info"]
    return {
        "q_hyst_db": _Q_HYST_DB[
            ["db0", "db1", "db2", "db3", "db4", "db5", "db6", "db8", "db10", "db12",
             "db14", "db16", "db18", "db20", "db22", "db24"].index(
                sib3["cell_resel_info_common"]["q_hyst"])],
        "q_rx_lev_min_dbm": 2 * intra["q_rx_lev_min"],
        "t_resel_s": intra["t_resel_eutra"],
    }


def unpack_bcch_dl_sch(data: bytes):
    """Returns ("sib_type1", sib1_body) or ("sys_info", [(kind, body), ...])."""
    v = asn1.BCCH_DL_SCH_MESSAGE.from_bytes(data)
    kind, body = v["msg"][1]
    if kind == "sib_type1":
        return kind, body
    sibs = body["crit_exts"][1]["sib_type_and_info"]
    return kind, list(sibs)


def sib2_rach_params(sib2: dict) -> dict:
    """The RA parameters a UE needs before its first PRACH (proc_ra.cc
    reads exactly these from SIB2)."""
    rach = sib2["rr_cfg_common"]["rach_cfg_common"]
    prach = sib2["rr_cfg_common"]["prach_cfg"]
    timers = sib2["ue_timers_and_consts"]
    return {
        "nof_preambles": int(rach["preamb_info"]["nof_ra_preambs"][1:]),
        "prach_config_index": prach["prach_cfg_info"]["prach_cfg_idx"],
        "root_seq_idx": prach["root_seq_idx"],
        "zero_corr_zone": prach["prach_cfg_info"]["zero_correlation_zone_cfg"],
        "prach_freq_offset": prach["prach_cfg_info"]["prach_freq_offset"],
        "ra_resp_win_sf": int(rach["ra_supervision_info"]["ra_resp_win_size"][2:]),
        "n310": int(timers["n310"][1:]),
        "t310_ms": int(timers["t310"][2:]),
    }


def make_scell_config(scell_idx: int, pci: int, dl_arfcn: int, nof_prb: int,
                      nof_ports: int = 1) -> dict:
    """SCellToAddMod-r10 (TS 36.331 §6.3.2) — the rrc_ue.cc
    fill_scell_to_addmod_list analog for the CA reconfiguration."""
    bw = {6: "n6", 15: "n15", 25: "n25", 50: "n50", 75: "n75", 100: "n100"}[nof_prb]
    ports = {1: "an1", 2: "an2", 4: "an4"}[nof_ports]
    return {
        "scell_idx": scell_idx,
        "cell_identif": {"phys_cell_id": pci, "dl_carrier_freq": dl_arfcn},
        "rr_cfg_common_scell": {
            "non_ul_cfg": {
                "dl_bw": bw,
                "ant_info_common": {"ant_ports_count": ports},
                "phich_cfg": {"phich_dur": "normal", "phich_res": "one"},
                "pdsch_cfg_common": {"ref_sig_pwr": 0, "p_b": 0},
            },
        },
    }


def pack_reconfiguration(
    drb_id: int = 0,
    lcid: int = 0,
    eps_bearer_id: int = 0,
    nas_pdu: bytes = b"",
    transaction_id: int = 0,
    meas_cfg: dict | None = None,
    mob_ctrl: dict | None = None,
    security_ho_ncc: int | None = None,
    scells: list[dict] | None = None,
    scell_release: list[int] | None = None,
) -> bytes:
    """RRCConnectionReconfiguration, optionally with a DRB setup, a
    piggybacked NAS PDU, a measurement configuration, mobilityControlInfo
    (handover command), and/or R10 SCell add/release lists (carrier
    aggregation, carried in the v890→v920→v1020 nonCriticalExtension
    chain) — rrc_ue.cc send_connection_reconf / rrc_mobility.cc."""
    r8: dict = {}
    if meas_cfg is not None:
        r8["meas_cfg"] = meas_cfg
    if mob_ctrl is not None:
        r8["mob_ctrl_info"] = mob_ctrl
    if security_ho_ncc is not None:
        # securityConfigHO: vertical key derivation from NH (TS 33.401 §7.2.8)
        r8["security_cfg_ho"] = {"handov_type": ("intra_lte", {
            "key_change_ind": False, "next_hop_chaining_count": security_ho_ncc})}
    if drb_id:
        r8["rr_cfg_ded"] = {"drb_to_add_mod_list": [_default_drb(drb_id, lcid, eps_bearer_id)]}
    if nas_pdu:
        r8["ded_info_nas_list"] = [nas_pdu]
    if scells or scell_release:
        v1020: dict = {}
        if scell_release:
            v1020["scell_to_release_list"] = list(scell_release)
        if scells:
            v1020["scell_to_add_mod_list"] = scells
        r8["non_crit_ext"] = {"non_crit_ext": {"non_crit_ext": v1020}}
    v = {
        "msg": ("c1", ("rrc_conn_recfg", {
            "rrc_transaction_id": transaction_id,
            "crit_exts": ("c1", ("rrc_conn_recfg_r8", r8)),
        })),
    }
    return asn1.DL_DCCH_MESSAGE.to_bytes(v)


def make_meas_config(carrier_arfcn: int = 3400, a3_offset_db: int = 3,
                     hysteresis_db: float = 0.0, meas_id: int = 1,
                     inter_freq_arfcn: int | None = None,
                     gap_pattern: str = "gp0", gap_offset: int = 0) -> dict:
    """A3 measurement config (rrc_mobility.cc fill_meas_cfg: one
    measObjectEUTRA + one reportConfig eventA3 + one measId).  Offsets
    are in dB; the IE carries 0.5 dB steps.

    With `inter_freq_arfcn`, adds a second measObjectEUTRA at that
    carrier (measId 2 on the same A3 report config) and a measGapConfig
    — gp0 = 6 ms gap every 40 ms, gp1 = every 80 ms (TS 36.133 §8.1.2.1;
    `rrc_meas.cc` inter-frequency path)."""
    cfg = _make_meas_config_base(carrier_arfcn, a3_offset_db,
                                 hysteresis_db, meas_id)
    if inter_freq_arfcn is not None:
        cfg["meas_obj_to_add_mod_list"].append({
            "meas_obj_id": 2,
            "meas_obj": ("meas_obj_eutra", {
                "carrier_freq": inter_freq_arfcn,
                "allowed_meas_bw": "mbw50",
                "presence_ant_port1": False,
                "neigh_cell_cfg": 0b01,
            }),
        })
        cfg["meas_id_to_add_mod_list"].append(
            {"meas_id": meas_id + 1, "meas_obj_id": 2, "report_cfg_id": 1})
        cfg["meas_gap_cfg"] = ("setup",
                               {"gap_offset": (gap_pattern, gap_offset)})
    return cfg


def meas_config_gap(meas_cfg: dict):
    """(period_ms, offset) of the configured measurement gap pattern, or
    None — gaps are 6 ms long (TS 36.133 MGL)."""
    g = meas_cfg.get("meas_gap_cfg")
    if not g or g[0] != "setup":
        return None
    pat, off = g[1]["gap_offset"]
    return (40 if pat == "gp0" else 80, off)


def meas_config_carriers(meas_cfg: dict) -> dict:
    """{meas_id: carrier ARFCN} across the config's measObjects."""
    objs = {o["meas_obj_id"]: o["meas_obj"][1]["carrier_freq"]
            for o in meas_cfg.get("meas_obj_to_add_mod_list", [])}
    return {m["meas_id"]: objs[m["meas_obj_id"]]
            for m in meas_cfg.get("meas_id_to_add_mod_list", [])
            if m["meas_obj_id"] in objs}


def _make_meas_config_base(carrier_arfcn: int, a3_offset_db: float,
                           hysteresis_db: float, meas_id: int) -> dict:
    return {
        "meas_obj_to_add_mod_list": [{
            "meas_obj_id": 1,
            "meas_obj": ("meas_obj_eutra", {
                "carrier_freq": carrier_arfcn,
                "allowed_meas_bw": "mbw50",
                "presence_ant_port1": False,
                "neigh_cell_cfg": 0b01,
            }),
        }],
        "report_cfg_to_add_mod_list": [{
            "report_cfg_id": 1,
            "report_cfg": ("report_cfg_eutra", {
                "trigger_type": ("event", {
                    "event_id": ("event_a3", {"a3_offset": int(round(2 * a3_offset_db)),
                                              "report_on_leave": False}),
                    "hysteresis": int(round(2 * hysteresis_db)),
                    "time_to_trigger": "ms0",
                }),
                "trigger_quant": "rsrp",
                "report_quant": "both",
                "max_report_cells": 4,
                "report_interv": "ms480",
                "report_amount": "r1",
            }),
        }],
        "meas_id_to_add_mod_list": [{"meas_id": meas_id, "meas_obj_id": 1, "report_cfg_id": 1}],
    }


def meas_config_a3_offset_db(meas_cfg: dict) -> float:
    ev = meas_cfg["report_cfg_to_add_mod_list"][0]["report_cfg"][1]["trigger_type"][1]
    a3 = ev["event_id"][1]["a3_offset"]
    return (a3 + ev["hysteresis"]) / 2.0


def make_mobility_control(target_pci: int, new_crnti: int, preamble: int,
                          root_seq_idx: int = 0,
                          carrier_arfcn: int | None = None) -> dict:
    """mobilityControlInfo for a handover with a contention-free
    dedicated preamble (rrc_mobility.cc fill_mobility_reconf ->
    mob_ctrl_info).  `carrier_arfcn` (the target's EARFCN) makes it an
    inter-frequency command — the UE retunes before the CF-RA."""
    mci = _make_mobility_control_base(target_pci, new_crnti, preamble,
                                      root_seq_idx)
    if carrier_arfcn is not None:
        mci["carrier_freq"] = {"dl_carrier_freq": carrier_arfcn}
    return mci


def _make_mobility_control_base(target_pci: int, new_crnti: int,
                                preamble: int, root_seq_idx: int) -> dict:
    return {
        "target_pci": target_pci,
        "t304": "ms100",
        "new_ue_id": new_crnti,
        "rr_cfg_common": {
            "prach_cfg": {"root_seq_idx": root_seq_idx},
            "pusch_cfg_common": {
                "pusch_cfg_basic": {"n_sb": 1, "hop_mode": "inter_sub_frame",
                                    "pusch_hop_offset": 0, "enable64_qam": True},
                "ul_ref_sigs_pusch": {"group_hop_enabled": False, "group_assign_pusch": 0,
                                      "seq_hop_enabled": False, "cyclic_shift": 0},
            },
            "ul_cp_len": "len1",
        },
        "rach_cfg_ded": {"ra_preamb_idx": preamble, "ra_prach_mask_idx": 0},
    }


def _rsrp_to_idx(rsrp_dbm: float) -> int:
    """TS 36.133 §9.1.4 RSRP report mapping (value 0..97)."""
    return max(0, min(97, int(round(rsrp_dbm + 141))))


def pack_measurement_report(meas_id: int, pcell_rsrp_dbm: float,
                            neighbours: list[tuple[int, float]],
                            transaction_id: int = 0) -> bytes:
    """MeasurementReport with EUTRA neighbour results (rrc_meas.cc)."""
    v = {
        "msg": ("c1", ("meas_report", {
            "crit_exts": ("c1", ("meas_report_r8", {
                "meas_results": {
                    "meas_id": meas_id,
                    "meas_result_pcell": {"rsrp_result": _rsrp_to_idx(pcell_rsrp_dbm),
                                          "rsrq_result": 17},
                    "meas_result_neigh_cells": ("meas_result_list_eutra", [
                        {"pci": pci,
                         "meas_result": {"rsrp_result": _rsrp_to_idx(rsrp)}}
                        for pci, rsrp in neighbours
                    ]),
                },
            })),
        })),
    }
    return asn1.UL_DCCH_MESSAGE.to_bytes(v)


def pack_conn_release(cause: str = "other", transaction_id: int = 0) -> bytes:
    v = {
        "msg": ("c1", ("rrc_conn_release", {
            "rrc_transaction_id": transaction_id,
            "crit_exts": ("c1", ("rrc_conn_release_r8", {"release_cause": cause})),
        })),
    }
    return asn1.DL_DCCH_MESSAGE.to_bytes(v)


def unpack_dl_dcch(data: bytes):
    v = asn1.DL_DCCH_MESSAGE.from_bytes(data)
    kind, msg = v["msg"][1]
    crit = msg.get("crit_exts")
    body = crit[1][1] if crit[0] == "c1" else crit[1]
    return kind, body


def smc_algorithms(body: dict) -> tuple[int, int]:
    """(cipher_alg, integ_alg) ints from a decoded SecurityModeCommand."""
    cfg = body["security_cfg_smc"]["security_algorithm_cfg"]
    return CIPHER_ALGS.index(cfg["ciphering_algorithm"]), INTEG_ALGS.index(cfg["integrity_prot_algorithm"])


def reconfiguration_scells(body: dict) -> tuple[list[dict], list[int]]:
    """(scell_to_add_mod_list, scell_to_release_list) from a decoded
    reconfiguration's v1020 extension (empty lists when no CA content)."""
    v1020 = (body.get("non_crit_ext", {}).get("non_crit_ext", {}) or {}).get("non_crit_ext", {}) or {}
    return v1020.get("scell_to_add_mod_list") or [], v1020.get("scell_to_release_list") or []


def reconfiguration_drb(body: dict) -> tuple[int, int, int] | None:
    """(drb_id, lcid, eps_bearer_id) from a decoded reconfiguration, if a
    DRB is being set up."""
    drbs = body.get("rr_cfg_ded", {}).get("drb_to_add_mod_list") or []
    if not drbs:
        return None
    d = drbs[0]
    return d["drb_id"], d.get("lc_ch_id", d["drb_id"] + 2), d.get("eps_bearer_id", 0)
