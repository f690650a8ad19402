"""The port's host stack (`srsran_tpu_torch/{stack,epc}`, `phy/tdd.py`,
`runtime/config.py`) against the reference's on the CPU.

Each module of the port is a copy of the reference's with its imports
pointed into the port: its AST, without import statements and the module
docstring, must equal the reference's (one case per module; the one
exception is `Spgw.attach_tun`, whose kernel TUN belongs to a later
slice).  The behaviour tests feed both packages the same inputs and
require identical outputs — bytes, decoded values, scheduler decisions:
security on the 3GPP vectors of `tests/test_security.py` and on seeded
random buffers, the ASN.1 messages of `tests/test_asn1_rrc.py` /
`test_asn1_s1ap.py` and every RRC/S1AP message the stack packs (each
package decoding the other's bytes), RLC AM/TM over a lossy seeded link,
PDCP with and without ciphering, the MAC scheduler over a seeded buffer
mix, NAS, GTP-U/GTP-C and the HSS.  No tolerance: every comparison is
exact.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import srsran_tpu.epc as r_epc
import srsran_tpu.epc.s1ap as r_s1ap_epc
import srsran_tpu.stack.asn1.rrc as r_asn1_rrc
import srsran_tpu.stack.asn1.s1ap as r_asn1_s1ap
import srsran_tpu.stack.gtpc as r_gtpc
import srsran_tpu.stack.gtpu as r_gtpu
import srsran_tpu.stack.mac as r_mac
import srsran_tpu.stack.nas as r_nas
import srsran_tpu.stack.pdcp as r_pdcp
import srsran_tpu.stack.rlc as r_rlc
import srsran_tpu.stack.rrc as r_rrc
import srsran_tpu.stack.sched_grid as r_grid
import srsran_tpu.stack.security as r_sec
import srsran_tpu.phy.common as r_common
import srsran_tpu_torch.epc as t_epc
import srsran_tpu_torch.epc.s1ap as t_s1ap_epc
import srsran_tpu_torch.stack.asn1.rrc as t_asn1_rrc
import srsran_tpu_torch.stack.asn1.s1ap as t_asn1_s1ap
import srsran_tpu_torch.stack.gtpc as t_gtpc
import srsran_tpu_torch.stack.gtpu as t_gtpu
import srsran_tpu_torch.stack.mac as t_mac
import srsran_tpu_torch.stack.nas as t_nas
import srsran_tpu_torch.stack.pdcp as t_pdcp
import srsran_tpu_torch.stack.rlc as t_rlc
import srsran_tpu_torch.stack.rrc as t_rrc
import srsran_tpu_torch.stack.sched_grid as t_grid
import srsran_tpu_torch.stack.security as t_sec
import srsran_tpu_torch.phy.common as t_common
import test_asn1_rrc as rrc_golden
import test_asn1_s1ap as s1ap_golden

ROOT = Path(__file__).resolve().parents[1]

# --- one case per copied module: the AST without imports and docstring -----

HOST_COPIES = ["stack/security.py", "stack/asn1/__init__.py", "stack/asn1/per.py",
               "stack/asn1/rrc.py", "stack/asn1/s1ap.py", "stack/rrc.py", "stack/nas.py",
               "stack/nas_ue.py", "stack/pdcp.py", "stack/rlc.py", "stack/mac.py",
               "stack/mac_pdu.py", "stack/gtpu.py", "stack/gtpc.py", "stack/sched_grid.py",
               "epc/__init__.py", "epc/hss.py", "epc/mme.py", "epc/s1ap.py", "epc/spgw.py",
               "epc/mbms_gw.py", "phy/tdd.py", "runtime/config.py"]
# functions whose body the port replaces on purpose: (module, class, function)
EXCLUDED = {("epc/spgw.py", "Spgw", "attach_tun")}


class _Strip(ast.NodeTransformer):
    def __init__(self, module: str):
        self.module = module
        self.cls = None

    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import

    def visit_ClassDef(self, node):
        outer, self.cls = self.cls, node.name
        self.generic_visit(node)
        self.cls = outer
        return node

    def visit_FunctionDef(self, node):
        if (self.module, self.cls, node.name) in EXCLUDED:
            return None
        self.generic_visit(node)
        return node


def _stripped(path: Path, module: str) -> str:
    tree = ast.parse(path.read_text())
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        tree.body = body[1:]  # the module docstring
    return ast.dump(_Strip(module).visit(tree))


@pytest.mark.parametrize("module", HOST_COPIES)
def test_host_copy_ast_equals_the_reference(module):
    ref = _stripped(ROOT / "srsran_tpu" / module, module)
    got = _stripped(ROOT / "srsran_tpu_torch" / module, module)
    assert got == ref, module


def test_the_excluded_tun_branch_raises():
    with pytest.raises(NotImplementedError, match="io/"):
        t_epc.Spgw().attach_tun()


# --- security -----------------------------------------------------------------


def h(s: str) -> bytes:
    return bytes.fromhex(s.replace(" ", ""))


def _kdf_chain(sec):
    k_asme = sec.generate_k_asme(bytes(16), bytes(range(16)), b"\x21\xf3\x54", bytes(6))
    return (k_asme, sec.generate_k_enb(k_asme, 0), sec.generate_k_enb(k_asme, 3),
            sec.generate_nas_keys(k_asme, 1, 2), sec.generate_as_keys(k_asme, 2, 2))


def test_milenage_and_kdfs_on_the_3gpp_vectors():
    k, rand = h("465b5ce8b199b49faa5f0a2ee238a6bc"), h("23553cbe9637a89d218ae64dae47bf35")
    sqn, amf, op = h("ff9bb4d0b607"), h("b9b9"), h("cdc202d5123e20f62b6d676ac72cb318")
    opc = t_sec.compute_opc(k, op)
    assert opc == r_sec.compute_opc(k, op) == h("cd63cb71954a9f4e48a5994e37a02baf")
    for resync in (False, True):
        assert (t_sec.milenage_f1(k, opc, rand, sqn, amf, sresync=resync)
                == r_sec.milenage_f1(k, opc, rand, sqn, amf, sresync=resync))
    assert t_sec.milenage_f2345(k, opc, rand) == r_sec.milenage_f2345(k, opc, rand)
    assert t_sec.milenage_f2345(k, opc, rand)[0] == h("a54211d5e3ba50bf")
    assert _kdf_chain(t_sec) == _kdf_chain(r_sec)
    key, pt = h("000102030405060708090a0b0c0d0e0f"), h("00112233445566778899aabbccddeeff")
    assert t_sec.aes128_encrypt(key, pt) == r_sec.aes128_encrypt(key, pt)
    assert t_sec.aes128_cmac(key, pt) == r_sec.aes128_cmac(key, pt)


@pytest.mark.parametrize("alg", [1, 2, 3])
def test_eea_eia_on_random_buffers(alg):
    rng = np.random.default_rng(100 + alg)
    for _ in range(4):
        key = rng.bytes(16)
        count, bearer, direction = int(rng.integers(0, 2**32)), int(rng.integers(0, 32)), int(
            rng.integers(0, 2))
        nbits = int(rng.integers(1, 800))
        msg = rng.bytes((nbits + 7) // 8)
        for fn in (f"eea{alg}", f"eia{alg}"):
            got = getattr(t_sec, fn)(key, count, bearer, direction, msg, nbits)
            ref = getattr(r_sec, fn)(key, count, bearer, direction, msg, nbits)
            assert got == ref, fn


# --- ASN.1 ------------------------------------------------------------------------

# the golden vectors of tests/test_asn1_rrc.py
RRC_GOLDEN = [
    ("DL_CCCH_MESSAGE", rrc_golden.DL_CCCH_SETUP),
    ("DL_DCCH_MESSAGE", rrc_golden.DL_DCCH_HO),
    ("DL_DCCH_MESSAGE", rrc_golden.DL_DCCH_RECFG2),
    ("UL_DCCH_MESSAGE", rrc_golden.UL_DCCH_MEAS),
    ("BCCH_BCH_MESSAGE", bytes.fromhex("9464C0")),
    ("BCCH_DL_SCH_MESSAGE", rrc_golden.BCCH_SI_SIB2),
    ("BCCH_DL_SCH_MESSAGE", rrc_golden.BCCH_SIB1),
    ("BCCH_DL_SCH_MESSAGE", rrc_golden.BCCH_SI_SIB2_SIB3),
    ("MCCH_MESSAGE", rrc_golden.MCCH_GOLDEN),
]
RRC_VALUES = [
    ("DL_CCCH_MESSAGE", {"msg": ("c1", ("rrc_conn_reest_reject", {
        "crit_exts": ("rrc_conn_reest_reject_r8", {})}))}),
    ("UL_CCCH_MESSAGE", {"msg": ("c1", ("rrc_conn_request", {"crit_exts": ("rrc_conn_request_r8", {
        "ue_id": ("s_tmsi", {"mmec": 0x5A, "m_tmsi": 0x12345678}),
        "establishment_cause": "mo_data", "spare": 0})}))}),
    ("UL_DCCH_MESSAGE", {"msg": ("c1", ("rrc_conn_setup_complete", {
        "rrc_transaction_id": 1,
        "crit_exts": ("c1", ("rrc_conn_setup_complete_r8", {
            "sel_plmn_id": 1, "ded_info_nas": b"\x07\x41\x01"}))}))}),
    ("PCCH_MESSAGE", {"msg": ("c1", ("paging", {
        "paging_record_list": [
            {"ue_id": ("s_tmsi", {"mmec": 1, "m_tmsi": 0xDEADBEEF}), "cn_domain": "ps"},
            {"ue_id": ("imsi", [0, 0, 1, 0, 1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9]), "cn_domain": "cs"},
        ],
        "sys_info_mod": "true_value"}))}),
]


@pytest.mark.parametrize("case", range(len(RRC_GOLDEN)))
def test_rrc_golden_messages_cross_decode(case):
    kind, data = RRC_GOLDEN[case]
    ref_t, got_t = getattr(r_asn1_rrc, kind), getattr(t_asn1_rrc, kind)
    v_ref, v_got = ref_t.from_bytes(data), got_t.from_bytes(data)
    assert v_got == v_ref
    assert got_t.to_bytes(v_ref) == ref_t.to_bytes(v_got) == data


@pytest.mark.parametrize("case", range(len(RRC_VALUES)))
def test_rrc_built_messages_encode_identically(case):
    kind, value = RRC_VALUES[case]
    ref_t, got_t = getattr(r_asn1_rrc, kind), getattr(t_asn1_rrc, kind)
    data = got_t.to_bytes(value)
    assert data == ref_t.to_bytes(value)
    assert ref_t.from_bytes(data) == got_t.from_bytes(data) == value


def _stack_rrc_messages(rrc):
    """Every RRC PDU the stack packs, with the unpacker that reads it."""
    meas = rrc.make_meas_config(a3_offset_db=-10.0)
    return [
        (rrc.pack_conn_request(b"\x12\x34\x56\x78\x9a"), rrc.unpack_ul_ccch),
        (rrc.pack_conn_request(b"\x00" * 5, cause="mt_access", s_tmsi=(1, 0xC0FFEE)),
         rrc.unpack_ul_ccch),
        (rrc.pack_reest_request(0x46, 7, 0x1234), rrc.unpack_ul_ccch),
        (rrc.pack_conn_setup(), rrc.unpack_dl_ccch),
        (rrc.pack_reest(ncc=0), rrc.unpack_dl_ccch),
        (rrc.pack_reest_reject(), rrc.unpack_dl_ccch),
        (rrc.pack_conn_setup_complete(b"\x07\x41\x02\x0b"), rrc.unpack_ul_dcch),
        (rrc.pack_ul_info_transfer(b"\x07\x53\x08"), rrc.unpack_ul_dcch),
        (rrc.pack_security_mode_complete(), rrc.unpack_ul_dcch),
        (rrc.pack_reconfiguration_complete(), rrc.unpack_ul_dcch),
        (rrc.pack_reest_complete(), rrc.unpack_ul_dcch),
        (rrc.pack_measurement_report(1, -80.0, [(272, -70.0)]), rrc.unpack_ul_dcch),
        (rrc.pack_dl_info_transfer(b"\x07\x52\x00"), rrc.unpack_dl_dcch),
        (rrc.pack_security_mode_command(2, 2), rrc.unpack_dl_dcch),
        (rrc.pack_conn_release(), rrc.unpack_dl_dcch),
        (rrc.pack_reconfiguration(drb_id=1, lcid=3, eps_bearer_id=5, nas_pdu=b"\x27\x01",
                                  meas_cfg=meas), rrc.unpack_dl_dcch),
        (rrc.pack_reconfiguration(mob_ctrl=rrc.make_mobility_control(8, 0x70, 11),
                                  transaction_id=3), rrc.unpack_dl_dcch),
        (rrc.pack_reconfiguration(scells=[rrc.make_scell_config(1, 9, 3400, 25)]),
         rrc.unpack_dl_dcch),
        (rrc.pack_pcch_paging(0xC0FFEE), rrc.unpack_pcch),
        (rrc.pack_sib1(cell_id=(0x19B << 8) | 7), rrc.unpack_bcch_dl_sch),
        (rrc.pack_sib2(nof_ra_preambles=52, prach_config_index=3, sib3=rrc.make_sib3()),
         rrc.unpack_bcch_dl_sch),
    ]


def test_stack_rrc_messages_identical_and_cross_decoded():
    got, ref = _stack_rrc_messages(t_rrc), _stack_rrc_messages(r_rrc)
    assert len(got) == len(ref)
    for (g, g_unpack), (r, r_unpack) in zip(got, ref):
        assert g == r
        assert g_unpack(r) == r_unpack(g)
    k_enb = bytes(range(32))
    assert t_rrc.short_mac_i(k_enb, 2, 7, 0x46, 7) == r_rrc.short_mac_i(k_enb, 2, 7, 0x46, 7)
    assert t_rrc.contention_resolution_id(got[0][0]) == r_rrc.contention_resolution_id(ref[0][0])


# the golden vectors of tests/test_asn1_s1ap.py
S1AP_GOLDEN = [s1ap_golden.S1_SETUP_REQ, s1ap_golden.INIT_CTXT_SETUP,
               s1ap_golden.UE_CTXT_RELEASE_REQ]


def _s1ap_epc_messages(s1):
    return [
        s1.pack_s1_setup_request(), s1.pack_s1_setup_response(),
        s1.pack_initial_ue_message(1, b"\x07\x41\x01", m_tmsi=None),
        s1.pack_initial_ue_message(2, b"\x07\x4c", m_tmsi=0xC0FFEE),
        s1.pack_dl_nas(7, 1, b"\x07\x52"), s1.pack_ul_nas(7, 1, b"\x07\x53"),
        s1.pack_initial_context_setup_request(7, 1, b"\x27\x00", bytes(range(32)), 5),
        s1.pack_initial_context_setup_response(7, 1, enb_teid=101, ebi=5),
        s1.pack_ue_context_release_request(7, 1),
        s1.pack_ue_context_release_command(7, 1),
        s1.pack_ue_context_release_complete(7, 1),
        s1.pack_handover_required(7, 1, 0x19C, b"\x02\x02"),
        s1.pack_handover_request(7, 5, b"\x02\x02", next_hop=bytes(range(32)), ncc=1),
        s1.pack_handover_request_ack(7, 2, 102, b"\x22\x00"),
        s1.pack_handover_command(7, 1, b"\x22\x00"),
        s1.pack_handover_notify(7, 2),
        s1.pack_paging(0xC0FFEE),
    ]


def test_s1ap_messages_identical_and_cross_decoded():
    for data in S1AP_GOLDEN:
        v_ref, v_got = r_asn1_s1ap.unpack(data), t_asn1_s1ap.unpack(data)
        assert v_got == v_ref
        assert t_asn1_s1ap.pack(*v_ref) == r_asn1_s1ap.pack(*v_got) == data
    got, ref = _s1ap_epc_messages(t_s1ap_epc), _s1ap_epc_messages(r_s1ap_epc)
    for g, r in zip(got, ref):
        assert g == r
        assert t_s1ap_epc.unpack(r) == r_s1ap_epc.unpack(g)


# --- RLC, PDCP ------------------------------------------------------------------


def _rlc_am_run(rlc, seed: int):
    """A lossy AM link: seeded SDUs, PDU sizes and drops; returns every PDU
    on the air and every SDU delivered."""
    rng = np.random.default_rng(seed)
    tx, rx = rlc.RlcAm(), rlc.RlcAm()
    air, delivered = [], []
    for step in range(120):
        if step < 60 and rng.random() < 0.5:
            tx.write_sdu(rng.bytes(int(rng.integers(1, 400))))
        for src, dst in ((tx, rx), (rx, tx)):
            pdu = src.read_pdu(int(rng.integers(8, 300)))
            if pdu is not None:
                air.append(pdu)
                if rng.random() > 0.15:
                    dst.write_pdu(pdu)
        while (s := rx.read_sdu()) is not None:
            delivered.append(s)
        tx.tick()
        rx.tick()
    return air, delivered, tx.buffer_state()


def test_rlc_am_and_tm_identical():
    for seed in (1, 2):
        assert _rlc_am_run(t_rlc, seed) == _rlc_am_run(r_rlc, seed)
    out = []
    for rlc in (t_rlc, r_rlc):
        tm = rlc.RlcTm()
        tm.write_sdu(b"\x40\x12\x34")
        pdu = tm.read_pdu(100)
        tm.write_pdu(pdu)
        out.append((pdu, tm.read_sdu(), tm.buffer_state()))
    assert out[0] == out[1]


@pytest.mark.parametrize("alg", [(0, 0), (1, 1), (2, 2), (3, 3), (2, 0)])
def test_pdcp_identical(alg):
    cipher, integ = alg
    rng = np.random.default_rng(7 + cipher)
    k_enc, k_int = rng.bytes(16), rng.bytes(16)
    for is_srb in (True, False):
        runs = []
        for pdcp in (t_pdcp, r_pdcp):
            cfg = dict(is_srb=is_srb, bearer_id=1 if is_srb else 3, cipher_alg=cipher,
                       integrity_alg=integ if is_srb else 0)
            tx = pdcp.PdcpEntity(pdcp.PdcpConfig(direction_tx=1, **cfg), k_enc=k_enc, k_int=k_int)
            rx = pdcp.PdcpEntity(pdcp.PdcpConfig(direction_tx=0, **cfg), k_enc=k_enc, k_int=k_int)
            r = np.random.default_rng(3)
            pdus = [tx.write_sdu(r.bytes(int(r.integers(1, 200)))) for _ in range(6)]
            runs.append((pdus, [rx.write_pdu(p) for p in pdus]))
        assert runs[0] == runs[1]
        # each package reads the other's PDUs
        for pdcp, (pdus, sdus) in ((t_pdcp, runs[1]), (r_pdcp, runs[0])):
            rx = pdcp.PdcpEntity(pdcp.PdcpConfig(
                direction_tx=0, is_srb=is_srb, bearer_id=1 if is_srb else 3, cipher_alg=cipher,
                integrity_alg=integ if is_srb else 0), k_enc=k_enc, k_int=k_int)
            assert [rx.write_pdu(p) for p in pdus] == sdus


# --- MAC ---------------------------------------------------------------------------


def _sched_run(mac, rlc, seed: int):
    """Scheduler decisions over a seeded buffer mix: three UEs with SRB/DRB
    bearers, random SDUs, CQI, BSR, PHR and HARQ feedback."""
    rng = np.random.default_rng(seed)
    sched = mac.Scheduler(25, mcs_max=20)
    bearers = {}
    for rnti in (0x46, 0x47, 0x48):
        bearers[rnti] = (rlc.RlcAm(), rlc.RlcAm())
        sched.bearer_ue_cfg(rnti, 1, bearers[rnti][0])
        sched.bearer_ue_cfg(rnti, 3, bearers[rnti][1])
    sched.push_ce(0x46, mac.LCID_CON_RES, b"\x01\x02\x03\x04\x05\x06")
    out = []
    for tti in range(60):
        for rnti, (srb, drb) in bearers.items():
            if rng.random() < 0.3:
                (srb if rng.random() < 0.3 else drb).write_sdu(rng.bytes(int(rng.integers(10, 1500))))
            if rng.random() < 0.2:
                sched.cqi_info(rnti, int(rng.integers(1, 16)))
            if rng.random() < 0.2:
                sched.ul_bsr(rnti, int(rng.integers(0, 5000)))
            if rng.random() < 0.05:
                sched.ul_phr(rnti, int(rng.integers(-23, 40)))
        dl = sched.get_dl_sched(tti, pdsch_nof_re=int(rng.integers(2000, 3500)))
        ul = sched.get_ul_sched(tti)
        for g in dl:
            sched.ack_info(g.rnti, g.harq_pid, bool(rng.random() < 0.8))
        out.append(([dataclasses.astuple(g) for g in dl], [dataclasses.astuple(g) for g in ul]))
    out.append(sched.metrics())
    return out


def test_mac_scheduler_decisions_identical():
    for seed in (11, 12):
        assert _sched_run(t_mac, t_rlc, seed) == _sched_run(r_mac, r_rlc, seed)


def test_mac_helpers_and_ue_side_identical():
    for v in (0, 10, 100, 1000, 10**5, 10**7):
        assert t_mac.bsr_index(v) == r_mac.bsr_index(v)
    for db in range(-23, 41):
        assert t_mac.phr_index(db) == r_mac.phr_index(db)
        assert t_mac.phr_db(t_mac.phr_index(db)) == r_mac.phr_db(r_mac.phr_index(db))
    outs = []
    for mac in (t_mac, r_mac):
        ue = mac.UeMac()
        ue.start_ra(17)
        ok = ue.handle_rar(17, 3, 0x46)
        ue.write_sdu(3, b"\x45" * 90)
        pdu = ue.build_ul_pdu(64)
        outs.append((ok, pdu, ue.buffer_state(), mac.parse_ul_pdu(pdu), mac.HARQ_RV_SEQ))
    assert outs[0] == outs[1]


def test_sched_grid_identical():
    cell_t, cell_r = t_common.Cell(nof_prb=25, id=7), r_common.Cell(nof_prb=25, id=7)
    rntis = [0xFFFF, 2, 0x46, 0x47, 0x48, 0x49, 0x4A]
    for sf_idx in range(10):
        for cfi in (1, 2, 3):
            gt, gr = t_grid.PdcchGrid(cell_t, sf_idx, cfi), r_grid.PdcchGrid(cell_r, sf_idx, cfi)
            assert [gt.alloc(r) for r in rntis] == [gr.alloc(r) for r in rntis]
        assert (t_grid.min_cfi_for(cell_t, sf_idx, rntis[:4])
                == r_grid.min_cfi_for(cell_r, sf_idx, rntis[:4]))


# --- NAS, GTP, HSS ------------------------------------------------------------------


def _nas_messages(nas):
    tft = nas.Tft(1, [nas.TftPacketFilter(1, 3, 0, b"\x30\x11\x50\x00\x50")])
    return [
        nas.pack_attach_request("001010123456789"), nas.pack_pdn_connectivity_request(),
        nas.pack_authentication_request(bytes(range(16)), bytes(range(16, 32))),
        nas.pack_authentication_response(b"\xa5" * 8), nas.pack_security_mode_command(2, 2),
        nas.pack_security_mode_complete(), nas.pack_detach_request(0xC0FFEE, True),
        nas.pack_detach_accept(), nas.pack_activate_default_bearer_request("172.16.0.2"),
        nas.pack_attach_accept("172.16.0.2"), nas.pack_attach_complete(),
        nas.pack_activate_dedicated_bearer_request(6, 5, 1, tft),
    ]


def test_nas_messages_identical():
    got, ref = _nas_messages(t_nas), _nas_messages(r_nas)
    assert got == ref
    for g in got:
        assert dataclasses.astuple(t_nas.unpack(g)) == dataclasses.astuple(r_nas.unpack(g))
    assert t_nas.bcd_to_imsi(t_nas.imsi_to_bcd("001010123456789")) == "001010123456789"
    assert t_nas.imsi_to_bcd("001010123456789") == r_nas.imsi_to_bcd("001010123456789")
    prot = []
    for nas in (t_nas, r_nas):
        tx = nas.NasSecurityContext(bytes(range(16)), bytes(range(16, 32)), 2, 2, is_ue=True)
        rx = nas.NasSecurityContext(bytes(range(16)), bytes(range(16, 32)), 2, 2, is_ue=False)
        pdus = [tx.protect(m) for m in ref[:4]] + [tx.pack_service_request()]
        prot.append((pdus, [rx.unprotect(p) for p in pdus[:4]]))
    assert prot[0] == prot[1]


def test_gtp_identical():
    for seq in (None, 7):
        pkt = t_gtpu.gtpu_pack(0x1234, b"\x45\x00" * 30, seq=seq)
        assert pkt == r_gtpu.gtpu_pack(0x1234, b"\x45\x00" * 30, seq=seq)
        (hg, pg), (hr, pr) = t_gtpu.gtpu_unpack(pkt), r_gtpu.gtpu_unpack(pkt)
        assert (dataclasses.astuple(hg), pg) == (dataclasses.astuple(hr), pr)
    outs = []
    for gtpc in (t_gtpc, r_gtpc):
        ies = [(gtpc.IE_IMSI, 0, "001010123456789"), (gtpc.IE_EBI, 0, 5),
               (gtpc.IE_FTEID, 0, {"iface": 10, "teid": 0x1111, "ip": "127.0.0.1"}),
               (gtpc.IE_APN, 0, "srsapn"), (gtpc.IE_BEARER_QOS, 0, gtpc.pack_bearer_qos())]
        data = gtpc.pack(gtpc.CREATE_SESSION_REQUEST, 0, 3, ies)
        outs.append((data, gtpc.unpack(data), gtpc.pack(gtpc.ECHO_REQUEST, None, 1, [])))
    assert outs[0] == outs[1]


def test_hss_vectors_identical_under_one_rand_state():
    key, opc = bytes(range(16)), bytes(range(16, 32))
    vecs = []
    for epc in (t_epc, r_epc):
        hss = epc.Hss()
        hss._rand_state = 0x0123456789ABCDEF
        hss.add_subscriber(epc.Subscriber("ue1", "001010123456789", key, opc,
                                          amf=b"\x80\x00", sqn=0))
        vecs.append([dataclasses.astuple(hss.get_auth_vector("001010123456789"))
                     for _ in range(3)])
    assert vecs[0] == vecs[1]
