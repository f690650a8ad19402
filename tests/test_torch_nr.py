"""The port's NR scaffolding against the reference's on the CPU.

The NR MAC, RLC, PDCP and VNF codecs, the NR RRC and NGAP ASN.1, the
coreless gNB <-> UE stack (`apps/nr_stack.py`) and the TTCN-3 harness
(`apps/ttcn3.py`) are host copies: each scenario of
`tests/test_nr_scaffolding.py` and `tests/test_nr_stack.py` runs on both
packages with seeded bytes, and every byte stream, decoded value and state
must be identical (no tolerance); a 160-step lockstep of the two stacks
compares every VNF message TTI by TTI.  The golden NR RRC and NGAP vectors
go through the port with the reference tests' field checks, and each
package decodes the other's bytes and packs them back identically.  The
NR PDSCH DM-RS (`phy/phch/dmrs_nr.py`, on torch tensors) gives the
reference's tables for every valid configuration, its pilots bit for bit,
and its LS estimates within 1e-6.  The TTCN-3 server's replies equal the
reference server's to the same requests (the port's `UeStack` on the CPU).
"""

import json
import random
import socket
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import srsran_tpu.apps.nr_stack as r_nr_stack
import srsran_tpu.phy.phch.dmrs_nr as r_dmrs
import srsran_tpu.stack.asn1.ngap as r_ngap
import srsran_tpu.stack.asn1.rrc_nr as r_rrc_nr
import srsran_tpu.stack.mac_nr as r_mac_nr
import srsran_tpu.stack.pdcp_nr as r_pdcp_nr
import srsran_tpu.stack.rlc_nr as r_rlc_nr
import srsran_tpu.stack.vnf as r_vnf
import srsran_tpu_torch.apps.nr_stack as t_nr_stack
import srsran_tpu_torch.phy.phch.dmrs_nr as t_dmrs
import srsran_tpu_torch.stack.asn1.ngap as t_ngap
import srsran_tpu_torch.stack.asn1.rrc_nr as t_rrc_nr
import srsran_tpu_torch.stack.mac_nr as t_mac_nr
import srsran_tpu_torch.stack.pdcp_nr as t_pdcp_nr
import srsran_tpu_torch.stack.rlc_nr as t_rlc_nr
import srsran_tpu_torch.stack.vnf as t_vnf
import test_asn1_ngap as ngap_golden
import test_asn1_rrc_nr as rrc_nr_golden

torch.set_num_threads(1)

REF = SimpleNamespace(mac_nr=r_mac_nr, rlc_nr=r_rlc_nr, pdcp_nr=r_pdcp_nr, vnf=r_vnf, nr=r_nr_stack)
PORT = SimpleNamespace(mac_nr=t_mac_nr, rlc_nr=t_rlc_nr, pdcp_nr=t_pdcp_nr, vnf=t_vnf, nr=t_nr_stack)


def both(scenario):
    """Run a scenario on both packages; its outputs must be identical."""
    got, ref = scenario(PORT), scenario(REF)
    assert got == ref
    return got


# --- scaffolding: the cases of tests/test_nr_scaffolding.py --------------------------


def test_mac_nr_roundtrip():
    def sc(m):
        subpdus = [(4, b"short sdu"), (5, b"x" * 300)]  # 8-bit and 16-bit L
        pdu = m.mac_nr.mac_nr_pack(subpdus, tb_size=400)
        assert len(pdu) == 400 and m.mac_nr.mac_nr_unpack(pdu) == subpdus
        ul = m.mac_nr.mac_nr_pack([(0, b"\x01\x02\x03\x04\x05\x06"), (4, b"data")])
        got_ul = m.mac_nr.mac_nr_unpack(ul, is_ul=True)
        assert got_ul == [(0, b"\x01\x02\x03\x04\x05\x06"), (4, b"data")]
        return pdu, ul, got_ul

    both(sc)


def test_rlc_um_nr_header_codec():
    def sc(m):
        out = []
        for sn_bits in (6, 12):
            p = m.rlc_nr.um_pack(m.rlc_nr.SI_FIRST, 37, None, b"abc", sn_bits)
            assert m.rlc_nr.um_unpack(p, sn_bits) == (m.rlc_nr.SI_FIRST, 37, None, b"abc")
            q = m.rlc_nr.um_pack(m.rlc_nr.SI_LAST, 37, 512, b"xyz", sn_bits)
            assert m.rlc_nr.um_unpack(q, sn_bits) == (m.rlc_nr.SI_LAST, 37, 512, b"xyz")
            out += [p, q]
        p = m.rlc_nr.um_pack(m.rlc_nr.SI_FULL, None, None, b"full")
        assert m.rlc_nr.um_unpack(p)[3] == b"full"
        return out + [p]

    both(sc)


def test_rlc_um_nr_segmentation_roundtrip():
    def sc(m):
        tx, rx = m.rlc_nr.RlcUmNr(), m.rlc_nr.RlcUmNr()
        sdus = [bytes([i]) * (20 + 40 * i) for i in range(5)]
        for s in sdus:
            tx.write_sdu(s)
        pdus = []
        while tx.has_data():
            pdu = tx.read_pdu(50)
            assert pdu is not None and len(pdu) <= 50
            pdus.append(pdu)
            rx.write_pdu(pdu)
        got = []
        while (s := rx.read_sdu()) is not None:
            got.append(s)
        assert got == sdus
        return pdus

    both(sc)


def test_rlc_am_nr_header_codec():
    def sc(m):
        out = []
        for sn_bits in (12, 18):
            p = m.rlc_nr.am_pack(m.rlc_nr.SI_LAST, 1234, 77, b"seg", poll=True, sn_bits=sn_bits)
            assert m.rlc_nr.am_unpack(p, sn_bits) == (m.rlc_nr.SI_LAST, 1234, 77, True, b"seg")
            out.append(p)
        return out

    both(sc)


def test_vnf_pnf_slot_exchange():
    def sc(m):
        pnf, v = m.vnf.Pnf(), m.vnf.Vnf()
        v.dl_source.append(b"dl mac pdu 0")
        v.dl_source.append(b"dl mac pdu 1")
        msgs = []
        for _ in range(3):
            ind = pnf.slot_indication()
            msgs.append(ind)
            for resp in v.handle(ind):
                msgs.append(resp)
                pnf.handle(resp)
        assert pnf.dl_pdus[0] == [(0, b"dl mac pdu 0")] and pnf.dl_pdus[1] == [(0, b"dl mac pdu 1")]
        ul = pnf.ul_data(5, [b"ul pdu a", b"ul pdu b"])
        v.handle(ul)
        assert list(v.rx_pdus) == [b"ul pdu a", b"ul pdu b"]
        return msgs + [ul], dict(pnf.dl_pdus), [m.vnf.unpack(x) for x in msgs]

    both(sc)


def test_nr_am_status_codec():
    def sc(m):
        p = m.rlc_nr.status_pack(0x123)
        assert m.rlc_nr.status_unpack(p) == (0x123, [])
        nacks = [(7, None, None), (9, 10, 200), (12, None, None)]
        q = m.rlc_nr.status_pack(100, nacks)
        assert m.rlc_nr.status_unpack(q) == (100, nacks)
        return p, q

    both(sc)


def test_nr_am_delivery_with_loss_and_retx():
    def sc(m):
        rng = random.Random(3)
        a, b = m.rlc_nr.RlcAmNr(poll_pdu=3), m.rlc_nr.RlcAmNr(poll_pdu=3)
        sdus = [bytes([i]) * rng.randint(1, 400) for i in range(30)]
        for s in sdus:
            a.write_sdu(s)
        got, trace = [], []
        for _ in range(400):
            pdu = a.read_pdu(120)
            trace.append(pdu)
            if pdu is not None and not (rng.random() < 0.25 and (pdu[0] >> 7) == 1):
                b.write_pdu(pdu)  # data PDUs dropped 25% of the time
            back = b.read_pdu(120)
            trace.append(back)
            if back is not None:
                a.write_pdu(back)
            while (s := b.read_sdu()) is not None:
                got.append(s)
            if len(got) == len(sdus):
                break
        assert got == sdus
        return trace

    both(sc)


def test_nr_am_segmentation_roundtrip():
    def sc(m):
        a, b = m.rlc_nr.RlcAmNr(), m.rlc_nr.RlcAmNr()
        payload = bytes(range(256)) * 8
        a.write_sdu(payload)
        trace = []
        while a.has_data():
            pdu = a.read_pdu(100)
            if pdu is None:
                break
            trace.append(pdu)
            b.write_pdu(pdu)
            if (st := b.read_pdu(100)) is not None and (st[0] >> 7) == 0:
                trace.append(st)
                a.write_pdu(st)
        assert b.read_sdu() == payload
        return trace

    both(sc)


def _nr_pair(m, **kw):
    k_enc, k_int = bytes(range(16)), bytes(range(16, 32))
    cfg = m.pdcp_nr.PdcpNrConfig
    return (m.pdcp_nr.PdcpEntityNr(cfg(direction_tx=1, **kw), k_enc, k_int),
            m.pdcp_nr.PdcpEntityNr(cfg(direction_tx=0, **kw), k_enc, k_int))


def test_pdcp_nr_in_order_roundtrip():
    def sc(m):
        tx, rx = _nr_pair(m, cipher_alg=2, integrity_alg=2, is_srb=True)
        sdus = [bytes([i]) * (i + 3) for i in range(20)]
        pdus, got = [], []
        for s in sdus:
            pdus.append(tx.write_sdu(s))
            got.extend(rx.write_pdu(pdus[-1]))
        assert got == sdus and rx.integrity_failures == 0
        return pdus

    both(sc)


def test_pdcp_nr_reordering_and_duplicates():
    def sc(m):
        tx, rx = _nr_pair(m, sn_bits=18, cipher_alg=3)
        pdus = [tx.write_sdu(bytes([i, i, i])) for i in range(6)]
        assert rx.write_pdu(pdus[0]) == [bytes([0, 0, 0])]
        assert rx.write_pdu(pdus[3]) == [] and rx.write_pdu(pdus[2]) == []
        assert rx.write_pdu(pdus[3]) == [] and rx.dropped == 1  # the duplicate
        assert rx.write_pdu(pdus[1]) == [bytes([1] * 3), bytes([2] * 3), bytes([3] * 3)]
        assert rx.write_pdu(pdus[4]) == [bytes([4] * 3)]
        return pdus

    both(sc)


def test_pdcp_nr_t_reordering_flush():
    def sc(m):
        tx, rx = _nr_pair(m, t_reordering=10)
        pdus = [tx.write_sdu(bytes([i])) for i in range(4)]
        rx.write_pdu(pdus[0])
        assert rx.write_pdu(pdus[2]) == [] and rx.timer_left == 10
        assert rx.tick(9) == [] and rx.tick(1) == [bytes([2])]
        assert rx.write_pdu(pdus[1]) == []  # stale after the expiry
        assert rx.write_pdu(pdus[3]) == [bytes([3])]
        return pdus

    both(sc)


def test_pdcp_nr_integrity_failure_drop():
    def sc(m):
        tx, rx = _nr_pair(m, cipher_alg=2, integrity_alg=2, is_srb=True)
        pdu = bytearray(tx.write_sdu(b"hello-nr"))
        pdu[-1] ^= 0xFF
        assert rx.write_pdu(bytes(pdu)) == [] and rx.integrity_failures == 1
        return bytes(pdu)

    both(sc)


def test_pdcp_nr_sn_wrap_hfn():
    def sc(m):
        cfg = m.pdcp_nr.PdcpNrConfig
        tx = m.pdcp_nr.PdcpEntityNr(cfg(sn_bits=12, direction_tx=1, cipher_alg=1, integrity_alg=1))
        rx = m.pdcp_nr.PdcpEntityNr(cfg(sn_bits=12, direction_tx=0, cipher_alg=1, integrity_alg=1))
        n = (1 << 12) + 50  # one SN wrap
        pdus = []
        for i in range(n):
            sdu = i.to_bytes(4, "big")
            pdus.append(tx.write_sdu(sdu))
            assert rx.write_pdu(pdus[-1]) == [sdu]
        assert rx.rx_deliv == n
        return pdus[-60:], rx.rx_deliv

    both(sc)


def test_dmrs_nr_symbol_tables():
    for kw, want in [(dict(duration=14, additional_pos=0), [2]),
                     (dict(duration=14, additional_pos=1), [2, 11]),
                     (dict(duration=14, additional_pos=2), [2, 7, 11]),
                     (dict(duration=14, additional_pos=3), [2, 5, 8, 11]),
                     (dict(duration=12, additional_pos=2), [2, 6, 9]),
                     (dict(duration=9, additional_pos=2), [2, 7]),
                     (dict(duration=14, additional_pos=1, typeA_pos=3), [3, 11]),
                     (dict(duration=14, additional_pos=1, length=2), [2, 3, 10, 11]),
                     (dict(duration=12, additional_pos=1, length=2), [2, 3, 8, 9]),
                     (dict(duration=9, additional_pos=1, length=2), [2, 3])]:
        got = t_dmrs.symbols_idx(t_dmrs.DmrsPdschConfig(**kw))
        assert got == r_dmrs.symbols_idx(r_dmrs.DmrsPdschConfig(**kw)) == want, kw


def test_dmrs_nr_put_get_roundtrip():
    for typ, density in ((1, 6), (2, 4)):
        kw = dict(nof_prb=24, type=typ, additional_pos=2, n_id=77)
        cfg, rcfg = t_dmrs.DmrsPdschConfig(n_scid=1, **kw), r_dmrs.DmrsPdschConfig(n_scid=1, **kw)
        assert len(t_dmrs.sc_idx(cfg)) == 24 * density
        grid = t_dmrs.put_sf(cfg, 3, torch.zeros((14, 24 * 12), dtype=torch.complex64))
        ref = r_dmrs.put_sf(rcfg, 3, np.zeros((14, 24 * 12), np.complex64))
        assert torch.equal(grid, torch.from_numpy(ref))
        k = t_dmrs.sc_idx(cfg)
        vals = grid[2, k]
        assert torch.allclose(vals.abs(), torch.ones(len(k)), atol=1e-5)  # unit-power QPSK
        h = 0.8 - 0.6j
        ls = t_dmrs.get_sf(cfg, 3, grid * h)
        assert ls.shape == (3, 24 * density) and ls.dtype == torch.complex64
        assert torch.allclose(ls, torch.full_like(ls, h), atol=1e-5)
        grid2 = t_dmrs.put_sf(t_dmrs.DmrsPdschConfig(n_scid=0, **kw), 3,
                              torch.zeros((14, 24 * 12), dtype=torch.complex64))
        assert not torch.allclose(grid2[2, k], vals)


# --- the coreless NR stack: the cases of tests/test_nr_stack.py, and a lockstep -------


def _connect(m):
    gnb, ue = m.nr.GnbStackNr(cell_id=7), m.nr.UeStackNr()
    link = m.nr.NrAirLink(gnb, ue)
    link.run(40)
    return gnb, ue, link


def _state(gnb, ue):
    return dict(mib=ue.mib, sib1=ue.sib1, connected=(ue.connected, gnb.connected),
                released=ue.released, ue_nas=ue.rx_nas, gnb_nas=gnb.rx_nas, ue_drb=ue.rx_drb,
                gnb_drb=gnb.rx_drb)


def test_nr_setup_and_sib_acquisition():
    def sc(m):
        gnb, ue, _ = _connect(m)
        assert ue.mib["message"][1]["cell_barred"] == "not_barred"
        _, (_, sib1) = ue.sib1["message"]
        assert sib1["cell_access_related_info"]["plmn_id_list"][0]["cell_id"] == 7
        assert sib1["cell_sel_info"]["q_rx_lev_min"] == -70
        assert ue.connected and gnb.connected and gnb.rx_nas[0] == b"\x7e\x00\x41"
        return _state(gnb, ue)

    both(sc)


def test_nr_info_transfer_both_ways():
    def sc(m):
        gnb, ue, link = _connect(m)
        gnb.write_nas(b"\x7e\x02\xaa\xbb")
        ue.write_nas(b"\x7e\x03\xcc")
        link.run(20)
        assert b"\x7e\x02\xaa\xbb" in ue.rx_nas and b"\x7e\x03\xcc" in gnb.rx_nas
        return _state(gnb, ue)

    both(sc)


def test_nr_drb_user_plane_bidirectional():
    def sc(m):
        gnb, ue, link = _connect(m)
        rng = random.Random(1)
        dl = [bytes([rng.randrange(256) for _ in range(n)]) for n in (40, 1200, 3000)]
        ul = [bytes([rng.randrange(256) for _ in range(n)]) for n in (60, 800)]
        for p in dl:
            gnb.write_drb(p)
        for p in ul:
            ue.write_drb(p)
        link.run(60)
        assert ue.rx_drb == dl and gnb.rx_drb == ul
        return _state(gnb, ue)

    both(sc)


def test_nr_drb_before_connection_is_buffered():
    def sc(m):
        gnb, ue = m.nr.GnbStackNr(), m.nr.UeStackNr()
        ue.write_drb(b"early")
        ue.write_nas(b"\x7e\x01")
        m.nr.NrAirLink(gnb, ue).run(50)
        assert b"early" in gnb.rx_drb and b"\x7e\x01" in gnb.rx_nas
        return _state(gnb, ue)

    both(sc)


def test_nr_release():
    def sc(m):
        gnb, ue, link = _connect(m)
        gnb.send_release()
        link.run(10)
        assert ue.released and not ue.connected
        return _state(gnb, ue)

    both(sc)


def test_nr_large_transfer_counts():
    """Sustained DL through the 512-byte TB budget (seeded bytes in place of
    the reference test's os.urandom)."""
    def sc(m):
        gnb, ue, link = _connect(m)
        rng = np.random.default_rng(50)
        payloads = [rng.bytes(300) for _ in range(50)]
        for p in payloads:
            gnb.write_drb(p)
        link.run(120)
        assert ue.rx_drb == payloads
        return _state(gnb, ue)

    both(sc)


def _lockstep_trace(m, monkeypatch, steps=160):
    """The VNF messages of `steps` TTIs of seeded traffic — NAS and DRB SDUs
    both ways from before the connection on, then a release — as
    (tti, kind, bytes), with the stacks' states at the end."""
    log = []
    link = None
    for name in ("pack_sf_ind", "pack_tx_request", "pack_rx_data_ind"):
        def wrapped(*a, _fn=getattr(m.vnf, name), _name=name, **kw):
            out = _fn(*a, **kw)
            log.append((link.tti - 1, _name, out))  # step() counts its TTI first
            return out

        monkeypatch.setattr(m.vnf, name, wrapped)
    gnb, ue = m.nr.GnbStackNr(cell_id=301), m.nr.UeStackNr(ue_id=0x123456789A)
    link = m.nr.NrAirLink(gnb, ue)
    rng = np.random.default_rng(160)
    ue.write_nas(b"\x7e\x01\x02")
    ue.write_drb(rng.bytes(700))
    for tti in range(steps):
        if 10 <= tti < 130 and tti % 6 == 0:
            gnb.write_drb(rng.bytes(int(rng.integers(1, 1500))))
            ue.write_drb(rng.bytes(int(rng.integers(1, 600))))
        if tti in (20, 70, 110):
            gnb.write_nas(rng.bytes(int(rng.integers(2, 40))))
            ue.write_nas(rng.bytes(int(rng.integers(2, 40))))
        if tti == 150:
            gnb.send_release()
        link.step()
    monkeypatch.undo()
    return log, _state(gnb, ue)


def test_nr_lockstep_vnf_messages(monkeypatch):
    got, got_state = _lockstep_trace(PORT, monkeypatch)
    ref, ref_state = _lockstep_trace(REF, monkeypatch)
    assert len(got) == len(ref) > 2 * 120
    for g, r in zip(got, ref):
        assert g == r, r[:2]  # TTI by TTI, byte for byte
    assert got_state == ref_state
    assert ref_state["released"] and len(ref_state["ue_drb"]) > 15 and len(ref_state["gnb_nas"]) == 4


# --- ASN.1: the NR RRC and NGAP vectors through the port, and crossed --------------------

RRC_NR_VECTORS = {
    "mib": ("bcch_bch", rrc_nr_golden.MIB_VEC),
    "sib1": ("bcch_dl_sch", rrc_nr_golden.SIB1_VEC),
    "setup_request": ("ul_ccch", rrc_nr_golden.RRC_SETUP_REQUEST_VEC),
    "setup": ("dl_ccch", rrc_nr_golden.RRC_SETUP_VEC),
    "reject": ("dl_ccch", rrc_nr_golden.RRC_REJECT_VEC),
    "setup_complete": ("ul_dcch", rrc_nr_golden.RRC_SETUP_COMPLETE_VEC),
    "dl_info_transfer": ("dl_dcch", rrc_nr_golden.DL_INFO_TRANSFER_VEC),
    "ul_info_transfer": ("ul_dcch", rrc_nr_golden.UL_INFO_TRANSFER_VEC),
    "release": ("dl_dcch", rrc_nr_golden.RRC_RELEASE_VEC),
}
NGAP_VECTORS = ("AMF_UPD", "NG_SETUP_REQ", "NG_SETUP_RESP", "INIT_UE", "DL_NAS", "UL_NAS", "UE_REL_CMD",
                "UE_REL_COMPL", "PDU_SESS_SETUP")


@pytest.mark.parametrize("name", list(RRC_NR_VECTORS))
def test_rrc_nr_vector_crossed(name):
    channel, vec = RRC_NR_VECTORS[name]
    got, ref = t_rrc_nr.unpack(channel, vec), r_rrc_nr.unpack(channel, vec)
    assert got == ref
    assert t_rrc_nr.pack(channel, ref) == r_rrc_nr.pack(channel, got) == vec


@pytest.mark.parametrize("case", [n for n in dir(rrc_nr_golden) if n.startswith("test_")])
def test_rrc_nr_reference_checks_on_the_port(case, monkeypatch):
    monkeypatch.setattr(rrc_nr_golden, "rrc_nr", t_rrc_nr)
    getattr(rrc_nr_golden, case)()


@pytest.mark.parametrize("name", NGAP_VECTORS)
def test_ngap_vector_crossed(name):
    vec = getattr(ngap_golden, name)
    got, ref = t_ngap.unpack(vec), r_ngap.unpack(vec)
    assert got == ref
    assert t_ngap.pack(*ref) == r_ngap.pack(*got) == vec


@pytest.mark.parametrize("case", [n for n in dir(ngap_golden) if n.startswith("test_")])
def test_ngap_reference_checks_on_the_port(case, monkeypatch):
    monkeypatch.setattr(ngap_golden, "ngap", t_ngap)
    getattr(ngap_golden, case)()


def test_nr_stack_messages_crossed(monkeypatch):
    """Every RRC PDU the stacks pack in the lockstep decodes alike in both
    packages and packs back to the same bytes."""
    packed = []

    def rec(channel, msg, _pack=t_rrc_nr.pack):
        packed.append((channel, _pack(channel, msg)))
        return packed[-1][1]

    monkeypatch.setattr(t_rrc_nr, "pack", rec)
    gnb, ue, link = _connect(PORT)
    gnb.write_nas(b"\x7e\x02\xaa\xbb")
    ue.write_nas(b"\x7e\x03\xcc")
    gnb.send_release()
    link.run(20)
    monkeypatch.undo()
    assert {c for c, _ in packed} == {"bcch_bch", "bcch_dl_sch", "ul_ccch", "dl_ccch", "ul_dcch", "dl_dcch"}
    for channel, pdu in packed:
        msg = r_rrc_nr.unpack(channel, pdu)
        assert msg == t_rrc_nr.unpack(channel, pdu)
        assert r_rrc_nr.pack(channel, msg) == pdu


# --- NR PDSCH DM-RS on torch tensors ---------------------------------------------------


def _all_configs(nof_prb=24):
    for typ in (1, 2):
        for length in (1, 2):
            for add in range(4):
                for ta in (2, 3):
                    for duration in range(1, 15):
                        yield dict(nof_prb=nof_prb, type=typ, length=length, additional_pos=add,
                                   typeA_pos=ta, duration=duration)


def _outcome(fn, *a):
    try:
        return fn(*a)
    except ValueError as e:
        return ("raises", str(e))


def test_dmrs_tables_every_configuration():
    """symbols_idx and sc_idx of every (type, length, additional_pos,
    typeA_pos, duration) equal the reference's; the invalid ones raise
    alike; type B raises on both."""
    valid = 0
    for kw in _all_configs():
        got = _outcome(t_dmrs.symbols_idx, t_dmrs.DmrsPdschConfig(**kw))
        assert got == _outcome(r_dmrs.symbols_idx, r_dmrs.DmrsPdschConfig(**kw)), kw
        valid += got[0] != "raises"
        np.testing.assert_array_equal(t_dmrs.sc_idx(t_dmrs.DmrsPdschConfig(**kw)),
                                      r_dmrs.sc_idx(r_dmrs.DmrsPdschConfig(**kw)))
    assert 300 < valid < 448
    assert (_outcome(t_dmrs.symbols_idx, t_dmrs.DmrsPdschConfig(mapping_type="B"))
            == _outcome(r_dmrs.symbols_idx, r_dmrs.DmrsPdschConfig(mapping_type="B")))


@pytest.mark.parametrize("nof_prb", [24, 52])
def test_dmrs_put_sf_bit_for_bit(nof_prb):
    """put_sf on a zero grid and on a seeded grid, for every valid
    configuration at durations 14, 12 and 9 over subframes 0, 3 and 17 (and
    n_id, n_scid of both kinds): the reference's grid bit for bit; a numpy
    grid goes to the given device."""
    rng = np.random.default_rng(nof_prb)
    data = (rng.standard_normal((14, 12 * nof_prb)) + 1j * rng.standard_normal((14, 12 * nof_prb))
            ).astype(np.complex64)
    n = 0
    for kw in _all_configs(nof_prb):
        if kw["duration"] not in (14, 12, 9):
            continue
        kw.update(n_id=int(rng.integers(0, 1008)), n_scid=int(rng.integers(0, 2)))
        cfg, rcfg = t_dmrs.DmrsPdschConfig(**kw), r_dmrs.DmrsPdschConfig(**kw)
        if _outcome(r_dmrs.symbols_idx, rcfg)[0] == "raises":
            continue
        for tti in (0, 3, 17):
            ref = r_dmrs.put_sf(rcfg, tti, data.copy())
            got = t_dmrs.put_sf(cfg, tti, torch.from_numpy(data.copy()))
            assert torch.equal(got, torch.from_numpy(ref)), (kw, tti)
            got_np = t_dmrs.put_sf(cfg, tti, np.zeros_like(data), device="cpu")
            assert torch.equal(got_np, torch.from_numpy(r_dmrs.put_sf(rcfg, tti, np.zeros_like(data))))
            n += 1
    assert n == 84 * 3


def test_dmrs_get_sf_batched():
    """get_sf on a seeded received batch (3, 14, 12·52) — leading batch dim —
    within 1e-6 of the reference, and on a numpy grid as on the tensor."""
    rng = np.random.default_rng(7)
    shape = (3, 14, 12 * 52)
    rx = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    for kw in (dict(additional_pos=3), dict(type=2, length=2, additional_pos=1, n_id=500, n_scid=1),
               dict(duration=9, additional_pos=2, typeA_pos=3)):
        cfg, rcfg = t_dmrs.DmrsPdschConfig(**kw), r_dmrs.DmrsPdschConfig(**kw)
        for tti in (0, 5, 9, 11):
            ref = r_dmrs.get_sf(rcfg, tti, rx)
            got = t_dmrs.get_sf(cfg, tti, torch.from_numpy(rx))
            assert got.shape == ref.shape and got.dtype == torch.complex64
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
            assert torch.equal(t_dmrs.get_sf(cfg, tti, rx, device="cpu"), got)


def test_dmrs_numpy_grid_takes_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_dmrs.put_sf(t_dmrs.DmrsPdschConfig(), 0, np.zeros((14, 624), np.complex64))


def test_dmrs_run_on_the_cpu():
    """chip_smoke.py phase 42's DM-RS driver at 6 and 24 PRB."""
    import chip_smoke

    out = chip_smoke.dmrs_run("cpu", widths=(6, 24), batch=4, ttis=2, timed=False)
    for row in out.values():
        assert row["configs"] == 84 and row["cases"] == 168
        assert row["get_err"] <= chip_smoke.DMRS_GET_ATOL and row["flat_err"] <= chip_smoke.DMRS_FLAT_ATOL


def test_nr_link_run_on_the_cpu():
    """chip_smoke.py phase 42's coreless link."""
    import chip_smoke

    out = chip_smoke.nr_link_run()
    assert out["dl_bytes"] == out["ul_bytes"] == 50 * 300


# --- TTCN-3: the reference server's replies ------------------------------------------------


def _ttcn3_session(srv, requests):
    srv.serve_background()
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
    f = sock.makefile("rwb")
    replies = []
    try:
        for req in requests:
            if callable(req):
                req = req(replies)
            f.write((json.dumps(req) + "\n").encode())
            f.flush()
            replies.append(json.loads(f.readline()))
    finally:
        f.close()
        sock.close()
        srv.close()
    assert not srv._thread.is_alive()
    return replies


def test_ttcn3_system_interface():
    """The exchange of `tests/test_e2e_apps.py::test_ttcn3_system_interface`
    (cell, attach, RAR, Msg3, contention resolution + setup, the setup
    complete, status) plus ip_rx and an unknown command: every reply of the
    port's server equals the reference server's."""
    from srsran_tpu.stack import rrc
    from srsran_tpu.stack.mac import LCID_CCCH, LCID_CON_RES
    from srsran_tpu.stack.mac_pdu import DL_CE_SIZES, UL_CE_SIZES, mac_pack, mac_unpack
    from srsran_tpu.apps.full_stack import LCID_SRB1
    from srsran_tpu.apps.ttcn3 import SystemInterface as RefServer
    from srsran_tpu_torch.apps.ttcn3 import SystemInterface as PortServer

    def setup(replies):
        sdus = dict(mac_unpack(bytes.fromhex(replies[-1]["data"]), ce_sizes=UL_CE_SIZES))
        assert rrc.unpack_ul_ccch(sdus[LCID_CCCH])[0] == "rrc_conn_request"
        dl = mac_pack([(LCID_CON_RES, rrc.contention_resolution_id(sdus[LCID_CCCH])),
                       (LCID_CCCH, rrc.pack_conn_setup())], 128, ce_sizes=DL_CE_SIZES)
        return dict(cmd="dl_pdu", data=dl.hex())

    requests = [dict(cmd="cell_cfg", pci=7, nof_prb=6), dict(cmd="attach"),
                dict(cmd="rar", rapid=17, temp_crnti=0x46), dict(cmd="ul_pdu", size=64), setup,
                dict(cmd="ul_pdu", size=128), dict(cmd="status"), dict(cmd="ip_rx"), dict(cmd="bogus")]
    port = PortServer(device="cpu")
    got = _ttcn3_session(port, requests)
    assert port.phy.stack.device == torch.device("cpu")
    ref = _ttcn3_session(RefServer(), requests)
    assert got == ref
    assert got[1] == {"event": "prach", "preamble": 17} and got[2]["crnti"] == 0x46
    assert got[4]["rrc_state"] >= 3
    assert LCID_SRB1 in dict(mac_unpack(bytes.fromhex(got[5]["data"]), ce_sizes=UL_CE_SIZES))
    assert got[6]["rrc_state"] >= 3 and got[6]["crnti"] == 0x46
    assert got[8]["event"] == "error"


def test_ttcn3_run_on_the_cpu():
    """chip_smoke.py phase 42's TTCN-3 driver at 6 PRB."""
    import chip_smoke

    out = chip_smoke.ttcn3_run("cpu", nof_prb=6)
    assert out["crnti"] == 0x46 and out["rrc_state"] >= 3
