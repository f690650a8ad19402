"""Full-stack eNB and UE: PHY + MAC + RLC + PDCP + RRC-lite + NAS/EPC
over a bidirectional sample-level link, on the port.

Counterpart of `srsran_tpu/apps/full_stack.py`, the in-process analog of
the reference's `test/run_lte.sh` E2E setup (srsUE + srsENB + srsEPC over
ZMQ fake RF): every TTI the eNB renders a DL subframe and consumes the UE's
UL subframe; the complete LTE attach — PRACH → RAR → Msg3(RRC
ConnectionRequest) → RRC setup → NAS attach/auth/SMC via S1AP-lite to the
MME → AS security → DRB reconfiguration → GTP-U user plane through the
SPGW — runs over the port's OFDM/turbo PHY.

Both ends take `device=None` (the card; `device.resolve`) and run every
PHY facade there.  `EnbStack.run_tti` and `UeStack.run_tti` return their
subframes as complex64 tensors on that device and take the other end's
the same way: the samples never cross to the host.  The host reads back
only what a decision needs — a power gate as one `.item()`, decoded bits
and PUCCH/PRACH/SRS metrics once per call.  The host stack under it
(MAC, RLC, PDCP, RRC, NAS, the EPC) is the port's copy of the reference's.
The kernel TUN boundary (`UeStack.attach_tun`) is the port's `io.tun`.  TDD
(`tdd_cfg=`, frame structure 2) runs through the same facades: PRACH on
subframe 2, Table 8-2 grant timing, DL on D and DwPTS subframes, PUSCH on U
subframes, multiplexed HARQ-ACKs with channel selection; the dynamic and
windowed data planes stay FDD-only, as the reference's.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..device import resolve
from ..epc import Mme, Spgw, s1ap
from ..phy import tdd
from ..phy.common import Cell
from ..phy.enb.enb_dl import DlSched, enb_dl_subframe
from ..phy.enb.enb_ul import enb_ul_fft, enb_ul_decode_pucch, enb_ul_decode_pusch
from ..phy.phch.dci import Dci0, Dci1A
from ..phy.phch.pbch import Mib
from ..phy.phch.pdcch import nof_cce, search_space_candidates
from ..phy.phch.pdsch import DlGrant
from ..phy.phch.prach import PrachConfig, prach_detect, prach_nfft, prach_cp_len
from ..phy.phch.pusch import UlGrant
from ..phy.phch.ra import (
    dl_mcs_to_mod,
    dl_tbs,
    riv_decode,
    riv_encode,
    tbs_lookup,
    ul_mcs_to_itbs,
    ul_mcs_to_mod,
)
from ..phy.ue.ue_dl import ue_dl_decode_subframe
from ..phy.ue.ue_ul import ue_prach_send, ue_ul_encode
from ..stack import rrc
from ..stack import security as sec
from ..stack.gtpu import GtpuEndpoint, gtpu_unpack
from ..stack.mac import (LCID_CON_RES, LCID_PHR, Scheduler, UeMac,
                         parse_ul_pdu, phr_db, phr_index)
from ..stack.mac_pdu import DL_CE_SIZES, UL_CE_SIZES, mac_pack, mac_unpack
from ..stack.nas_ue import UeNas, Usim
from ..stack.pdcp import PdcpConfig, PdcpEntity
from ..stack.rlc import RlcAm, RlcTm

LCID_CCCH = 0
LCID_SRB1 = 1
LCID_DRB1 = 3

FB_DELAY = 4  # DCI0 at n → PUSCH at n+4 (FDD)


def _prach_sf(tdd_cfg) -> int:
    """PRACH occasion subframe: 1 for FDD (prach-ConfigIndex 3 analog);
    2 for TDD — the one subframe that is UL in every UL/DL config."""
    return 1 if tdd_cfg is None else 2


def _phich_resource(cell: Cell, grant: UlGrant) -> tuple[int, int]:
    """(n_group, n_seq) for a PUSCH, TS 36.213 §9.1.2 with n_DMRS = 0:
    n_group = I_PRB_RA mod N_group, n_seq spread by the PRB quotient."""
    from ..phy.phch.phich import nof_phich_groups, nof_phich_sequences

    ng = nof_phich_groups(cell)
    return grant.prb_start % ng, (grant.prb_start // ng) % nof_phich_sequences(cell)


UL_HARQ_MAX_TX = 4  # 1 + 3 retransmissions (reference harq default)

SRS_SF = 3  # cell-specific SRS subframe (srs-SubframeConfig analog)

SR_SF = 7  # scheduling-request occasion subframe (sr-ConfigIndex analog)


def _sr_resource(crnti: int) -> int:
    """Dedicated SR PUCCH resource (sr-PUCCH-ResourceIndex analog): above
    the dynamic-ACK range, still inside the band-edge PUCCH PRB."""
    return 15 + (crnti % 3)


def _is_sr_sf(enabled: bool, tdd_cfg, tti: int) -> bool:
    """SR occasion: sf 7 each frame (a U subframe in TDD configs 0/1/6;
    for other TDD configs SR rides UCI-on-PUSCH instead)."""
    if not enabled or tti % 10 != SR_SF:
        return False
    return tdd.sf_type(tdd_cfg, SR_SF) == tdd.SfType.U if tdd_cfg is not None else True


def _is_srs_sf(enabled: bool, tdd_cfg, tti: int) -> bool:
    """Cell-specific SRS subframe: sf 3 each frame; PUSCH there uses the
    shortened format.  Under TDD only where sf 3 is a U subframe (not in
    configurations 2 and 5, where it is D: no sounding there)."""
    if not enabled or tti % 10 != SRS_SF:
        return False
    return tdd.sf_type(tdd_cfg, SRS_SF) == tdd.SfType.U if tdd_cfg is not None else True


def _pusch_delay(tdd_cfg, tti: int) -> int | None:
    """Grant-to-PUSCH delay from DL subframe ``tti``; None when ``tti``
    is not a grant opportunity (TDD Table 8-2 has no k there)."""
    if tdd_cfg is None:
        return FB_DELAY
    k = tdd.K_PUSCH[tdd_cfg.sf_config][tti % 10]
    return k if k else None


def _read_pucch(bits: torch.Tensor, metric: torch.Tensor) -> tuple[float, np.ndarray]:
    """A PUCCH format-2/3 decode on the device, read in one transfer:
    (metric, bits as host ints)."""
    host = torch.cat([metric.reshape(1).to(torch.float32),
                      bits.to(torch.float32)]).cpu().numpy()
    return float(host[0]), host[1:].astype(int)


# The most of a format-1 signal's metric that another resource of its PRB
# reads (the cyclic shifts and covers leak under EPA's delay spread, and
# the noise): at most 1.3e-3 over 400 EPA 5 Hz subframes with AWGN 0.01 at
# 15 PRB, 4.6e-4 at 100 PRB, for every pair of resources (`PYTHONPATH=.
# python tests/test_torch_pucch_dtx.py`), bounded here with a margin of 3
PUCCH_LEAK = 1 / 256


def _pucch1_decodes(cell: Cell, sf_idx: int, grid, wanted: dict, device) -> dict:
    """The format-1 decodes of one UL subframe.  `wanted` maps each RNTI to
    the (n_pucch, nof_bits) it may answer on; returns {(rnti, n_pucch,
    nof_bits): (bits, metric)}.

    A metric is the energy of its resource's DMRS over the energy of its
    PRB, which holds every UE's format-1 signal code-multiplexed beside it:
    a UE faded 9 dB below another would read as DTX.  So where resources
    that only other RNTIs may use share the PRB, the share of the PRB's
    energy they explain (metric / 2 each: a format-1 signal fills every RE
    of its PRB, over two slots) leaves the denominator first, and the
    metric is judged against what is left.  An empty resource beside them
    reads at most PUCCH_LEAK of their metrics, 2 * PUCCH_LEAK * share: the
    denominator's floor 16 * PUCCH_LEAK * share keeps that at half the DTX
    threshold, and a UE still reads as present down to 21 dB (1/128) under
    them.  Where no other RNTI's resource shares the PRB, nothing
    changes.

    The dynamic HARQ-ACK resources (n_CCE + 2i) reach the SR resources
    (`_sr_resource`) on wide cells.  An SR resource that is also another
    RNTI's HARQ-ACK resource of the subframe reads as no SR (metric 0): its
    energy may be that UE's ACK, and the UE whose SR it is sends it again
    at the next occasion.  (An ACK on its own UE's SR resource still reads
    as that UE's SR too, as the reference reads it.)"""
    from ..phy.phch.pucch import PucchConfig, _f1_covers, pucch_f1_prb

    def prb(n: int) -> tuple[int, int]:
        return tuple(pucch_f1_prb(n, 2 * sf_idx + s, cell.nof_prb, covers=_f1_covers(cell))
                     for s in (0, 1))

    raw = {}
    for rnti, res in wanted.items():
        for n, nbits in res:
            bits, metric = enb_ul_decode_pucch(cell, sf_idx, grid, PucchConfig(n_pucch=n), "1", nbits,
                                               device=device)
            raw[rnti, n, nbits] = (bits, float(metric))
    out = {}
    for (rnti, n, nbits), (bits, m) in raw.items():
        own = {n2 for n2, _b in wanted[rnti]}
        others = {n2: m2 for (r2, n2, _b), (_bits, m2) in raw.items()
                  if r2 != rnti and n2 not in own and prb(n2) == prb(n)}
        if others:
            share = sum(others.values()) / 2
            m = m / max(1.0 - share, 16 * PUCCH_LEAK * share)
        if nbits == 0 and any(n2 == n and b2 > 0 and r2 != rnti for r2, n2, b2 in raw):
            m = 0.0
        out[rnti, n, nbits] = (bits, m)
    return out


def _pack_rar(rapid: int, ta: int, grant20: int, temp_crnti: int) -> bytes:
    """MAC RAR PDU (TS 36.321 §6.1.5): E/T/RAPID subheader + 6-byte RAR."""
    sub = 0x40 | (rapid & 0x3F)  # E=0, T=1
    body = (
        ((ta & 0x7FF) << 36) | ((grant20 & 0xFFFFF) << 16) | (temp_crnti & 0xFFFF)
    ).to_bytes(6, "big")
    return bytes([sub]) + body


def _unpack_rar(pdu: bytes) -> tuple[int, int, int, int] | None:
    if len(pdu) < 7 or not (pdu[0] & 0x40):
        return None
    rapid = pdu[0] & 0x3F
    v = int.from_bytes(pdu[1:7], "big")
    return rapid, (v >> 36) & 0x7FF, (v >> 16) & 0xFFFFF, v & 0xFFFF


def _msg3_grant(cell: Cell, rnti: int, grant20: int) -> UlGrant:
    riv = (grant20 >> 10) & 0x3FF
    mcs = (grant20 >> 5) & 0x1F
    rb0, l_crb = riv_decode(cell.nof_prb, riv)
    return UlGrant(
        prb_start=rb0, nof_prb=l_crb, mod=ul_mcs_to_mod(mcs),
        tbs=tbs_lookup(ul_mcs_to_itbs(mcs), l_crb), rnti=rnti,
    )


def _bearer_set(k_enb: bytes | None, cipher: int, integ: int, is_enb: bool):
    """Build (srb1_pdcp, drb_pdcp) for the given AS security state."""
    if k_enb is None:
        return (
            PdcpEntity(PdcpConfig(is_srb=True, bearer_id=1, direction_tx=1 if is_enb else 0)),
            PdcpEntity(PdcpConfig(sn_bits=12, bearer_id=3, direction_tx=1 if is_enb else 0)),
        )
    rrc_enc, rrc_int, up_enc = sec.generate_as_keys(k_enb, cipher, integ)
    return (
        PdcpEntity(
            PdcpConfig(is_srb=True, bearer_id=1, direction_tx=1 if is_enb else 0,
                       cipher_alg=cipher, integrity_alg=integ),
            k_enc=rrc_enc, k_int=rrc_int,
        ),
        PdcpEntity(
            PdcpConfig(sn_bits=12, bearer_id=3, direction_tx=1 if is_enb else 0,
                       cipher_alg=cipher),
            k_enc=up_enc,
        ),
    )


# ---------------------------------------------------------------------------
# eNB
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _EnbUe:
    """Per-UE eNB context (the phy_ue_db + rrc_ue pair of the reference)."""

    crnti: int
    enb_ue_id: int
    dl_teid: int
    rrc_state: int = 0
    srb0: RlcTm = dataclasses.field(default_factory=RlcTm)
    srb1_rlc: RlcAm = dataclasses.field(default_factory=RlcAm)
    drb_rlc: RlcAm = dataclasses.field(default_factory=RlcAm)
    srb1_pdcp: PdcpEntity = None
    drb_pdcp: PdcpEntity = None
    k_enb: bytes | None = None
    mme_ue_id: int | None = None
    pending_reconf_nas: bytes | None = None
    last_ul_ok_tti: int = 0
    rapid: int = -1
    spgw_teid: int = 0
    cf_preamble: int = -1  # dedicated contention-free preamble (HO target)
    scell_state: int = 0  # 0 = none, 1 = SCell reconfig sent, 2 = configured+activated
    last_ul_snr_db: float | None = None  # DMRS SNR estimate (link adaptation)
    last_ul_rx_db: float | None = None  # per-RE PUSCH rx power, drives TPC
    last_cqi_tti: int = -(10 ** 6)  # aperiodic-CQI staleness tracking
    is_reest: bool = False  # re-establishment in progress (no NAS attach)
    srs_snr_db: float | None = None  # wideband sounding measurement
    last_phr_db: int | None = None  # last power-headroom report
    last_ri: int = 1  # rank indicator from UCI (drives 2-codeword grants)
    last_pmi: int = 0  # codebook recommendation (TM4)
    release_at: int = -1  # graceful release scheduled for this tti
    s_tmsi: int | None = None  # from an S-TMSI RRCConnectionRequest
    is_ho_target: bool = False
    s1_ho: bool = False  # target admitted via S1 HandoverRequest
    ho_in_flight: bool = False  # source-side guard

    def __post_init__(self):
        if self.srb1_pdcp is None:
            self.srb1_pdcp, self.drb_pdcp = _bearer_set(None, 0, 0, is_enb=True)


CQI_PERIOD = 10  # periodic wideband CQI: TTIs where tti % 10 == 5
RI_PERIOD_FACTOR = 4  # m-RI: every 4th periodic report carries RI instead


def cqi_on_pusch(tti: int) -> bool:
    return tti % CQI_PERIOD == 5


def cqi_report_is_ri(tti: int) -> bool:
    """TS 36.213 §7.2.2: the RI report rides every m-RI-th periodic CQI
    occasion (cc_worker.cc:822 set_uci_periodic_cqi RI instances)."""
    return (tti // CQI_PERIOD) % RI_PERIOD_FACTOR == 0


def _cqi_resource(crnti: int) -> int:
    """Dedicated periodic-CQI PUCCH format-2 resource
    (cqi-PUCCH-ResourceIndex analog), above the SR range."""
    return 20 + (crnti % 6)


def _f3_resource(crnti: int) -> int:
    """Dedicated CA HARQ-ACK PUCCH format-3 resource
    (n3PUCCH-AN-List analog, pucch_proc.c:60-150), above the CQI range."""
    return 26 + (crnti % 3)


def snr_db_to_cqi(snr_db: float) -> int:
    """Wideband SNR -> CQI (the reference maps via cqi_from_snr tables;
    ~2 dB per CQI step)."""
    return int(np.clip(round((snr_db - 1.0) / 2.0) + 1, 1, 15))


HO_CF_PREAMBLE = 11  # dedicated contention-free preamble for handovers


class EnbStack:
    RRC_IDLE, RRC_SETUP_SENT, RRC_CONNECTED, RRC_SMC_SENT, RRC_RECONF_SENT, RRC_ACTIVE = range(6)

    def __init__(self, cell: Cell, mme: Mme, spgw: Spgw, crnti: int = 0x46, mcs: int = 5, cfi: int = 2,
                 enb_id: int = 0x19B, tdd_cfg: tdd.TddConfig | None = None,
                 scell: Cell | None = None, srs_enabled: bool = False,
                 sr_enabled: bool = False, tm: int = 2, ul_ca: bool = False,
                 dynamic_phy: bool = False, earfcn: int = 3400,
                 windowed_phy: bool = False, phy_window: int = 4,
                 phy_device=None, cfi_adapt: bool = False,
                 subband_cqi: bool = False, *, device=None):
        # every PHY call runs on `device` (None: the card); phy_device is
        # the windowed plane's and defaults to it
        self.device = resolve(device)
        phy_device = self.device if phy_device is None else resolve(phy_device)
        # frequency-selective feedback: aperiodic CQI requests return
        # higher-layer-configured SUBBAND reports (cqi.c:41-75) and the
        # scheduler places PRBs by per-subband CQI
        self.subband_cqi = subband_cqi
        self.sr_enabled = sr_enabled
        # CFI adaptation (scheduler_grid.cc role): per-TTI control-region
        # sizing from the dry-run CCE demand; the UE side must then read
        # the CFI from PCFICH (UeStack cfi=None)
        self.cfi_adapt = cfi_adapt
        assert not (cfi_adapt and windowed_phy), (
            "the windowed engines compile per fixed CFI; CFI adaptation "
            "needs the per-TTI host path")
        self.earfcn = earfcn  # this cell's DL carrier (inter-freq mobility)
        # dynamic_phy: decode UCI-free PUSCH TTIs on the bucketed TPU
        # pipeline (pipeline_dynamic.DynamicEnbUl); host path otherwise
        self._dyn_ul = None
        if dynamic_phy:
            from ..pipeline_dynamic import DynamicEnbUl

            self._dyn_ul = DynamicEnbUl(cell, device=self.device)
        # windowed_phy: the windowed TPU engines as the live data plane
        # (pipeline_window via apps.windowed_plane) — W TTIs per dispatch,
        # HARQ feedback stretched to 4+W on BOTH ends (see
        # windowed_plane.py's timing contract); FDD only
        self._win_ul = None
        self.harq_delay = 4
        # windowed CONTROL plane (apps.windowed_stack): DCI-0 grants, RAR
        # Msg3 and PHICH retransmissions run at a stretched fixed delay
        # instead of the TS 36.213 +4 (None = spec timing)
        self.ul_grant_delay: int | None = None
        # simultaneousPUCCH-PUSCH (TS 36.213 r10): UCI stays on PUCCH
        # even when a PUSCH is scheduled (the windowed control plane's
        # contract; False = UCI-on-PUSCH multiplexing as in ue_ul.c)
        self.simul_pucch_pusch = False
        if windowed_phy:
            assert tdd_cfg is None, "windowed data plane is FDD-only"
            from .windowed_plane import WindowedEnbUlPlane

            self._win_ul = WindowedEnbUlPlane(cell, w=phy_window,
                                              device=phy_device)
            self.harq_delay = 4 + phy_window
        # R10 UL carrier aggregation: BSRs also credit the SCell scheduler,
        # DCI0s go out on the SCell PDCCH, and the UE's UL becomes
        # (2, sf_len) — the 2nd UL cc_worker of the reference's CA path
        self.ul_ca = ul_ca
        self.cell = cell
        # transmission mode (TS 36.213 §7.1): 2 = SFBC, 3 = open-loop SM
        # (CDD, DCI 2A), 4 = closed-loop SM (codebook, DCI 2).  TM3/4
        # need a 2-port cell and emit per-port sample streams.
        self.tm = tm
        assert tm in (1, 2, 3, 4)
        if tm >= 3:
            assert cell.nof_ports == 2, "TM3/TM4 need a 2-port cell"
        self.tdd = tdd_cfg
        self.prach_sf = _prach_sf(tdd_cfg)
        self.scell = scell  # R10 carrier aggregation secondary cell (DL)
        self.mme = mme
        self.enb_id = enb_id
        if hasattr(mme, "register_enb"):
            mme.register_enb(enb_id, self._s1ap_rx)
        self.spgw = spgw
        self.cfi = cfi
        self.mib = Mib(nof_prb=cell.nof_prb)
        self.prach_cfg = PrachConfig()
        # system information broadcast (BCCH-DL-SCH on SI-RNTI): SIB1 on
        # sf 5 of even SFNs (TS 36.331 §5.2.1.2), SIB2 in an rf8 SI window
        self._sib1 = rrc.pack_sib1(cell_id=(enb_id << 8) | (cell.id & 0xFF))
        self._sib2 = rrc.pack_sib2(nof_ra_preambles=52, prach_config_index=3,
                                   sib3=rrc.make_sib3())
        self.sched = Scheduler(cell.nof_prb, mcs_max=mcs)
        # CA: the SCell gets its own scheduler (the per-carrier
        # scheduler_carrier.cc instance) pulling from the same RLC bearers
        self.scell_sched = Scheduler(scell.nof_prb, mcs_max=mcs) if scell else None
        self.mcs_max = mcs
        # multi-UE contexts (phy_ue_db.cc analog)
        self.ues: dict[int, _EnbUe] = {}
        self._by_enb_id: dict[int, _EnbUe] = {}
        self._next_crnti = crnti
        self._next_enb_ue_id = 1
        self._next_teid = 101
        self.cipher_alg, self.integ_alg = 2, 2
        self.pending_rars: deque = deque()  # (rapid, ta, crnti)
        self.pending_pcch: deque = deque()  # PCCH Paging messages to send
        self.pending_ul: dict[int, tuple[int, UlGrant]] = {}  # tti -> (rnti, grant)
        self.pending_ul_scell: dict[int, tuple[int, UlGrant]] = {}
        # FDD CA: SCell ACK expectations (format-3 codebook position 1)
        self.pending_dl_ack_scell: dict[int, list] = {}
        # DL HARQ feedback: ack_tti -> [{rnti, pid, n_pucch, on_pusch}]
        # (the phy_common.cc pending_dl_ack ring; resource = CCE index,
        # pucch_proc.c:257 n_pucch_i)
        self.pending_dl_ack: dict[int, list[dict]] = {}
        # UL HARQ: PHICH to send (dl_tti -> [(group, n_seq, hi)]) and the
        # per-retx softbuffer chain (pusch_tti -> (softbuffers, tx_count))
        self.pending_phich: dict[int, list[tuple[int, int, int]]] = {}
        self._ul_harq: dict[int, tuple] = {}
        self._apcqi: set[int] = set()  # PUSCH ttis carrying aperiodic CQI
        self.apcqi_interval = 40  # request when the last report is stale
        self.srs_enabled = srs_enabled  # cell-specific SRS subframes active
        self.gtpu = GtpuEndpoint()
        self.tti = 0
        self.stats = {"prach_detected": 0, "ul_crc_ok": 0, "ul_crc_ko": 0, "ue_released": 0}
        self.ul_inactivity_timeout = 40  # TTIs without UL → release context
        # mobility (rrc_mobility.cc roles): measurement config sent with the
        # bearer reconfiguration, and coordinator hooks
        self.meas_cfg: dict | None = None
        self.on_meas_report = None  # (enb, ue, meas_results) -> None
        self.on_ho_complete = None  # (enb, ue) -> None
        self.s1_neighbors: dict[int, int] = {}  # target PCI -> macro eNB id (rr.conf nbr list)

    def _ack_tti(self, dl_tti: int) -> int:
        """ACK position for a PDSCH at dl_tti: TS 36.213 §10.1 timing, or
        dl_tti + harq_delay on the windowed data plane (both ends run the
        same stretched-feedback contract)."""
        if self.harq_delay != 4:
            return dl_tti + self.harq_delay
        return tdd.ack_tti(self.tdd, dl_tti)

    def _phich_tti(self, pusch_tti: int) -> int:
        if self.harq_delay != 4:
            return pusch_tti + self.harq_delay
        return tdd.phich_tti(self.tdd, pusch_tti)

    # --- single-UE compatibility views ---
    @property
    def rrc_state(self) -> int:
        return max((u.rrc_state for u in self.ues.values()), default=self.RRC_IDLE)

    @property
    def crnti(self) -> int:
        return self._next_crnti

    def _new_ue(self, rapid: int) -> _EnbUe:
        ue = _EnbUe(
            crnti=self._next_crnti, enb_ue_id=self._next_enb_ue_id,
            dl_teid=self._next_teid, rapid=rapid, last_ul_ok_tti=self.tti,
        )
        self._next_crnti += 1
        self._next_enb_ue_id += 1
        self._next_teid += 1
        self.ues[ue.crnti] = ue
        self._by_enb_id[ue.enb_ue_id] = ue
        return ue

    # --- S1AP plumbing (in-process "SCTP") ---
    def _s1ap_send(self, msg: bytes):
        for resp in self.mme.handle(msg, enb_id=self.enb_id):
            self._s1ap_rx(resp)

    def _s1ap_rx(self, data: bytes):
        name, ies = s1ap.unpack(data)
        ue = self._by_enb_id.get(ies.get("enb_ue_s1ap_id"))
        if name == "dl_nas_transport" and ue is not None:
            ue.mme_ue_id = ies["mme_ue_s1ap_id"]
            self._send_srb1(ue, rrc.pack_dl_info_transfer(ies["nas_pdu"]))
        elif name == "init_context_setup_request" and ue is not None:
            ue.mme_ue_id = ies["mme_ue_s1ap_id"]
            ue.k_enb = ies["security_key"].to_bytes(32, "big")
            erab = ies["erab_to_be_setup_list_ctxt_su_req"][0]
            spgw_teid = int.from_bytes(erab["gtp_teid"], "big")
            ue.spgw_teid = spgw_teid
            self.gtpu.add_bearer(ue.dl_teid, spgw_teid)
            ue.pending_reconf_nas = erab.get("nas_pdu", b"")
            # AS security activation (rrc_ue.cc send_security_mode_command)
            self._send_srb1(ue, rrc.pack_security_mode_command(self.cipher_alg, self.integ_alg))
            ue.rrc_state = self.RRC_SMC_SENT
            self._s1ap_send(
                s1ap.pack_initial_context_setup_response(
                    ue.mme_ue_id, ue.enb_ue_id, enb_teid=ue.dl_teid, ebi=erab["erab_id"]
                )
            )
        elif name == "ue_context_release_cmd":
            _, ids = ies["ue_s1ap_ids"]
            rel = self._by_enb_id.get(ids.get("enb_ue_s1ap_id")) if isinstance(ids, dict) else None
            if rel is not None:
                self._s1ap_send(s1ap.pack_ue_context_release_complete(
                    rel.mme_ue_id or 0, rel.enb_ue_id))
                # MME-commanded release (S1 HO source / detach): if DL is
                # still queued for the UE (e.g. the Detach Accept), let it
                # drain first; otherwise drop the context immediately
                if rel.srb1_rlc.buffer_state() > 0 and rel.release_at < 0:
                    rel.release_at = self.tti + 15
                else:
                    self._release_ue(rel, notify_mme=False)
        elif name == "paging":
            # S1AP Paging → PCCH at the next paging occasion (paging_sf)
            kind, pid = ies.get("ue_paging_id", (None, None))
            if kind == "s_tmsi":
                as_int = lambda v: int.from_bytes(v, "big") if isinstance(v, bytes) else int(v)
                self.pending_pcch.append(rrc.pack_pcch_paging(
                    as_int(pid["m_tmsi"]), as_int(pid.get("mmec", 1))))
        elif name == "ho_request":
            self._admit_s1_handover(ies)
        elif name == "ho_cmd":
            src_ue = self._by_enb_id.get(ies.get("enb_ue_s1ap_id"))
            if src_ue is not None:
                # the transparent container IS the target's RRC handover
                # command (reconfiguration with mobilityControlInfo) —
                # forwarded to the UE verbatim (rrc_mobility.cc)
                self._send_srb1(src_ue, ies["target_to_source_transparent_container"])

    def _send_srb1(self, ue: _EnbUe, rrc_pdu: bytes):
        ue.srb1_rlc.write_sdu(ue.srb1_pdcp.write_sdu(rrc_pdu))

    # --- RRC handling ---
    def _handle_ccch(self, ue: _EnbUe, pdu: bytes):
        kind, fields = rrc.unpack_ul_ccch(pdu)
        if kind == "rrc_conn_request" and ue.rrc_state in (self.RRC_IDLE, self.RRC_SETUP_SENT):
            id_kind, id_val = fields["ue_id"]
            if id_kind == "s_tmsi":  # idle-mode resume: carry it to the MME
                ue.s_tmsi = id_val["m_tmsi"]
            # Msg4: contention-resolution CE (first 48 bits of Msg3) + Setup
            self.sched.push_ce(ue.crnti, LCID_CON_RES, rrc.contention_resolution_id(pdu))
            ue.srb0.write_sdu(rrc.pack_conn_setup())
            self.sched.bearer_ue_cfg(ue.crnti, LCID_CCCH, ue.srb0)
            self.sched.bearer_ue_cfg(ue.crnti, LCID_SRB1, ue.srb1_rlc)
            ue.rrc_state = self.RRC_SETUP_SENT
        elif kind == "rrc_conn_reest_request" and ue.rrc_state in (self.RRC_IDLE, self.RRC_SETUP_SENT):
            # TS 36.331 §5.3.7 at the eNB (rrc_ue.cc re-establishment):
            # verify the shortMAC-I against the OLD context, adopt it
            # under the new C-RNTI (bearers/TEIDs/S1 ids survive)
            ident = fields["ue_id"]
            old = self.ues.get(ident["c_rnti"])
            self.sched.push_ce(ue.crnti, LCID_CON_RES, rrc.contention_resolution_id(pdu))
            self.sched.bearer_ue_cfg(ue.crnti, LCID_CCCH, ue.srb0)
            ok = (old is not None and old is not ue and old.k_enb is not None
                  and ident["pci"] == self.cell.id
                  and ident["short_mac_i"] == rrc.short_mac_i(
                      old.k_enb, self.integ_alg, ident["pci"], ident["c_rnti"], self.cell.id))
            if not ok:
                ue.srb0.write_sdu(rrc.pack_reest_reject())
                self.stats["reest_reject"] = self.stats.get("reest_reject", 0) + 1
                # forget the temporary RA context once the reject drains so
                # the UE's fallback full attach isn't deduped against it
                ue.rapid = -1
                return
            # context transfer (no path switch: same TEIDs / MME ids)
            ue.k_enb = old.k_enb
            ue.mme_ue_id, ue.enb_ue_id = old.mme_ue_id, old.enb_ue_id
            ue.dl_teid, ue.spgw_teid = old.dl_teid, old.spgw_teid
            self._by_enb_id[ue.enb_ue_id] = ue
            del self.ues[old.crnti]
            self.sched.ue_rem(old.crnti)
            ue.srb1_pdcp, ue.drb_pdcp = _bearer_set(
                ue.k_enb, self.cipher_alg, self.integ_alg, is_enb=True)
            ue.is_reest = True
            ue.srb0.write_sdu(rrc.pack_reest(ncc=0))
            self.sched.bearer_ue_cfg(ue.crnti, LCID_SRB1, ue.srb1_rlc)
            ue.rrc_state = self.RRC_SETUP_SENT
            self.stats["reest_ok"] = self.stats.get("reest_ok", 0) + 1

    def _handle_srb1(self, ue: _EnbUe, pdcp_pdu: bytes):
        rrc_pdu = ue.srb1_pdcp.write_pdu(pdcp_pdu)
        if rrc_pdu is None:
            return
        kind, body = rrc.unpack_ul_dcch(rrc_pdu)
        if kind == "rrc_conn_setup_complete":
            ue.rrc_state = self.RRC_CONNECTED
            self._s1ap_send(
                s1ap.pack_initial_ue_message(ue.enb_ue_id, body["ded_info_nas"],
                                             m_tmsi=ue.s_tmsi)
            )
        elif kind == "rrc_conn_reest_complete":
            # resume the data bearer on the re-established connection
            # (no NAS signalling: the core never sees the RLF)
            ue.is_reest = False
            self._send_srb1(ue, rrc.pack_reconfiguration(
                drb_id=1, lcid=LCID_DRB1, eps_bearer_id=5, meas_cfg=self.meas_cfg))
            ue.rrc_state = self.RRC_RECONF_SENT
        elif kind == "ul_info_transfer":
            self._s1ap_send(
                s1ap.pack_ul_nas(ue.mme_ue_id or 0, ue.enb_ue_id, body["ded_info_type"][1])
            )
        elif kind == "security_mode_complete":
            # switch SRB1/DRB to secured PDCP entities (counts reset)
            ue.srb1_pdcp, ue.drb_pdcp = _bearer_set(
                ue.k_enb, self.cipher_alg, self.integ_alg, is_enb=True
            )
            reconf = rrc.pack_reconfiguration(
                drb_id=1, lcid=LCID_DRB1, eps_bearer_id=5,
                nas_pdu=ue.pending_reconf_nas or b"",
                meas_cfg=self.meas_cfg,
            )
            self._send_srb1(ue, reconf)
            ue.rrc_state = self.RRC_RECONF_SENT
        elif kind == "rrc_conn_recfg_complete":
            if ue.rrc_state == self.RRC_ACTIVE and ue.scell_state == 1:
                # SCell reconfiguration acked → activate it (MAC CE, TS
                # 36.321 §6.1.3.8) and start scheduling on the SCell
                ue.scell_state = 2
                from ..stack.mac_pdu import LCID_SCELL_ACT, scell_activation_ce

                self.sched.push_ce(ue.crnti, LCID_SCELL_ACT, scell_activation_ce({1}))
                self.scell_sched.ue_cfg(ue.crnti)
                self.scell_sched.bearer_ue_cfg(ue.crnti, LCID_SRB1, ue.srb1_rlc)
                self.scell_sched.bearer_ue_cfg(ue.crnti, LCID_DRB1, ue.drb_rlc)
                return
            self.sched.bearer_ue_cfg(ue.crnti, LCID_DRB1, ue.drb_rlc)
            ue.rrc_state = self.RRC_ACTIVE
            if self.scell is not None and ue.scell_state == 0:
                # CA: configure the SCell now that the default bearer is up
                # (rrc_ue.cc sends SCellToAddMod in a follow-up reconfig)
                ue.scell_state = 1
                self._send_srb1(ue, rrc.pack_reconfiguration(
                    scells=[rrc.make_scell_config(
                        1, self.scell.id, 3400, self.scell.nof_prb,
                        nof_ports=max(self.scell.nof_ports, 1))],
                ))
            if ue.is_ho_target:
                ue.is_ho_target = False
                if ue.s1_ho:
                    ue.s1_ho = False
                    self._s1ap_send(s1ap.pack_handover_notify(ue.mme_ue_id or 0, ue.enb_ue_id))
                elif self.on_ho_complete:
                    self.on_ho_complete(self, ue)
        elif kind == "meas_report":
            if self.on_meas_report:
                self.on_meas_report(self, ue, body["meas_results"])
            else:
                self._maybe_s1_handover(ue, body["meas_results"])

    # --- TTI processing ---
    def run_tti(self, ul_samples: torch.Tensor | None) -> torch.Tensor:
        """One TTI: take the UE's UL subframe of the previous TTI ((sf_len,)
        complex64 on `device`, (2, sf_len) with UL CA, or None) and return
        this TTI's DL subframe on `device`."""
        tti = self.tti
        sf_idx = tti % 10
        for u in self.ues.values():  # RLC timers (t-PollRetransmit etc.)
            for ent in (u.srb1_rlc, u.drb_rlc):
                if hasattr(ent, "tick"):
                    ent.tick()
        scell_ul = None
        if ul_samples is not None and ul_samples.ndim == 2:
            ul_samples, scell_ul = ul_samples[0], ul_samples[1]
        self._process_ul(tti, sf_idx, ul_samples)
        if scell_ul is not None and self.scell is not None:
            self._process_scell_ul(tti, sf_idx, scell_ul)
        if self._win_ul is not None:
            # the PUSCH plane lives in the link's tti-1 domain (samples
            # arrive one TTI after the UE transmitted them)
            self._win_ul.flush(tti - 1)
            for ev in self._win_ul.poll(tti - 1):
                self._complete_ul_data(ev)
        if hasattr(self.mme, "pump_s11"):
            self.mme.pump_s11()  # DDN → S1AP Paging fan-out
        # UL inactivity → graceful RRCConnectionRelease, then context
        # release a few TTIs later so the message can drain (rrc_ue.cc
        # send_connection_release before the S1 UEContextRelease)
        for ue in list(self.ues.values()):
            if ue.release_at >= 0:
                if tti >= ue.release_at:
                    self._release_ue(ue)
                continue
            if ue.rrc_state != self.RRC_IDLE and tti - ue.last_ul_ok_tti > self.ul_inactivity_timeout:
                self._send_srb1(ue, rrc.pack_conn_release())
                ue.release_at = tti + 15
        self._pump_spgw()
        dl = self._build_dl(tti, sf_idx)
        if self.scell is not None:
            dl = torch.stack([dl, self._build_scell_dl(tti, sf_idx)])
        self.tti += 1
        return dl

    def _heard(self, rnti: int):
        """A PUCCH of `rnti` was detected: the UE is on the air, and the UL
        inactivity release waits, as for a PUSCH that passed its CRC.  (A
        UE that only receives sends no PUSCH once SRs replace the blind UL
        grants, and its HARQ-ACKs are then all the UL it has.)"""
        ue = self.ues.get(rnti)
        if ue is not None:
            ue.last_ul_ok_tti = self.tti

    def _in_meas_gap(self, tti: int) -> bool:
        """True when connected UEs are away on a measurement gap (the
        eNB configured the gaps, so it knows not to schedule then)."""
        if self.meas_cfg is None:
            return False
        gap = rrc.meas_config_gap(self.meas_cfg)
        if gap is None:
            return False
        period, offset = gap
        return (tti - offset) % period < 6

    def _maybe_s1_handover(self, ue: _EnbUe, results: dict):
        """Source side of an S1 handover (rrc_mobility.cc S1 path): the
        reported PCI maps to a configured neighbour eNB, so ask the MME."""
        neigh = results.get("meas_result_neigh_cells")
        if not neigh or neigh[0] != "meas_result_list_eutra" or ue.ho_in_flight:
            return
        pci = neigh[1][0]["pci"]
        target_enb = self.s1_neighbors.get(pci)
        if target_enb is None or ue.mme_ue_id is None:
            return
        ue.ho_in_flight = True
        container = bytes([self.cipher_alg, self.integ_alg])
        self._s1ap_send(s1ap.pack_handover_required(
            ue.mme_ue_id, ue.enb_ue_id, target_enb, container))

    def _admit_s1_handover(self, ies: dict):
        """Target side: S1AP HandoverRequest → admit, build the RRC
        handover command, answer HandoverRequestAcknowledge."""
        container = ies["source_to_target_transparent_container"]
        cipher_alg, integ_alg = (container[0], container[1]) if len(container) >= 2 else (2, 2)
        erab = ies["erab_to_be_setup_list_ho_req"][0]
        ue = _EnbUe(
            crnti=self._next_crnti, enb_ue_id=self._next_enb_ue_id,
            dl_teid=self._next_teid, last_ul_ok_tti=self.tti,
        )
        self._next_crnti += 1
        self._next_enb_ue_id += 1
        self._next_teid += 1
        ue.k_enb = ies["security_context"]["next_hop_param"].to_bytes(32, "big")
        ue.mme_ue_id = ies["mme_ue_s1ap_id"]
        ue.spgw_teid = int.from_bytes(erab["gtp_teid"], "big")
        ue.cf_preamble = HO_CF_PREAMBLE
        ue.is_ho_target = True
        ue.s1_ho = True
        ue.rrc_state = self.RRC_RECONF_SENT
        ue.srb1_pdcp, ue.drb_pdcp = _bearer_set(ue.k_enb, cipher_alg, integ_alg, is_enb=True)
        self.ues[ue.crnti] = ue
        self._by_enb_id[ue.enb_ue_id] = ue
        self.gtpu.add_bearer(ue.dl_teid, ue.spgw_teid)
        self.sched.ue_cfg(ue.crnti)
        self.sched.bearer_ue_cfg(ue.crnti, LCID_SRB1, ue.srb1_rlc)
        rrc_cmd = rrc.pack_reconfiguration(
            mob_ctrl=rrc.make_mobility_control(
                self.cell.id, ue.crnti, HO_CF_PREAMBLE,
                carrier_arfcn=self.earfcn),
            transaction_id=3,
            security_ho_ncc=ies["security_context"]["next_hop_chaining_count"],
        )
        self._s1ap_send(s1ap.pack_handover_request_ack(
            ue.mme_ue_id, ue.enb_ue_id, ue.dl_teid, rrc_cmd, ebi=erab["erab_id"]))

    def prepare_handover_target(self, src_ue: _EnbUe, preamble: int,
                                cipher_alg: int, integ_alg: int) -> int:
        """Admit an incoming intra-eNB handover (rrc_mobility.cc
        ho_prep/target admission): new C-RNTI, dedicated CF preamble,
        re-established secured bearers with the source keys, and the SAME
        S1/GTP identifiers — no path switch needed."""
        ue = _EnbUe(
            crnti=self._next_crnti, enb_ue_id=src_ue.enb_ue_id,
            dl_teid=src_ue.dl_teid, last_ul_ok_tti=self.tti,
        )
        self._next_crnti += 1
        ue.k_enb = src_ue.k_enb
        ue.mme_ue_id = src_ue.mme_ue_id
        ue.spgw_teid = src_ue.spgw_teid
        ue.cf_preamble = preamble
        ue.is_ho_target = True
        ue.rrc_state = self.RRC_RECONF_SENT
        ue.srb1_pdcp, ue.drb_pdcp = _bearer_set(ue.k_enb, cipher_alg, integ_alg, is_enb=True)
        self.ues[ue.crnti] = ue
        self._by_enb_id[ue.enb_ue_id] = ue
        if ue.spgw_teid:
            self.gtpu.add_bearer(ue.dl_teid, ue.spgw_teid)
        self.sched.ue_cfg(ue.crnti)
        self.sched.bearer_ue_cfg(ue.crnti, LCID_SRB1, ue.srb1_rlc)
        return ue.crnti

    def _release_ue(self, ue: _EnbUe, notify_mme: bool = True):
        """Remove the UE context so a fresh random access can re-establish
        (s1ap UEContextRelease + rrc_ue removal in the reference). The MME
        is told first so it releases the access bearers at the SPGW
        (→ ECM-IDLE; further DL traffic triggers DDN + paging).
        notify_mme=False: source-side cleanup after intra-eNB handover —
        the S1 context lives on at the target cell."""
        if self.ues.get(ue.crnti) is not ue:
            return  # already released (the MME's release command re-enters)
        self.stats["ue_released"] += 1
        self.gtpu.rem_bearer(ue.dl_teid)
        self.sched.ue_rem(ue.crnti)
        self.ues.pop(ue.crnti, None)
        if self._by_enb_id.get(ue.enb_ue_id) is ue:
            self._by_enb_id.pop(ue.enb_ue_id, None)
        self.pending_ul = {t: (r, g) for t, (r, g) in self.pending_ul.items() if r != ue.crnti}
        # the UL HARQ softbuffers of the released grants go with them: a
        # later grant at one of those TTIs must not combine into a stale
        # buffer of another size (ROADMAP Queue 3: the reference keeps them)
        self._ul_harq = {t: v for t, v in self._ul_harq.items() if t in self.pending_ul}
        if ue.mme_ue_id and notify_mme:
            self._s1ap_send(s1ap.pack_ue_context_release_request(ue.mme_ue_id, ue.enb_ue_id))

    def _process_ul(self, tti: int, sf_idx: int, samples: torch.Tensor | None):
        # the link delivers the UE's subframe one TTI later
        tti = tti - 1
        sf_idx = tti % 10
        acks = self.pending_dl_ack.pop(tti, [])
        self._pusch_acks = []
        self._sc_acks_pusch = []
        if samples is None:
            for e in acks:  # DTX: nothing received at all → NACK (retx)
                self.sched.ack_info(e["rnti"], e["pid"], False)
                self.stats["dl_nack"] = self.stats.get("dl_nack", 0) + 1
            return
        # PUCCH format 1a ACK/NACK (UEs without a PUSCH this subframe);
        # with M > 1 (TDD association sets) the UE bundles: one bit on the
        # last grant's resource covers all M PDSCHs (TS 36.213 §10.1 ACK
        # bundling; reference gen_ack_tdd, ue_dl.c:1234)
        pucch_by_rnti: dict[int, list[dict]] = {}
        for e in acks:
            if not e["on_pusch"]:
                pucch_by_rnti.setdefault(e["rnti"], []).append(e)
        sc_acks = self.pending_dl_ack_scell.pop(tti, [])
        # scheduling requests (proc_sr.cc / mac.cc sr_detected): on-off
        # keyed PUCCH format 1 on each UE's dedicated SR resource, none
        # before Msg4
        sr_rntis = ([r for r, u in self.ues.items() if u.rrc_state >= self.RRC_SETUP_SENT]
                    if _is_sr_sf(self.sr_enabled, self.tdd, tti) else [])
        if pucch_by_rnti or sc_acks or sr_rntis:
            from ..phy.phch.pucch import PucchConfig, tdd_channel_selection_decode

            rx_grid_ack = enb_ul_fft(self.cell, samples[None], device=self.device)
            # FDD CA: UEs with an SCell bit this occasion answered on
            # their format-3 resource — BOTH codebook bits ride it
            # (pucch_proc.c:60-150 format-3 selection)
            # SCell bits whose RNTI has a PUSCH this TTI ride UCI-on-PUSCH
            # instead (handled in the PUSCH block below)
            pu_now = self.pending_ul.get(tti)
            if pu_now is not None:
                self._sc_acks_pusch = [e for e in sc_acks
                                       if e["rnti"] == pu_now[0]]
                sc_acks = [e for e in sc_acks if e["rnti"] != pu_now[0]]
            for sc in sc_acks:
                rnti_f3 = sc["rnti"]
                m3, b3 = _read_pucch(*enb_ul_decode_pucch(
                    self.cell, sf_idx, rx_grid_ack,
                    PucchConfig(n_pucch=_f3_resource(rnti_f3)), "3", 2,
                    rnti=rnti_f3, device=self.device))
                det = m3 > 0.2
                self.scell_sched.ack_info(
                    rnti_f3, sc["pid"], bool(det and b3[1] == 1))
                self.stats["ca_ack_f3_rx"] = self.stats.get(
                    "ca_ack_f3_rx", 0) + 1
                pc = pucch_by_rnti.pop(rnti_f3, [])
                for e in pc:
                    self.sched.ack_info(rnti_f3, e["pid"],
                                        bool(det and b3[0] == 1))
            das = tdd.das_set(self.tdd, tti % 10) if self.tdd is not None else ()
            chan_sel = self.tdd is not None and 1 < len(das) <= 4
            # every format-1 resource of the subframe, decoded before any
            # is judged: the UEs' ACKs and SRs share the band-edge PRB
            wanted: dict[int, set] = {r: {(_sr_resource(r), 0)} for r in sr_rntis}
            pos_by_rnti = {}
            for rnti, entries in pucch_by_rnti.items():
                if chan_sel:
                    # channel selection: every candidate resource (format
                    # 1b) is a hypothesis, position i on n_pucch + 2i
                    pos_by_rnti[rnti] = {das.index(tti - e["dl_tti"]): e for e in entries}
                    res = {(e["n_pucch"] + 2 * i, 2) for i, e in pos_by_rnti[rnti].items()}
                else:
                    res = {(entries[-1]["n_pucch"], 1)}
                wanted[rnti] = wanted.get(rnti, set()) | res
            pucch1 = _pucch1_decodes(self.cell, sf_idx, rx_grid_ack, wanted, self.device)
            for rnti, entries in pucch_by_rnti.items():
                if chan_sel:
                    # the strongest DMRS metric wins
                    best = (-1.0, None, None)  # (metric, res position, bits)
                    pos_of = pos_by_rnti[rnti]
                    for i, e in sorted(pos_of.items()):
                        bits, m = pucch1[rnti, e["n_pucch"] + 2 * i, 2]
                        if m > best[0]:
                            best = (m, i, bits)
                    if best[0] > 0.25 and best[1] is not None:
                        self._heard(rnti)
                        mask = tdd_channel_selection_decode(
                            best[1], int(best[2][0]), int(best[2][1]), len(das))
                    else:
                        mask = (False,) * len(das)  # DTX
                    for i, e in pos_of.items():
                        a = bool(mask[i])
                        self.sched.ack_info(rnti, e["pid"], a)
                        key = "dl_ack" if a else "dl_nack"
                        self.stats[key] = self.stats.get(key, 0) + 1
                    continue
                # FDD single ACK (format 1a), or the bundled TDD bit
                bits, metric = pucch1[rnti, entries[-1]["n_pucch"], 1]
                detected = metric > 0.25  # DTX threshold
                if detected:
                    self._heard(rnti)
                ack = detected and int(bits[0]) == 1
                for e in entries:
                    self.sched.ack_info(rnti, e["pid"], ack)
                key = "dl_ack" if ack else "dl_nack"
                self.stats[key] = self.stats.get(key, 0) + len(entries)
        self._pusch_acks = [e for e in acks if e["on_pusch"]]
        # periodic CQI/RI on PUCCH format 2 (the standing reporting loop,
        # cc_worker.cc:822): at a CQI occasion where a UE has NO PUSCH and
        # no colliding ACK (the UE drops CQI for the format-1a ACK then),
        # decode its dedicated format-2 resource
        if self.tdd is None and cqi_on_pusch(tti) and tti not in self.pending_ul:
            from ..phy.phch.pucch import PucchConfig as _P2

            ack_rntis = {e["rnti"] for e in acks}
            rx_grid_cqi = None
            for rnti_c, u in self.ues.items():
                if u.rrc_state < self.RRC_ACTIVE or rnti_c in ack_rntis:
                    continue
                if rx_grid_cqi is None:
                    rx_grid_cqi = enb_ul_fft(self.cell, samples[None], device=self.device)
                is_ri = cqi_report_is_ri(tti) and self.tm >= 3
                nbits = 1 if is_ri else (6 if self.tm == 4 else 4)
                metric, b = _read_pucch(*enb_ul_decode_pucch(
                    self.cell, sf_idx, rx_grid_cqi,
                    _P2(n_pucch=_cqi_resource(rnti_c)), "2", nbits,
                    device=self.device))
                if metric <= 0.25:
                    continue  # DTX
                if is_ri:
                    u.last_ri = 1 + int(b[0])
                    self.stats["ri_pucch_rx"] = self.stats.get("ri_pucch_rx", 0) + 1
                    if u.last_ri == 2:
                        self.sched.two_cw.add(rnti_c)
                    else:
                        self.sched.two_cw.discard(rnti_c)
                else:
                    cqi = int("".join(str(x) for x in b[:4]), 2)
                    self.sched.cqi_info(rnti_c, cqi)
                    u.last_cqi_tti = tti
                    if self.tm == 4 and len(b) >= 6:
                        u.last_pmi = int("".join(str(x) for x in b[4:6]), 2)
                    self.stats["cqi_pucch_rx"] = self.stats.get("cqi_pucch_rx", 0) + 1
        # PRACH occasion (FDD: sf 1; TDD: sf 2, UL in every config); a
        # PUSCH scheduled in the same subframe is decoded too (signals add)
        if sf_idx == self.prach_sf:
            cp = prach_cp_len(self.cell)
            win = samples[cp : cp + prach_nfft(self.cell)]
            if len(win) == prach_nfft(self.cell) and torch.mean(win.abs() ** 2).item() > 1e-6:
                _metric, delay, det = prach_detect(self.cell, self.prach_cfg, win,
                                                   device=self.device)
                # one read for the detections and their delays
                det, delay = torch.stack([det.to(torch.float32),
                                          delay.to(torch.float32)]).cpu().numpy()
                # dedup only against RA still in progress: an ESTABLISHED
                # UE arriving again with the same preamble is legitimate
                # (re-establishment after RLF)
                known = {u.rapid for u in self.ues.values()
                         if u.rrc_state < self.RRC_CONNECTED}
                for rapid in np.nonzero(det)[0]:
                    rapid = int(rapid)
                    if rapid in known or any(r[0] == rapid for r in self.pending_rars):
                        continue
                    ta = max(0, int(round(float(delay[rapid]))))
                    pre = next((u for u in self.ues.values()
                                if u.cf_preamble == rapid and u.rapid < 0), None)
                    if pre is not None:  # contention-free RA (HO target)
                        pre.rapid = rapid
                        self.pending_rars.append((rapid, ta, pre.crnti))
                    else:
                        ue = self._new_ue(rapid)
                        self.pending_rars.append((rapid, ta, ue.crnti))
                    self.stats["prach_detected"] += 1
        # SRS measurement on the cell-specific sounding subframe
        srs_sf = _is_srs_sf(self.srs_enabled, self.tdd, tti)
        if srs_sf and self.ues:
            from ..phy.chest.srs import srs_estimate

            rx_grid_srs = enb_ul_fft(self.cell, samples[None], device=self.device)
            ce_s, snr_lin = srs_estimate(rx_grid_srs, self.cell, 0, self.cell.nof_prb,
                                         device=self.device)
            pwr, snr_mean = torch.stack([torch.mean(ce_s.abs() ** 2),
                                         torch.mean(snr_lin)]).cpu().tolist()
            if pwr > 1e-6:  # a UE actually sounded
                snr = 10 * np.log10(snr_mean + 1e-12)
                for u in self.ues.values():
                    if u.rrc_state >= self.RRC_ACTIVE:
                        u.srs_snr_db = snr
                self.stats["srs_meas"] = self.stats.get("srs_meas", 0) + 1
        for rnti_sr in sr_rntis:
            if pucch1[rnti_sr, _sr_resource(rnti_sr), 0][1] > 0.25:
                self._heard(rnti_sr)
                self.sched.ul_bsr(rnti_sr, 128)  # grant enough for a BSR
                self.stats["sr_detected"] = self.stats.get("sr_detected", 0) + 1
        # scheduled PUSCH
        if tti in self.pending_ul:
            rnti, grant = self.pending_ul.pop(tti)
            ue = self.ues.get(rnti)
            if ue is None:
                return
            ue_ctx = self.ues.get(rnti)
            exp_acks = [e for e in getattr(self, "_pusch_acks", []) if e["rnti"] == rnti]
            sc_exp = [e for e in getattr(self, "_sc_acks_pusch", [])
                      if e["rnti"] == rnti]
            apcqi = tti in self._apcqi
            self._apcqi.discard(tti)
            want_cqi = apcqi or (cqi_on_pusch(tti) and ue_ctx is not None
                                 and ue_ctx.rrc_state >= self.RRC_ACTIVE)
            # around RRC state transitions the two ends can disagree for a
            # round-trip on whether periodic CQI has started; a wrong UCI
            # layout corrupts the data decode, so on CRC failure retry the
            # flipped-CQI hypothesis (blind UCI-presence detection)
            cqi_hyps = [want_cqi]
            if (cqi_on_pusch(tti) or apcqi) and ue_ctx is not None:
                cqi_hyps.append(not want_cqi)
            # windowed TPU data plane: UCI-free data TTIs queue into the
            # W-TTI PUSCH window (the host chain keeps UCI multiplexing,
            # SRS-shortened subframes and the DTX hypothesis — same split
            # as the dynamic pipeline).  A whole-subframe energy gate
            # stands in for the per-allocation one: the scheduler grants
            # at most one PUSCH per TTI here.
            if (self._win_ul is not None and not srs_sf and not exp_acks
                    and not sc_exp and not want_cqi and len(cqi_hyps) == 1
                    and torch.mean(samples.abs() ** 2).item() >= 1e-7):
                harq_state = self._ul_harq.pop(tti, None)
                sb_w, txc = None, 1
                if harq_state is not None:
                    sb0, txc0 = harq_state
                    txc = txc0 + 1
                    if isinstance(sb0, tuple) and len(sb0) == 2 and sb0[0] == "win":
                        sb_w = sb0[1]
                self._win_ul.submit(samples, sf_idx, grant, rnti, tti,
                                    softbuffer=sb_w, tx_count=txc)
                return
            rx_grid = enb_ul_fft(self.cell, samples[None], device=self.device)
            from ..phy.phch.pusch import UciCfg

            harq_state = self._ul_harq.pop(tti, None)  # (softbuffers, tx_count)
            sb_in = harq_state[0] if harq_state else None
            tx_count = (harq_state[1] if harq_state else 0) + 1
            # DTX detection: without an energy gate a silent allocation
            # demodulates to all-zero LLRs, and the all-zeros codeword is a
            # VALID turbo/CRC codeword — it would "pass".  (The reference
            # gates on chest_ul's DMRS SNR.)
            k0 = grant.prb_start * 12
            alloc_pow = torch.mean(
                rx_grid[0, :, k0 : k0 + 12 * grant.nof_prb].abs() ** 2).item()
            dtx = alloc_pow < 1e-7
            out = uci_out = None
            if dtx:
                out = (None, False, sb_in)
            # dynamic TPU path for UCI-free data TTIs (the production data
            # plane; UCI multiplexing stays on the host chain)
            dyn_sb = (sb_in[1] if isinstance(sb_in, tuple)
                      and len(sb_in) == 2 and sb_in[0] == "dyn" else None)
            if (not dtx and self._dyn_ul is not None and not srs_sf
                    and not exp_acks and not sc_exp and not want_cqi
                    and len(cqi_hyps) == 1
                    and (sb_in is None or dyn_sb is not None)):
                tb_d, ok_d, soft_d, _ = self._dyn_ul.decode(
                    samples[None], sf_idx, grant, softbuffer=dyn_sb)
                out = (tb_d, ok_d, ("dyn", soft_d))
            if (isinstance(sb_in, tuple) and len(sb_in) == 2
                    and sb_in[0] in ("dyn", "win")):
                sb_in = None  # device-layout softbuffer: host path restarts
            # the UE shortens its PUSCH on the SRS subframe once it is
            # RRC_ACTIVE: from the RRCConnectionReconfiguration on, whose
            # Complete makes this end RRC_ACTIVE.  Until then either format
            # may come, and a PUSCH there that fails its CRC shortened is
            # decoded again at full length from the same softbuffer (the
            # other format's LLRs sit at other positions).  When both fail,
            # the full length's softbuffer is kept: the format this end's
            # state says the UE used.
            window = srs_sf and ue_ctx.rrc_state < self.RRC_ACTIVE
            shorts = (True, False) if window else (srs_sf,)
            for short in (shorts if not dtx and out is None else ()):
                for wc in cqi_hyps:
                    uci_exp = None
                    if wc or exp_acks or sc_exp:
                        ri_exp = (0,) if (wc and self.tm >= 3) else ()
                        if wc and self.subband_cqi:
                            from ..phy.phch.uci import cqi_hl_nof_subbands

                            n_cqi = 4 + 2 * cqi_hl_nof_subbands(
                                self.cell.nof_prb)
                        else:
                            n_cqi = (6 if self.tm == 4 else 4) if wc else 0
                        uci_exp = UciCfg(
                            cqi_bits=(0,) * n_cqi,
                            ack=(0,) * (len(exp_acks) + len(sc_exp)),
                            ri=ri_exp)
                    out = enb_ul_decode_pusch(self.cell, sf_idx, rx_grid, grant,
                                              softbuffers=sb_in, uci=uci_exp,
                                              shortened=short, device=self.device)
                    uci_out = out[4] if uci_exp is not None else None
                    if out[1]:
                        break
                if out[1]:
                    break
            tb, ok = out[0], out[1]
            if not dtx and ue_ctx is not None:
                if len(out) > 3:
                    ue_ctx.last_ul_snr_db = float(out[3])
                # per-RE rx power over the allocation feeds the TPC loop
                ue_ctx.last_ul_rx_db = 10.0 * np.log10(max(alloc_pow, 1e-12))
            if ok and ue_ctx is not None and ue_ctx.rrc_state >= self.RRC_CONNECTED:
                # timing-advance maintenance: UL delay from the DMRS phase
                # ramp across subcarriers → TA MAC CE (mac.cc ta_info →
                # TS 36.321 §6.1.3.5); 31 = hold
                from ..phy.chest.chest_ul import chest_ul

                ce_ta, _ = chest_ul(rx_grid, self.cell, grant.prb_start, grant.nof_prb)
                c = ce_ta[0]  # (nsymb, m_sc)
                ramp = torch.mean(c[:, 1:] * torch.conj(c[:, :-1])).item()
                delay = -np.angle(ramp) * self.cell.symbol_sz / (2 * np.pi)
                if abs(delay) >= 2.0:
                    cmd = int(np.clip(31 + round(delay), 0, 63))
                    self.sched.push_ce(rnti, 29, bytes([cmd]))
                    self.stats["ta_cmd_tx"] = self.stats.get("ta_cmd_tx", 0) + 1
            # UL HARQ: HI on PHICH at §9.1.2 timing; a NACK schedules the
            # non-adaptive retransmission (same PRBs, next rv) and keeps
            # the softbuffer chain for combining (softbuffer.c role at
            # the eNB; reference mac.cc crc_info → sched UL retx)
            ph_tti = self._phich_tti(tti)
            group, n_seq = _phich_resource(self.cell, grant)
            hi = 1
            if not ok and tx_count < UL_HARQ_MAX_TX:
                retx_tti = tdd.pusch_tti(self.tdd, ph_tti)
                if retx_tti not in self.pending_ul:
                    hi = 0
                    from ..stack.mac import HARQ_RV_SEQ

                    g2 = dataclasses.replace(grant, rv=HARQ_RV_SEQ[tx_count % 4])
                    self.pending_ul[retx_tti] = (rnti, g2)
                    self._ul_harq[retx_tti] = (out[2], tx_count)
            self.pending_phich.setdefault(ph_tti, []).append((group, n_seq, hi))
            if uci_out is not None and uci_out["cqi_bits"]:
                cbits = uci_out["cqi_bits"]
                cqi = int("".join(str(b) for b in cbits[:4]), 2)
                if self.subband_cqi:
                    from ..phy.phch.uci import (cqi_hl_nof_subbands,
                                                cqi_hl_subband_unpack)

                    n_sb = cqi_hl_nof_subbands(self.cell.nof_prb)
                    if len(cbits) >= 4 + 2 * n_sb:
                        wb, offs = cqi_hl_subband_unpack(
                            np.asarray(cbits), n_sb)
                        self.sched.cqi_subband_info(rnti, wb, offs)
                        self.stats["sb_cqi_rx"] = self.stats.get(
                            "sb_cqi_rx", 0) + 1
                elif (self.tm == 4 and len(cbits) >= 6
                        and ue_ctx is not None):
                    ue_ctx.last_pmi = int(
                        "".join(str(b) for b in cbits[4:6]), 2)
                self.sched.cqi_info(rnti, cqi)
                if ue_ctx is not None:
                    ue_ctx.last_cqi_tti = tti
                self.stats["cqi_rx"] = self.stats.get("cqi_rx", 0) + 1
                if uci_out["ri"] and ue_ctx is not None:
                    # RI feedback drives the 2-codeword eligibility
                    # (sched_ue ri_info → scheduler rank adaptation)
                    ue_ctx.last_ri = 1 + int(uci_out["ri"][0])
                    self.stats["ri_rx"] = self.stats.get("ri_rx", 0) + 1
                    if self.tm >= 3 and ue_ctx.last_ri == 2:
                        self.sched.two_cw.add(rnti)
                    else:
                        self.sched.two_cw.discard(rnti)
            if exp_acks or sc_exp:
                # trust UCI ack bits only when the PUSCH CRC confirms the
                # two sides agreed on the UCI layout; else NACK → retx
                # (CA: SCell bits follow the PCell's in the codebook)
                ack_bits = list(uci_out["ack"]) if (ok and uci_out) else []
                for i, e in enumerate(exp_acks):
                    a = bool(ack_bits[i]) if i < len(ack_bits) else False
                    self.sched.ack_info(rnti, e["pid"], a)
                    key = "dl_ack" if a else "dl_nack"
                    self.stats[key] = self.stats.get(key, 0) + 1
                for j, e in enumerate(sc_exp):
                    i = len(exp_acks) + j
                    a = bool(ack_bits[i]) if i < len(ack_bits) else False
                    self.scell_sched.ack_info(rnti, e["pid"], a)
                    self.stats["ca_ack_pusch_rx"] = self.stats.get(
                        "ca_ack_pusch_rx", 0) + 1
            if not ok:
                self.stats["ul_crc_ko"] += 1
                return
            self.stats["ul_crc_ok"] += 1
            ue.last_ul_ok_tti = self.tti
            self._deliver_ul_pdu(ue, rnti, np.packbits(tb).tobytes())

    def _deliver_ul_pdu(self, ue: "_EnbUe", rnti: int, pdu: bytes):
        """Route one CRC-passing UL MAC PDU into MAC CEs / RLC bearers
        (the mac.cc pdu-processing tail, shared by the host, dynamic and
        windowed decode paths)."""
        bsr, sdus = parse_ul_pdu(pdu)
        if bsr:
            self.sched.ul_bsr(rnti, bsr)
            if (self.ul_ca and self.scell_sched is not None
                    and ue.scell_state == 2):
                # UL CA: split the buffer across both carriers
                self.scell_sched.ul_bsr(rnti, bsr // 2)
        for lcid, sdu in sdus:
            if lcid == LCID_PHR and sdu:
                # power headroom (ue.cc:357-359 → sched_ue::ul_phr)
                ue.last_phr_db = phr_db(sdu[0])
                self.sched.ul_phr(rnti, ue.last_phr_db)
                self.stats["phr_rx"] = self.stats.get("phr_rx", 0) + 1
            elif lcid == LCID_CCCH:
                self._handle_ccch(ue, sdu)
            elif lcid == LCID_SRB1:
                ue.srb1_rlc.write_pdu(sdu)
                while (r := ue.srb1_rlc.read_sdu()) is not None:
                    self._handle_srb1(ue, r)
            elif lcid == LCID_DRB1:
                ue.drb_rlc.write_pdu(sdu)
                while (r := ue.drb_rlc.read_sdu()) is not None:
                    ip_pkt = ue.drb_pdcp.write_pdu(r)
                    if ip_pkt is not None:
                        self.spgw.rx_from_enb(self.gtpu.tx(ue.dl_teid, ip_pkt))

    def _complete_ul_data(self, ev: dict):
        """Deferred completion of a windowed PUSCH decode: PHICH + UL
        HARQ retransmission chain at the stretched timing, then the same
        PDU delivery as the inline path."""
        tti, rnti, grant = ev["tti"], ev["rnti"], ev["grant"]
        ok, tb = ev["ok"], ev["tb"]
        ue = self.ues.get(rnti)
        ph_tti = self._phich_tti(tti)
        group, n_seq = _phich_resource(self.cell, grant)
        hi = 1
        if not ok and ev["tx_count"] < UL_HARQ_MAX_TX:
            retx_tti = (ph_tti + self.ul_grant_delay if self.ul_grant_delay
                        else tdd.pusch_tti(self.tdd, ph_tti))
            if retx_tti not in self.pending_ul:
                hi = 0
                from ..stack.mac import HARQ_RV_SEQ

                g2 = dataclasses.replace(grant, rv=HARQ_RV_SEQ[ev["tx_count"] % 4])
                self.pending_ul[retx_tti] = (rnti, g2)
                self._ul_harq[retx_tti] = (("win", ev["soft"]), ev["tx_count"])
        self.pending_phich.setdefault(ph_tti, []).append((group, n_seq, hi))
        if not ok:
            self.stats["ul_crc_ko"] += 1
            return
        self.stats["ul_crc_ok"] += 1
        if ue is None:
            return
        ue.last_ul_ok_tti = self.tti
        self._deliver_ul_pdu(ue, rnti, np.packbits(tb).tobytes())

    def _pump_spgw(self):
        teid_map = {u.dl_teid: u for u in self.ues.values()}
        requeue = []
        while (pkt := self.spgw.pop_tx()) is not None:
            out = gtpu_unpack(pkt)
            if out is None:
                continue
            hdr, payload = out
            ue = teid_map.get(hdr.teid)
            if ue is not None and ue.rrc_state == self.RRC_ACTIVE:
                ue.drb_rlc.write_sdu(ue.drb_pdcp.write_sdu(payload))
            else:
                # another eNB's bearer (S1 HO) — or OUR UE whose DRB is not
                # re-established yet (service-request resume: the SPGW
                # flushes at Modify Bearer time, before the reconfiguration
                # completes; ciphering with the pre-SMC entity would
                # corrupt it) — hold the packet
                requeue.append(pkt)
        self.spgw.tx_queue.extendleft(reversed(requeue))

    def _build_dl(self, tti: int, sf_idx: int) -> torch.Tensor:
        """Schedule + render one DL subframe (sf_worker.cc:216-252)."""
        sched = self._sched_dl(tti, sf_idx)
        if sched is None:  # TDD UL subframe: eNB silent
            _, samples = enb_dl_subframe(self.cell, sf_idx, DlSched(),
                                         tdd=self.tdd, device=self.device)
            return samples[0]
        _, samples = enb_dl_subframe(self.cell, sf_idx, sched, mib=self.mib,
                                     sfn=(tti // 10) % 1024, tdd=self.tdd,
                                     device=self.device)
        if self.tm >= 3:
            # spatial multiplexing needs a rank-2 link: emit BOTH port
            # streams; the channel (test harness or emulator) mixes them
            # into the UE's rx antennas
            return samples
        if samples.shape[0] >= 2:
            # the harness link carries ONE stream per cell: emit the
            # superposition at the UE antenna (flat [1,1] MISO channel —
            # per-port CRS keeps the SFBC combinable for any h)
            return samples.sum(dim=0)
        return samples[0]

    def _sched_dl(self, tti: int, sf_idx: int) -> "DlSched | None":
        """The scheduling half of the subframe build: MAC/RRC decisions →
        a filled `DlSched` (mac.cc get_dl_sched + the control-channel
        demand).  Returns None on TDD UL subframes.  Split from the
        render so the windowed control plane can pre-schedule a whole
        window and render it in ONE device dispatch."""
        cfi = self.cfi
        if self.cfi_adapt:
            # CFI adaptation (scheduler_grid.cc:154-165): dry-run the CCE
            # allocation for this TTI's expected DCI demand and take the
            # smallest control region that hosts it
            from ..stack.sched_grid import min_cfi_for

            demands = [r for r, u in self.ues.items()
                       if u.rrc_state != self.RRC_IDLE][:4]
            if self.pending_rars:
                demands.append(1 + self.prach_sf)
            if sf_idx == 5 or (tti % 80) in (16, 17):
                demands.append(0xFFFF)
            cfi = min_cfi_for(self.cell, sf_idx, demands, cfi_min=self.cfi)
        sched = DlSched(cfi=cfi, phich=self.pending_phich.pop(tti, []))
        sftype = tdd.sf_type(self.tdd, sf_idx)
        if sftype == tdd.SfType.U:  # eNB silent on UL subframes
            return None
        # special subframes with a short DwPTS carry no PDSCH (the UE side
        # of the reference skips them too, phy_common.cc:630)
        can_pdsch = sftype == tdd.SfType.D or tdd.nof_dw(self.tdd) >= 9
        is_tdd = self.tdd is not None
        dwpts = sftype == tdd.SfType.S
        from ..stack.sched_grid import PdcchGrid

        grid_cce = PdcchGrid(self.cell, sf_idx, cfi)

        def alloc_cce(rnti: int) -> tuple[int, int] | None:
            """First collision-free (agg, cce) from the RNTI's search
            space (UE-specific or common) — the scheduler_grid.cc PDCCH
            allocation, now through the shared `stack.sched_grid` grid."""
            return grid_cce.alloc(rnti, agg_levels=(8, 4, 2, 1))

        def add_dl_tb(rnti: int, mcs: int, tb_bytes_pdu: bytes, ndi: int = 1, rv: int = 0, harq_pid: int = 0,
                      rb_start: int = 0, l_crb: int | None = None):
            from ..phy.modem import Mod
            from ..phy.phch.ra import tbs_lookup

            l_crb = self.cell.nof_prb if l_crb is None else l_crb
            is_common = rnti >= 0xFFF4 or rnti <= 0x0042  # SI/P/RA-RNTI
            if is_common:
                # TS 36.213 §7.1.7.2 common grants: QPSK, i_tbs = mcs,
                # N_PRB from the TPC LSB (we set tpc=1 → N_PRB = 3)
                tbs_bits = tbs_lookup(mcs, 3)
            else:
                tbs_bits = dl_tbs(mcs, l_crb, dwpts=dwpts)
            tb_bits = np.unpackbits(np.frombuffer(tb_bytes_pdu, np.uint8))
            if len(tb_bits) > tbs_bits:
                return  # does not fit the common-grant TBS
            tb_bits = np.concatenate([tb_bits, np.zeros(tbs_bits - len(tb_bits), np.uint8)])
            # synchronous-HARQ pid spaces exceed the 3-bit DCI field; the
            # field carries pid % 8 and the UE re-derives the full pid
            # from the TTI (windowed_stack contract; identity when < 8)
            dci = Dci1A(
                riv=riv_encode(self.cell.nof_prb, rb_start, l_crb), mcs=mcs, ndi=ndi, rv=rv,
                harq_pid=harq_pid % 8, tpc=1 if is_common else 0,
            )
            loc = alloc_cce(rnti)
            if loc is None:
                return
            agg, cce = loc
            grant = DlGrant(
                prb=tuple(range(rb_start, rb_start + l_crb)),
                mod=Mod.QPSK if is_common else dl_mcs_to_mod(mcs),
                tbs=tbs_bits, rnti=rnti, rv=rv,
                tx_scheme="diversity" if max(self.cell.nof_ports, 1) >= 2 else "port0",
            )
            sched.dcis.append((dci.pack(self.cell.nof_prb, tdd=is_tdd), rnti, agg, cce))
            sched.grants.append((grant, tb_bits))
            return agg, cce

        def add_dl_tb2(g) -> tuple[int, int] | None:
            """Two-codeword grant (TM3: DCI 2A + CDD; TM4: DCI 2 +
            codebook) — the reference's pdsch.c:785-1007 2-CW path."""
            from ..phy.phch.dci import Dci1, Dci2
            from ..phy.phch.pdsch import DlGrant2

            prb = tuple(range(g.rb_start, g.rb_start + g.l_crb))
            fmt = "2a" if self.tm == 3 else "2"
            ue_g = self.ues.get(g.rnti)
            pmi = getattr(ue_g, "last_pmi", 0) if ue_g is not None else 0
            dci = Dci2(
                rbg_bitmap=Dci1.bitmap_for_prbs(prb, self.cell.nof_prb),
                mcs1=g.mcs, ndi1=g.ndi, rv1=g.rv,
                mcs2=g.mcs2, ndi2=g.ndi, rv2=g.rv,
                harq_pid=g.harq_pid, fmt=fmt,
                precoding_info=(0 if fmt == "2a" else max(0, pmi - 1)),
            )
            loc = alloc_cce(g.rnti)
            if loc is None:
                return None
            agg, cce = loc
            pad = lambda pdu, tbs: np.concatenate([
                np.unpackbits(np.frombuffer(pdu, np.uint8)),
                np.zeros(tbs - 8 * len(pdu), np.uint8)])
            grant = DlGrant2(
                prb=prb, mod1=dl_mcs_to_mod(g.mcs), tbs1=g.tbs_bits,
                mod2=dl_mcs_to_mod(g.mcs2), tbs2=g.tbs_bits2,
                rv1=g.rv, rv2=g.rv, rnti=g.rnti,
                pmi=(0 if fmt == "2a" else max(1, pmi)),
                tx_scheme=("cdd" if fmt == "2a" else "spatialmux"),
            )
            sched.dcis.append((dci.pack(self.cell.nof_prb, nof_ports=2, tdd=is_tdd),
                               g.rnti, agg, cce))
            sched.grants.append((grant, (pad(g.pdu, g.tbs_bits), pad(g.pdu2, g.tbs_bits2))))
            self.stats["dl_2cw_tx"] = self.stats.get("dl_2cw_tx", 0) + 1
            return agg, cce

        ul_delay = self.ul_grant_delay or _pusch_delay(self.tdd, tti)
        # 0. system information (exclusive TTIs — common grants span the
        # band's PDSCH REs): SIB1 every 20 ms, SIB2 every 80 ms
        sfn = tti // 10
        si_pdu = None
        if sf_idx == 5 and sfn % 2 == 0:
            si_pdu = self._sib1
        elif sf_idx == 6 and sfn % 8 == 0:
            si_pdu = self._sib2
        if si_pdu is not None and can_pdsch:
            from ..phy.common import SIRNTI
            from ..phy.phch.ra import tbs_lookup as _tbsl

            mcs = 0
            while _tbsl(mcs, 3) // 8 < len(si_pdu):
                mcs += 1
            add_dl_tb(SIRNTI, mcs, si_pdu)
        # 0b. PCCH Paging on P-RNTI at the paging occasion (sf 9)
        elif self.pending_pcch and sf_idx == 9 and can_pdsch:
            from ..phy.common import PRNTI
            from ..phy.phch.ra import tbs_lookup as _tbsl

            pcch = self.pending_pcch.popleft()
            mcs = 0
            while _tbsl(mcs, 3) // 8 < len(pcch):
                mcs += 1
            add_dl_tb(PRNTI, mcs, pcch)
        # 1. one pending RAR per TTI (RA-RNTI = 1 + prach sf_idx); the RAR
        # subframe must also be a Msg3 grant opportunity (TDD Table 8-2)
        elif (self.pending_rars and sf_idx not in (0, 5) and can_pdsch
                and ul_delay is not None):
            rapid, ta, crnti = self.pending_rars.popleft()
            # PUSCH rides PRBs 1..N-2: the band-edge PRBs are the PUCCH
            # region (TS 36.211 §5.4.3 band-edge mapping)
            grant20 = (riv_encode(self.cell.nof_prb, 1, self.cell.nof_prb - 2) << 10) | (2 << 5)
            rar = _pack_rar(rapid, ta, grant20, crnti)
            from ..phy.phch.ra import tbs_lookup as _tbsl

            mcs = 0
            while _tbsl(mcs, 3) // 8 < len(rar):
                mcs += 1
            add_dl_tb(1 + self.prach_sf, mcs, rar)
            # reserve the Msg3 PUSCH occasion; a retransmission it displaces
            # leaves no softbuffer behind for Msg3 (ROADMAP Queue 3)
            self.pending_ul[tti + ul_delay] = (crnti, _msg3_grant(self.cell, crnti, grant20))
            self._ul_harq.pop(tti + ul_delay, None)
        else:
            # 2. normal DL scheduling (one grant/TTI, MAC PDUs from RLC
            # bearers); TDD: D subframes only — DwPTS TBS shrink would
            # truncate scheduler-sized PDUs
            if sftype == tdd.SfType.D and not (
                    self._in_meas_gap(tti)
                    or self._in_meas_gap(self._ack_tti(tti))):
                # connected UEs with a measGapConfig are away from this
                # carrier during gap subframes (and cannot PUCCH-ack a
                # PDSCH whose ACK occasion lands in one) — the reference
                # scheduler skips them the same way (scheduler_ue.cc)
                from ..phy.phch.pdsch import pdsch_nof_re

                n_re = pdsch_nof_re(self.cell, sf_idx, cfi,
                                    tuple(range(self.cell.nof_prb)), is_tdd)
                grants = self.sched.get_dl_sched(tti, pdsch_nof_re=n_re)
                for g in grants:
                    if g.pdu2 is not None and self.tm >= 3:
                        loc2 = add_dl_tb2(g)
                    else:
                        loc2 = add_dl_tb(g.rnti, g.mcs, g.pdu, ndi=g.ndi, rv=g.rv, harq_pid=g.harq_pid,
                                         rb_start=g.rb_start, l_crb=g.l_crb)
                    if loc2 is not None:
                        # real feedback: PUCCH 1a (or UCI-on-PUSCH) at the
                        # TS 36.213 §10.1 ACK subframe; NACK/DTX → retx
                        self.pending_dl_ack.setdefault(self._ack_tti(tti), []).append(
                            {"rnti": g.rnti, "pid": g.harq_pid, "n_pucch": loc2[1],
                             "on_pusch": False, "dl_tti": tti})
                    else:
                        # TB never went on air (no CCE / no fit) → retx it
                        self.sched.ack_info(g.rnti, g.harq_pid, False)
            # 3. UL grants via DCI0: BSR-driven, plus a periodic round-robin
            # grant to connected UEs (the SR/semi-persistent stand-in —
            # the reference's UE would send a PUCCH SR instead); only on
            # grant-opportunity subframes (Table 8-2)
            if ul_delay is not None and not (
                    self._in_meas_gap(tti)
                    or self._in_meas_gap(tti + ul_delay)):
                ul_grants = self.sched.get_ul_sched(tti)
                active = sorted(self.ues)
                pace_ok = (tti % 3 == 2) if self.tdd is None else True
                if self.sr_enabled:
                    pace_ok = False  # BSR/SR-driven grants only — no blind RR
                if (not ul_grants and active and pace_ok
                        and (tti + ul_delay) not in self.pending_ul):
                    from ..stack.mac import UlSchedGrant

                    rnti = active[(tti // 3) % len(active)]
                    mcs = 5
                    l_ul = self.cell.nof_prb - 2  # keep the PUCCH region free
                    tbs = tbs_lookup(ul_mcs_to_itbs(mcs), l_ul)
                    ul_grants = [UlSchedGrant(rnti, 1, l_ul, mcs, tbs, 0, 0, 0)]
                for ug in ul_grants:
                    if (tti + ul_delay) in self.pending_ul:
                        break  # one PUSCH per TTI
                    # aperiodic CQI request (dci.c cqi_request / TS 36.213
                    # §7.2.1): ask when the last report has gone stale
                    ue_g = self.ues.get(ug.rnti)
                    apcqi = (ue_g is not None and ue_g.rrc_state >= self.RRC_ACTIVE
                             and tti - getattr(ue_g, "last_cqi_tti", -10**6) > self.apcqi_interval)
                    if apcqi:
                        self._apcqi.add(tti + ul_delay)
                        ue_g.last_cqi_tti = tti  # don't re-request while in flight
                        self.stats["apcqi_req"] = self.stats.get("apcqi_req", 0) + 1
                    dci0 = Dci0(riv=riv_encode(self.cell.nof_prb, ug.rb_start, ug.l_crb),
                                mcs=ug.mcs, ndi=ug.ndi, tpc=self._tpc_cmd(ug.rnti),
                                cqi_request=apcqi)
                    loc = alloc_cce(ug.rnti)
                    if loc is None:
                        continue
                    agg, cce = loc
                    sched.dcis.append(
                        (dci0.pack(self.cell.nof_prb, Dci1A.nof_bits(self.cell.nof_prb, tdd=is_tdd),
                                   tdd=is_tdd), ug.rnti, agg, cce)
                    )
                    self.pending_ul[tti + ul_delay] = (
                        ug.rnti,
                        UlGrant(
                            prb_start=ug.rb_start, nof_prb=ug.l_crb, mod=ul_mcs_to_mod(ug.mcs),
                            tbs=ug.tbs_bits, rnti=ug.rnti,
                        ),
                    )
        # UEs with a PUSCH at their ACK subframe multiplex the ACK as
        # UCI-on-PUSCH instead of PUCCH (ue_ul.c uci multiplexing) —
        # unless simultaneousPUCCH-PUSCH is on (windowed control plane)
        if not self.simul_pucch_pusch:
            for ack_at, entries in self.pending_dl_ack.items():
                pu = self.pending_ul.get(ack_at)
                if pu is not None:
                    for e in entries:
                        if e["rnti"] == pu[0]:
                            e["on_pusch"] = True
        return sched

    UL_P0_DBFS = 0.0  # target per-RE PUSCH rx power (the P0 of §5.1.1.1)

    def _tpc_cmd(self, rnti: int) -> int:
        """TPC for a DCI0 (accumulated mode, Table 5.1.1.1-2 index):
        steer the measured per-RE PUSCH rx power toward P0 — the
        ul_pwr_ctrl loop the reference runs in sched_ue/ue_ul.c.  A
        power target (not an SNR target) has a fixed point even on a
        noiseless digital channel, so the loop converges instead of
        railing the UE's gain accumulator at its clamp."""
        ue = self.ues.get(rnti)
        rx = ue.last_ul_rx_db if ue is not None else None
        if rx is None:
            return 1  # 0 dB
        if rx < self.UL_P0_DBFS - 6:
            return 3  # +3 dB
        if rx < self.UL_P0_DBFS - 1:
            return 2  # +1 dB
        if rx > self.UL_P0_DBFS + 1:
            return 0  # -1 dB
        return 1

    def _build_scell_dl(self, tti: int, sf_idx: int) -> torch.Tensor:
        """One SCell DL subframe (the extra cc_worker of the reference's
        CA path): own CRS/sync/PDCCH, data pulled by the SCell scheduler
        from the same RLC bearers, DCI searched by the UE with its PCell
        C-RNTI (no cross-carrier scheduling, as in the reference)."""
        from ..phy.phch.pdsch import pdsch_nof_re

        sched = DlSched(cfi=self.cfi)
        n = nof_cce(self.scell, sf_idx, self.cfi)
        used_cce: list[tuple[int, int]] = []
        n_re = pdsch_nof_re(self.scell, sf_idx, self.cfi, tuple(range(self.scell.nof_prb)))
        for g in self.scell_sched.get_dl_sched(tti, pdsch_nof_re=n_re):
            ue = self.ues.get(g.rnti)
            if ue is None or ue.scell_state != 2:
                continue
            tbs_bits = dl_tbs(g.mcs, g.l_crb)
            tb_bits = np.unpackbits(np.frombuffer(g.pdu, np.uint8))
            if len(tb_bits) > tbs_bits:
                continue
            tb_bits = np.concatenate([tb_bits, np.zeros(tbs_bits - len(tb_bits), np.uint8)])
            loc = None
            for agg, cands in sorted(search_space_candidates(g.rnti, sf_idx, n).items(), reverse=True):
                for cce in cands:
                    if all(cce + agg <= s or cce >= s + l for s, l in used_cce):
                        used_cce.append((cce, agg))
                        loc = (agg, cce)
                        break
                if loc:
                    break
            if loc is None:
                continue
            dci = Dci1A(riv=riv_encode(self.scell.nof_prb, g.rb_start, g.l_crb),
                        mcs=g.mcs, ndi=g.ndi, rv=g.rv, harq_pid=g.harq_pid)
            grant = DlGrant(prb=tuple(range(g.rb_start, g.rb_start + g.l_crb)),
                            mod=dl_mcs_to_mod(g.mcs), tbs=tbs_bits, rnti=g.rnti, rv=g.rv,
                            tx_scheme="diversity" if max(self.scell.nof_ports, 1) >= 2 else "port0")
            sched.dcis.append((dci.pack(self.scell.nof_prb), g.rnti, loc[0], loc[1]))
            sched.grants.append((grant, tb_bits))
            if self.tdd is None:
                # real CA HARQ feedback: the SCell bit arrives on the
                # UE's format-3 resource at the ACK occasion
                self.pending_dl_ack_scell.setdefault(
                    self._ack_tti(tti), []).append(
                        {"rnti": g.rnti, "pid": g.harq_pid})
            else:
                self.scell_sched.ack_info(g.rnti, g.harq_pid, True)
        # UL CA: BSR-driven DCI0 grants on the SCell PDCCH (2nd UL carrier)
        if self.ul_ca and (tti + 4) not in self.pending_ul_scell:
            for ug in self.scell_sched.get_ul_sched(tti):
                ue = self.ues.get(ug.rnti)
                if ue is None or ue.scell_state != 2:
                    continue
                loc = None
                for agg, cands in sorted(search_space_candidates(ug.rnti, sf_idx, n).items(), reverse=True):
                    for cce in cands:
                        if all(cce + agg <= st or cce >= st + l for st, l in used_cce):
                            used_cce.append((cce, agg))
                            loc = (agg, cce)
                            break
                    if loc:
                        break
                if loc is None:
                    continue
                dci0 = Dci0(riv=riv_encode(self.scell.nof_prb, ug.rb_start, ug.l_crb),
                            mcs=ug.mcs, ndi=ug.ndi)
                sched.dcis.append((dci0.pack(self.scell.nof_prb,
                                             Dci1A.nof_bits(self.scell.nof_prb)),
                                   ug.rnti, loc[0], loc[1]))
                self.pending_ul_scell[tti + 4] = (ug.rnti, UlGrant(
                    prb_start=ug.rb_start, nof_prb=ug.l_crb,
                    mod=ul_mcs_to_mod(ug.mcs), tbs=ug.tbs_bits, rnti=ug.rnti))
                break  # one SCell PUSCH per TTI
        _, samples = enb_dl_subframe(self.scell, sf_idx, sched, mib=Mib(nof_prb=self.scell.nof_prb),
                                     sfn=(tti // 10) % 1024, device=self.device)
        return samples[0]

    def _process_scell_ul(self, tti: int, sf_idx: int, samples: torch.Tensor):
        """Decode the SCell PUSCH (data-plane only: UCI/control stay on
        the PCell, as in the reference's CA — PUCCH exists only there)."""
        # the link delivers the UE's subframe one TTI later (same shift
        # as _process_ul)
        tti = tti - 1
        sf_idx = tti % 10
        # age out grants whose PUSCH occasion passed un-decoded (e.g. the
        # UE wasn't SCell-active yet) — they would otherwise pile up
        for k in [k for k in self.pending_ul_scell if k < tti]:
            del self.pending_ul_scell[k]
        if tti not in self.pending_ul_scell:
            return
        rnti, grant = self.pending_ul_scell.pop(tti)
        ue = self.ues.get(rnti)
        if ue is None:
            return
        rx_grid = enb_ul_fft(self.scell, samples[None], device=self.device)
        out = enb_ul_decode_pusch(self.scell, sf_idx, rx_grid, grant, device=self.device)
        tb, ok = out[0], out[1]
        if not ok:
            self.stats["scell_ul_crc_ko"] = self.stats.get("scell_ul_crc_ko", 0) + 1
            return
        self.stats["scell_ul_crc_ok"] = self.stats.get("scell_ul_crc_ok", 0) + 1
        pdu = np.packbits(tb).tobytes()
        bsr, sdus = parse_ul_pdu(pdu)
        if bsr:
            self.scell_sched.ul_bsr(rnti, bsr)
        for lcid, sdu in sdus:
            if lcid == LCID_DRB1:
                ue.drb_rlc.write_pdu(sdu)
                while (r := ue.drb_rlc.read_sdu()) is not None:
                    ip_pkt = ue.drb_pdcp.write_pdu(r)
                    if ip_pkt is not None:
                        self.spgw.rx_from_enb(self.gtpu.tx(ue.dl_teid, ip_pkt))


# ---------------------------------------------------------------------------
# UE
# ---------------------------------------------------------------------------


class UeStack:
    RRC_IDLE, RRC_WAIT_RAR, RRC_WAIT_SETUP, RRC_CONNECTED, RRC_ACTIVE = range(5)
    # nominal antenna-port power of a 0 dBFS digital signal; maps dBFS
    # measurements onto the dBm scale q-RxLevMin (TS 36.304) is defined on
    DBFS_REF_DBM = -70.0

    def __init__(self, cell: Cell, usim: Usim, cfi: int | None = 2, preamble: int = 17, attach_delay: int = 0,
                 tdd_cfg: tdd.TddConfig | None = None, acquire_si: bool = False,
                 srs_enabled: bool = False, sr_enabled: bool = False,
                 tm: int = 2, nrx: int = 1, dynamic_phy: bool = False,
                 earfcn: int = 3400,
                 windowed_phy: bool = False, phy_window: int = 4,
                 phy_device=None, expert=None,
                 subband_cqi: bool = False, *, device=None):
        # every PHY call runs on `device` (None: the card); phy_device is
        # the windowed plane's and defaults to it
        self.device = resolve(device)
        phy_device = self.device if phy_device is None else resolve(phy_device)
        self.subband_cqi = subband_cqi  # aperiodic mode 3-0 reports
        # expert PHY tuning plane (runtime.config.ExpertPhyConfig — the
        # reference's [expert] section, ue.conf.example:318-385)
        if expert is None:
            from ..runtime.config import ExpertPhyConfig

            expert = ExpertPhyConfig()
        self.expert = expert
        self.srs_enabled = srs_enabled
        self.sr_enabled = sr_enabled
        # serving carrier EARFCN; inter-frequency measurements (rrc_meas.cc
        # + scell_recv.cc roles) retune here during configured gaps
        self.earfcn = earfcn
        self._ifreq_hist: list = []      # gap-captured samples (target freq, on device)
        self._ifreq_rsrp: dict = {}      # arfcn -> [CellMeas]
        # dynamic_phy: run single-codeword PDSCH decodes on the bucketed
        # TPU pipeline (pipeline_dynamic.DynamicUeDl) — the production
        # data path; host numpy otherwise (cheap for CPU-only tests)
        self._dyn_phy = None
        if dynamic_phy:
            from ..pipeline_dynamic import DynamicUeDl

            self._dyn_phy = DynamicUeDl(
                cell, cfi=cfi, max_iterations=expert.pdsch_max_its, device=self.device)
        # windowed_phy: the windowed TPU engines as the live data plane —
        # data PDSCH subframes queue into W-TTI windows and the HARQ
        # feedback runs at 4+W on both ends (windowed_plane.py contract)
        self._win_dl = None
        self.harq_delay = 4
        self.ul_grant_delay: int | None = None  # see EnbStack.__init__
        if windowed_phy:
            assert tdd_cfg is None, "windowed data plane is FDD-only"
            from .windowed_plane import WindowedUeDlPlane

            self._win_dl = WindowedUeDlPlane(
                cell, cfi=cfi, w=phy_window, tm=tm, nrx=nrx,
                device=phy_device,
                max_iterations=expert.pdsch_max_its,
                ingest="int8" if expert.pdsch_8bit_decoder else "int16")
            self.harq_delay = 4 + phy_window
        # transmission mode + rx antenna count; with nrx == 2 the DL link
        # input is (2, sf_len) rx-antenna streams (not CA carriers)
        self.tm = tm
        self.nrx = nrx
        self._dl_rank = 1
        self.gw = None  # optional kernel TUN gateway (attach_tun)
        self.cell = cell
        self.tdd = tdd_cfg
        self.prach_sf = _prach_sf(tdd_cfg)
        # SI acquisition before random access (rrc.cc SIB1/SIB2 procedures):
        # when enabled, the RA parameters come from the broadcast SIB2
        # instead of constructor defaults
        self.acquire_si = acquire_si
        self.sib1: dict | None = None
        self.sib2: dict | None = None
        # idle-mode intra-frequency reselection inputs/state (rrc_cell.cc
        # ranking; TS 36.304 §5.2.4): SIB3 params + Treselection counter
        self.sib3_params: dict | None = None
        self._resel_better_count = 0
        self._reest_ctx = None  # (crnti, pci, k_enb, ciph, integ) after RLF
        # idle mode: camped after RRCConnectionRelease — monitors paging
        # occasions and accesses only for MO data or an MT page
        self.idle_camped = False
        self._paged = False
        self._resuming = False  # next access is a NAS Service Request
        self.cfi = cfi
        self.nas = UeNas(usim)
        self.mac = UeMac()
        self.rrc_state = self.RRC_IDLE
        self.crnti: int | None = None
        self.preamble = preamble
        self.attach_delay = attach_delay
        self.srb1_rlc = RlcAm()
        self.drb_rlc = RlcAm()
        self.srb1_pdcp, self.drb_pdcp = _bearer_set(None, 0, 0, is_enb=False)
        self.cipher_alg = self.integ_alg = 0
        self.ue_identity = b"\x12\x34\x56\x78\x9a"
        self.msg3: bytes | None = None
        self.pending_tx: dict[int, UlGrant] = {}  # tti -> grant to transmit
        # DL HARQ: per-process softbuffers (LLR combining across retx) and
        # last-seen NDI for duplicate detection (dl_harq.cc roles), plus
        # the ACK schedule: tti -> [(n_pucch, ack_bit)]
        self._dl_softbuffers: dict = {}
        self._dl_ndi: dict[int, tuple[int, bool]] = {}
        self.pending_ack: dict[int, list[tuple[int, int]]] = {}
        # FDD CA: SCell ACK bit per occasion, multiplexed with the PCell
        # bit on PUCCH format 3 (pucch_proc.c:60-150)
        self.pending_ack_scell: dict[int, int] = {}
        # UL HARQ: PUSCH in flight awaiting its PHICH (phich_tti ->
        # (grant, tb_bits, tx_count)) and NACK-triggered retransmissions
        self._ul_inflight: dict[int, tuple] = {}
        self.pending_retx: dict[int, tuple] = {}
        # closed-loop UL power control (TS 36.213 §5.1.1.1 accumulated
        # TPC; ue_ul.c power-control state): dB applied to PUSCH samples
        self.ul_gain_db = 0.0
        self._apcqi_tx: set[int] = set()  # aperiodic-CQI PUSCH ttis
        # timing advance: initial value from the RAR, maintained by TA
        # MAC CEs (TS 36.321 §6.1.3.5; UE applies it by advancing UL tx)
        self.ta_samples = 0
        # power headroom reporting (proc_phr.cc): periodic + prohibit
        # timers and the dl-PathlossChange trigger; first report goes out
        # with the first PUSCH after (re)configuration (proc_phr.cc:74)
        self.phr_periodic_tti = 100
        self.phr_prohibit_tti = 20
        self.phr_db_change = 3.0
        self._phr_next_periodic = 0
        self._phr_prohibit_until = 0
        self._phr_last_pl: float | None = None
        self.prach_cfg = PrachConfig()
        self.ip_rx: list[bytes] = []
        self.ip_tx_queue: list[bytes] = []
        self.tti = 0
        self.stats = {"dl_tbs_ok": 0, "rar": 0, "rlf": 0, "meas_report": 0, "ho": 0}
        # measurements + mobility (rrc_meas.cc / mobility execution)
        self.meas_cfg: dict | None = None  # decoded measConfig
        # R10 carrier aggregation: SCell learned from the reconfiguration,
        # activated by the MAC Activation/Deactivation CE
        self.scell: Cell | None = None
        self.scell_active = False
        self.pending_tx_scell: dict[int, "UlGrant"] = {}  # UL CA grants
        self._samp_hist: deque = deque(maxlen=10)  # the last 10 subframes, on device
        self._meas_prohibit_tti = 0
        self._ho_cf_preamble: int | None = None  # pending CF-RA on target
        # radio-link monitoring (the rrc.cc:428-437 N310/T310 chain)
        self.n310 = 5  # consecutive out-of-sync indications to start T310
        self.t310_ms = 20
        self._oos_count = 0
        self._t310 = -1
        # out-of-sync gate: mean |x|^2 below this = out-of-sync; the
        # expert in_sync_rsrp_dbm_th maps onto the digital scale
        # (default -130 dBm ↔ 1e-4 here, 10 dB/decade)
        self._sync_threshold = 10.0 ** (
            (expert.in_sync_rsrp_dbm_th + 90.0) / 10.0)

    @property
    def ue_ip(self) -> str:
        return self.nas.ue_ip

    def attach_tun(self, name: str = "tun_ue0", netns: str | None = None):
        """Open the kernel IP boundary (gw.cc TUN role): requires an
        assigned UE IP (post-attach).  Outbound kernel packets become UL
        SDUs each TTI; DL SDUs are written back to the kernel."""
        from ..io.tun import UeGw

        assert self.ue_ip, "attach first (no UE IP yet)"
        self.gw = UeGw(self.ue_ip, name=name, netns=netns)
        return self.gw

    def send_ip_packet(self, pkt: bytes):
        self.ip_tx_queue.append(bytes(pkt))

    def detach(self, switch_off: bool = False):
        """UE-initiated NAS detach (nas.cc detach procedure)."""
        if self.rrc_state >= self.RRC_CONNECTED:
            self._send_srb1(rrc.pack_ul_info_transfer(self.nas.detach_request(switch_off)))

    def start_attach(self):
        pass  # attach starts automatically from IDLE at the next PRACH occasion

    # --- radio link failure (SURVEY §5.3 failure-detection chain) ---
    def _radio_link_monitor(self, samples: torch.Tensor):
        if self.rrc_state < self.RRC_CONNECTED:
            return
        in_sync = torch.mean(samples.abs() ** 2).item() > self._sync_threshold
        if in_sync:
            self._oos_count = 0
            self._t310 = -1
            return
        self._oos_count += 1
        if self._oos_count >= self.n310 and self._t310 < 0:
            self._t310 = self.t310_ms  # start T310
        if self._t310 > 0:
            self._t310 -= 1
            if self._t310 == 0:
                self._declare_rlf()

    def _declare_rlf(self):
        """T310 expiry → RLF.  With a valid AS security context the UE
        attempts RRC connection re-establishment (TS 36.331 §5.3.7 /
        rrc.cc re-establishment): the NAS context and IP survive; only
        on reject does it fall back to a full re-attach."""
        self.stats["rlf"] += 1
        if (self.rrc_state >= self.RRC_CONNECTED and self.crnti is not None
                and self.integ_alg):
            self._reest_ctx = (self.crnti, self.cell.id, self.nas.get_k_enb(),
                               self.cipher_alg, self.integ_alg)
        else:
            self._reest_ctx = None
        self._reset_connection(keep_nas=self._reest_ctx is not None)

    def _reset_connection(self, keep_nas: bool):
        self.rrc_state = self.RRC_IDLE
        self.crnti = None
        self.msg3 = None
        self.pending_tx.clear()
        self.pending_ack.clear()
        self.pending_ack_scell.clear()
        self._dl_softbuffers.clear()
        self._dl_ndi.clear()
        self._ul_inflight.clear()
        self.pending_retx.clear()
        self.mac = UeMac()
        self.srb1_rlc, self.drb_rlc = RlcAm(), RlcAm()
        self.srb1_pdcp, self.drb_pdcp = _bearer_set(None, 0, 0, is_enb=False)
        self.cipher_alg = self.integ_alg = 0
        if not keep_nas:
            self.nas = UeNas(self.nas.usim)
        self._oos_count = 0
        self._t310 = -1

    # --- TTI processing ---
    def tuned_earfcn(self, tti: int | None = None) -> int:
        """The EARFCN the receiver is tuned to at `tti` — the serving
        carrier, except during configured measurement gaps (TS 36.133
        6 ms gaps every 40/80 ms) when an inter-frequency measObject
        retunes it (`rrc_meas.cc` gap-based measurement; the harness
        feeds whatever carrier this returns)."""
        tti = self.tti if tti is None else tti
        if self.meas_cfg is None or self.rrc_state != self.RRC_ACTIVE:
            return self.earfcn
        gap = rrc.meas_config_gap(self.meas_cfg)
        if gap is None:
            return self.earfcn
        period, offset = gap
        if (tti - offset) % period >= 6:
            return self.earfcn
        carriers = rrc.meas_config_carriers(self.meas_cfg)
        targets = [a for a in carriers.values() if a != self.earfcn]
        return targets[0] if targets else self.earfcn

    def _gap_tti(self, tti: int, dl_samples: torch.Tensor) -> None:
        """One measurement-gap subframe: the receiver is away from the
        serving carrier — collect the target-frequency capture; at gap
        end (6 subframes) run the scell_recv-style search + measurement
        and evaluate the inter-frequency A3 event."""
        self._ifreq_hist.append(dl_samples)
        self.tti += 1
        if len(self._ifreq_hist) < 6:
            return
        samples = torch.cat(self._ifreq_hist)
        self._ifreq_hist = []
        from ..phy.ue.intra_measure import measure_cells
        from ..stack.rrc import meas_config_a3_offset_db

        target = self.tuned_earfcn(tti)
        neighbours = measure_cells(samples, self.cell.nof_prb, device=self.device)
        self._ifreq_rsrp[target] = neighbours
        serving = getattr(self, "_dl_rsrp_dbfs", None)
        if (serving is None or not neighbours
                or tti < self._meas_prohibit_tti):
            return
        a3 = meas_config_a3_offset_db(self.meas_cfg)
        best = max(neighbours, key=lambda c: c.rsrp_dbfs)
        if best.rsrp_dbfs > serving + a3:
            carriers = rrc.meas_config_carriers(self.meas_cfg)
            meas_id = next((m for m, a in carriers.items()
                            if a == target), 2)
            self._send_srb1(rrc.pack_measurement_report(
                meas_id, serving, [(best.pci, best.rsrp_dbfs)]))
            self.stats["meas_report"] += 1
            self._meas_prohibit_tti = tti + 100

    def run_tti(self, dl_samples: torch.Tensor) -> torch.Tensor | None:
        """One TTI: take this TTI's DL subframe ((sf_len,) complex64 on
        `device`; (2, sf_len) for two rx antennas or CA) and return the UL
        subframe to send, on `device`, or None."""
        tti = self.tti
        sf_idx = tti % 10
        if self.tuned_earfcn(tti) != self.earfcn:
            # measurement gap: away from the serving carrier — no serving
            # DL processing, no UL transmission, no RLM accounting
            self._gap_tti(tti, dl_samples)
            return None
        scell_samples = None
        rx_ants = None
        if dl_samples.ndim == 2 and self.nrx == 2:
            # 2 rx antennas (TM3/TM4 spatial multiplexing link)
            rx_ants = dl_samples
            dl_samples = dl_samples[0]
        elif dl_samples.ndim == 2:  # CA: (n_cc, sf_len), cc 0 = PCell
            dl_samples, scell_samples = dl_samples[0], dl_samples[1]
        for ent in (self.srb1_rlc, self.drb_rlc):  # RLC timers
            if hasattr(ent, "tick"):
                ent.tick()
        if tdd.sf_type(self.tdd, sf_idx) != tdd.SfType.U:
            self._radio_link_monitor(dl_samples)  # U subframes carry no DL
        self._samp_hist.append(dl_samples)
        self._process_dl(tti, sf_idx, dl_samples if rx_ants is None else rx_ants)
        if scell_samples is not None and self.scell is not None and self.scell_active:
            self._process_scell_dl(tti, sf_idx, scell_samples)
        if sf_idx == 9:
            self._run_measurements(tti)
            self._run_idle_reselection()
        if self._win_dl is not None:
            self._win_dl.flush(tti)
            for ev in self._win_dl.poll(tti):
                self._complete_dl_data(ev)
        if self.gw is not None and self.rrc_state == self.RRC_ACTIVE:
            self.gw.pump_ul(self.send_ip_packet)
        ul = self._build_ul(tti, sf_idx)
        if ul is not None and self.expert.force_ul_amplitude > 0:
            peak = torch.max(ul.abs()).item()
            if peak > 0:
                ul = ul * (self.expert.force_ul_amplitude / peak)
        sg = self.pending_tx_scell.pop(tti, None)
        if sg is not None and self.scell_active:
            mac2 = self._build_ul_mac_pdu(sg.tbs // 8)
            sc_ul = ue_ul_encode(self.scell, sf_idx,
                                 pusch=(sg, np.unpackbits(np.frombuffer(mac2, np.uint8))),
                                 device=self.device)
            self.stats["scell_pusch_tx"] = self.stats.get("scell_pusch_tx", 0) + 1
            if ul is None:
                ul = torch.zeros(self.cell.sf_len, dtype=torch.complex64, device=self.device)
            ul = torch.stack([ul, sc_ul])
        self.tti += 1
        return ul

    def _run_idle_reselection(self):
        """Camped-UE intra-frequency reselection (TS 36.304 §5.2.4; the
        rrc_cell.cc cell-ranking role): rank R_s = Q_meas,s + Qhyst
        against R_n = Q_meas,n each frame; after TreselectionEUTRA of
        continuously better ranking, reselect and re-acquire SI there.
        Measurements are digital-domain dBFS; the S-criterion threshold
        (2×q-RxLevMin dBm) is applied on the same scale."""
        if (not self.idle_camped or self.sib3_params is None
                or len(self._samp_hist) < 10):
            return
        serving = getattr(self, "_dl_rsrp_dbfs", None)
        if serving is None:
            return
        from ..phy.ue.intra_measure import measure_cells

        samples = torch.cat(list(self._samp_hist))
        neighbours = measure_cells(samples, self.cell.nof_prb, serving_pci=self.cell.id,
                                   device=self.device)
        p = self.sib3_params
        # S-criterion: q-RxLevMin is a dBm threshold while measurements
        # are digital-domain dBFS — map them onto a nominal dBm scale
        # (0 dBFS ≙ DBFS_REF_DBM at the antenna port) so the SIB3 setting
        # actually excludes weak cells instead of being inert.
        candidates = [n for n in neighbours
                      if n.rsrp_dbfs + self.DBFS_REF_DBM > p["q_rx_lev_min_dbm"]]
        if not candidates:
            self._resel_better_count = 0
            return
        best = max(candidates, key=lambda c: c.rsrp_dbfs)
        if best.rsrp_dbfs > serving + p["q_hyst_db"]:
            self._resel_better_count += 1
        else:
            self._resel_better_count = 0
            return
        # evaluations run once per 10 ms frame
        if self._resel_better_count > p["t_resel_s"] * 100:
            self._reselect_to(best.pci)

    def _reselect_to(self, pci: int):
        """Camp on the new cell: serving PCI switches, SI of the new cell
        must be re-acquired before any PRACH; NAS/IP context is kept
        (the UE stays ECM-IDLE — the network learns of the move only at
        the next Service Request)."""
        self.cell = dataclasses.replace(self.cell, id=pci)
        self.sib1 = self.sib2 = None
        self.sib3_params = None
        self.acquire_si = True
        self._resel_better_count = 0
        self._samp_hist.clear()
        self._dl_rsrp_dbfs = None
        self._dl_softbuffers.clear()
        self._dl_ndi.clear()
        self.stats["reselection"] = self.stats.get("reselection", 0) + 1

    def _run_measurements(self, tti: int):
        """Intra-frequency neighbour search + A3 evaluation over the last
        10 subframes (intra_measure.cc role; rrc_meas.cc event logic)."""
        if (self.meas_cfg is None or self.rrc_state != self.RRC_ACTIVE
                or len(self._samp_hist) < 10 or tti < self._meas_prohibit_tti):
            return
        from ..phy.ue.intra_measure import measure_cells
        from ..stack.rrc import meas_config_a3_offset_db

        samples = torch.cat(list(self._samp_hist))
        # neighbours from the blind intra-frequency search; the SERVING
        # measurement comes from the synchronized receiver's own chest
        # (cc_worker measurements), as in the reference — blind search on
        # the serving PCI under strong interference is unreliable
        neighbours = measure_cells(samples, self.cell.nof_prb, serving_pci=self.cell.id,
                                   device=self.device)
        serving_rsrp_dbfs = getattr(self, "_dl_rsrp_dbfs", None)
        if serving_rsrp_dbfs is None or not neighbours:
            return
        a3 = meas_config_a3_offset_db(self.meas_cfg)
        best = max(neighbours, key=lambda c: c.rsrp_dbfs)
        if best.rsrp_dbfs > serving_rsrp_dbfs + a3:
            meas_id = self.meas_cfg["meas_id_to_add_mod_list"][0]["meas_id"]
            self._send_srb1(rrc.pack_measurement_report(
                meas_id, serving_rsrp_dbfs, [(best.pci, best.rsrp_dbfs)]))
            self.stats["meas_report"] += 1
            self._meas_prohibit_tti = tti + 100  # reportInterval stand-in

    def _ack_tti(self, dl_tti: int) -> int:
        if self.harq_delay != 4:
            return dl_tti + self.harq_delay
        return tdd.ack_tti(self.tdd, dl_tti)

    def _complete_dl_data(self, ev: dict):
        """Deferred completion of a windowed PDSCH decode: the same DL
        HARQ feedback + duplicate-suppression logic the inline path runs,
        with the ACK scheduled at the stretched position."""
        dci_d = ev["dci"]
        ok = all(okb for _, okb in ev["tbs"])
        ndi_key = ev["ndi"]
        last = self._dl_ndi.get(dci_d.harq_pid)
        is_dup = last is not None and last[0] == ndi_key and last[1]
        self._dl_ndi[dci_d.harq_pid] = (ndi_key, ok or is_dup)
        self.pending_ack.setdefault(self._ack_tti(ev["tti"]), []).append(
            (ev["cce"], 1 if (ok or is_dup) else 0, ev["tti"]))
        if ok and not is_dup:
            for tb_i, _ok_i in ev["tbs"]:
                self.stats["dl_tbs_ok"] += 1
                self._handle_dl_pdu(np.packbits(tb_i).tobytes())

    def _phich_tti(self, pusch_tti: int) -> int:
        if self.harq_delay != 4:
            return pusch_tti + self.harq_delay
        return tdd.phich_tti(self.tdd, pusch_tti)

    def _process_dl(self, tti: int, sf_idx: int, samples: torch.Tensor):
        if tdd.sf_type(self.tdd, sf_idx) == tdd.SfType.U:
            return  # nothing to receive on our own UL subframes
        is_tdd = self.tdd is not None
        rx = samples if samples.ndim == 2 else samples[None]
        inflight = self._ul_inflight.pop(tti, None)
        rntis = []
        if self.acquire_si and (self.sib1 is None or self.sib2 is None):
            from ..phy.common import SIRNTI

            rntis.append(SIRNTI)
        if self.idle_camped and sf_idx == 9:
            from ..phy.common import PRNTI

            rntis.append(PRNTI)  # paging occasion monitor
        if self.rrc_state == self.RRC_WAIT_RAR or getattr(self, "_ho_in_progress", False):
            rntis.append(1 + self.prach_sf)  # RA-RNTI
        if self.crnti is not None:
            rntis.append(self.crnti)
        elif inflight is not None:
            inflight = None  # context reset while a PUSCH was in flight
        for rnti in rntis:
            is_c = rnti == self.crnti
            win = None
            if (self._win_dl is not None and is_c
                    and self.rrc_state == self.RRC_ACTIVE):
                self._win_dl.current_tti = tti
                win = self._win_dl
            res = ue_dl_decode_subframe(
                self.cell, rx, sf_idx, rnti, known_cfi=self.cfi,
                tdd=self.tdd, nrx=rx.shape[0],
                max_iterations=self.expert.pdsch_max_its,
                tm=self.tm if is_c else 2,
                dynamic=self._dyn_phy, deferred=win,
                harq_softbuffers=self._dl_softbuffers if is_c else None,
                phich=_phich_resource(self.cell, inflight[0]) if (is_c and inflight) else None,
                device=self.device,
            )
            if is_c and res.rank:
                self._dl_rank = res.rank
                self._dl_pmi = res.pmi
            if is_c and inflight is not None and res.phich_ack is not None:
                g_fl, tb_fl, txc = inflight
                if not res.phich_ack and txc < UL_HARQ_MAX_TX:
                    from ..stack.mac import HARQ_RV_SEQ

                    retx_tti = (tti + self.ul_grant_delay
                                if self.ul_grant_delay
                                else tdd.pusch_tti(self.tdd, tti))
                    g2 = dataclasses.replace(g_fl, rv=HARQ_RV_SEQ[txc % 4])
                    self.pending_retx[retx_tti] = (g2, tb_fl, txc + 1)
                    self.stats["ul_retx"] = self.stats.get("ul_retx", 0) + 1
            if res.snr_db:
                # expert.snr_ema_coeff: EMA like the reference's
                # avg_snr_db_cqi (phy_common snr_ema_coeff)
                a = self.expert.snr_ema_coeff
                prev = getattr(self, "_dl_snr_db", None)
                self._dl_snr_db = (res.snr_db if prev is None
                                   else (1 - a) * prev + a * res.snr_db)
            if res.sb_snr is not None:
                a = self.expert.snr_ema_coeff
                prev = getattr(self, "_sb_snr", None)
                self._sb_snr = (res.sb_snr if prev is None
                                else (1 - a) * prev + a * res.sb_snr)
            if res.rsrp:
                self._dl_rsrp_dbfs = 10.0 * np.log10(res.rsrp + 1e-12)
            for (bits, agg, cce) in res.dcis:
                if bits[0] == 0 and rnti == self.crnti:
                    # DCI format 0: UL grant for tti+k (FDD k=4, TDD Table 8-2)
                    delay = self.ul_grant_delay or _pusch_delay(self.tdd, tti)
                    if delay is None:
                        continue
                    dci0 = Dci0.unpack(bits, self.cell.nof_prb, tdd=is_tdd,
                                       tdd_cfg0=is_tdd and self.tdd.sf_config == 0)
                    # accumulated TPC (Table 5.1.1.1-2: -1, 0, +1, +3 dB)
                    self.ul_gain_db = float(np.clip(
                        self.ul_gain_db + (-1, 0, 1, 3)[dci0.tpc], -20.0, 20.0))
                    if dci0.cqi_request:
                        self._apcqi_tx.add(tti + delay)
                    try:
                        rb0, l_crb = riv_decode(self.cell.nof_prb, dci0.riv)
                        grant0 = UlGrant(
                            prb_start=rb0, nof_prb=l_crb,
                            mod=ul_mcs_to_mod(dci0.mcs),
                            tbs=tbs_lookup(ul_mcs_to_itbs(dci0.mcs), l_crb),
                            rnti=rnti)
                    except (ValueError, IndexError):
                        # CRC-RNTI false positive: a ~2^-16/candidate noise
                        # decode can carry reserved fields (e.g. MCS 29-31,
                        # never sent as a fresh grant here) — discard like
                        # the reference's DCI field validation (dci.c)
                        continue
                    self.pending_tx[tti + delay] = grant0
            if rnti == self.crnti and res.deferred:
                continue  # windowed plane: completion via _complete_dl_data
            if rnti == self.crnti and res.dci_used is not None and res.tbs:
                # DL HARQ feedback + duplicate suppression (dl_harq.cc).
                # 2-codeword grants (DCI 2/2A) report ONE bit = AND of the
                # codewords (conservative bundling; both TBs retransmit
                # together on NACK)
                dci_d = res.dci_used
                ok = all(bool(okb) for _, okb in res.tbs)
                ndi_key = getattr(dci_d, "ndi", None)
                if ndi_key is None:
                    ndi_key = (dci_d.ndi1, dci_d.ndi2)
                last = self._dl_ndi.get(dci_d.harq_pid)
                is_dup = last is not None and last[0] == ndi_key and last[1]
                self._dl_ndi[dci_d.harq_pid] = (ndi_key, ok or is_dup)
                self.pending_ack.setdefault(self._ack_tti(tti), []).append(
                    (res.cce_used, 1 if (ok or is_dup) else 0, tti))
                if ok and not is_dup:
                    for tb_i, _ok_i in res.tbs:
                        self.stats["dl_tbs_ok"] += 1
                        self._handle_dl_pdu(np.packbits(tb_i).tobytes())
                continue
            for tb, ok in res.tbs:
                if not ok:
                    continue
                self.stats["dl_tbs_ok"] += 1
                pdu = np.packbits(tb).tobytes()
                if rnti == 0xFFFF:
                    self._handle_si(pdu)
                elif rnti == 0xFFFE:
                    self._handle_paging(pdu)
                elif rnti != self.crnti:
                    self._handle_rar(tti, pdu)
                else:
                    self._handle_dl_pdu(pdu)

    def _process_scell_dl(self, tti: int, sf_idx: int, samples: torch.Tensor):
        """Decode the activated SCell's subframe with the PCell C-RNTI
        (the extra cc_worker of cc_worker.cc's carrier loop)."""
        res = ue_dl_decode_subframe(self.scell, samples[None], sf_idx, self.crnti,
                                    known_cfi=self.cfi, device=self.device)
        for (bits, agg, cce) in res.dcis:
            if bits[0] == 0:
                # UL CA: DCI0 on the SCell PDCCH schedules a PUSCH on the
                # second UL carrier at tti+4 (no cross-carrier scheduling)
                try:
                    dci0 = Dci0.unpack(bits, self.scell.nof_prb)
                    rb0, l_crb = riv_decode(self.scell.nof_prb, dci0.riv)
                    g_sc = UlGrant(
                        prb_start=rb0, nof_prb=l_crb,
                        mod=ul_mcs_to_mod(dci0.mcs),
                        tbs=tbs_lookup(ul_mcs_to_itbs(dci0.mcs), l_crb),
                        rnti=self.crnti)
                except (ValueError, IndexError):
                    continue  # false positive / reserved fields
                self.pending_tx_scell[tti + 4] = g_sc
        if res.tbs and self.tdd is None:
            # FDD CA HARQ-ACK: the SCell bit joins the PCell's on ONE
            # format-3 resource at the ACK occasion (pucch_proc.c
            # format-3 selection; TDD keeps channel selection)
            self.pending_ack_scell[self._ack_tti(tti)] = (
                1 if all(ok for _, ok in res.tbs) else 0)
        for tb, ok in res.tbs:
            if not ok:
                continue
            self.stats["scell_tbs_ok"] = self.stats.get("scell_tbs_ok", 0) + 1
            self._handle_dl_pdu(np.packbits(tb).tobytes())

    def _si_ready(self) -> bool:
        return not self.acquire_si or (self.sib1 is not None and self.sib2 is not None)

    def _handle_paging(self, pdu: bytes):
        """PCCH Paging on the monitored occasion: an S-TMSI match wakes
        the camped UE for a Service Request (rrc.cc paging handling)."""
        try:
            records = rrc.unpack_pcch(pdu)
        except Exception:
            return
        for kind, pid in records:
            if kind == "s_tmsi" and pid.get("m_tmsi") == self.nas.m_tmsi:
                self._paged = True
                self.stats["paged"] = self.stats.get("paged", 0) + 1

    def _handle_si(self, pdu: bytes):
        """BCCH-DL-SCH: SIB1 schedules, SIB2 configures RA (rrc.cc SI
        acquisition before the first PRACH)."""
        try:
            kind, body = rrc.unpack_bcch_dl_sch(pdu)
        except Exception:
            return  # not a parsable SI TB (e.g. padding-only)
        if kind == "sib_type1":
            self.sib1 = body
            return
        for k2, sib in body:
            if k2 == "sib3":
                self.sib3_params = rrc.sib3_resel_params(sib)
                continue
            if k2 != "sib2":
                continue
            self.sib2 = sib
            p = rrc.sib2_rach_params(sib)
            self.preamble = min(self.preamble, p["nof_preambles"] - 1)
            if self.tdd is None:
                # prach-ConfigIndex 3 → FDD sf 1 (TS 36.211 Table 5.7.1-2)
                self.prach_sf = {3: 1}.get(p["prach_config_index"], self.prach_sf)
            # apply the broadcast PRACH plane (prach.c follows SIB2's
            # rootSequenceIndex/zeroCorrelationZone/frequencyOffset)
            self.prach_cfg = PrachConfig(
                root_seq_index=p["root_seq_idx"],
                zero_corr_zone=p["zero_corr_zone"],
                freq_offset=p["prach_freq_offset"],
                nof_preambles=p["nof_preambles"],
            )
            self.n310 = p["n310"]
            self.t310_ms = p["t310_ms"]

    def _handle_rar(self, tti: int, pdu: bytes):
        rar = _unpack_rar(pdu)
        if rar is None:
            return
        rapid, ta, grant20, temp_crnti = rar
        if not self.mac.handle_rar(rapid, ta, temp_crnti):
            return
        self.ta_samples = ta  # initial timing advance from the RAR
        self.stats["rar"] += 1
        if getattr(self, "_ho_in_progress", False):
            # contention-free RA on the HO target: the "temp" C-RNTI is the
            # one mobilityControlInfo assigned; Msg3 carries the queued
            # ReconfigurationComplete on SRB1
            self._ho_in_progress = False
            self.rrc_state = self.RRC_ACTIVE
            delay = self.ul_grant_delay or _pusch_delay(self.tdd, tti) or FB_DELAY
            self.pending_tx[tti + delay] = _msg3_grant(self.cell, self.crnti, grant20)
            return
        self.crnti = temp_crnti
        self.rrc_state = self.RRC_WAIT_SETUP
        ctx = getattr(self, "_reest_ctx", None)
        if ctx is not None:
            # Msg3 = RRCConnectionReestablishmentRequest with shortMAC-I
            old_crnti, pci, k_enb, _ciph, integ = ctx
            mac_i = rrc.short_mac_i(k_enb, integ, pci, old_crnti, self.cell.id)
            self.msg3 = rrc.pack_reest_request(old_crnti, pci, mac_i)
        elif self._resuming:
            # idle-mode resume: Msg3 identifies by S-TMSI so the eNB can
            # forward it in the Initial UE Message (paging response)
            self.msg3 = rrc.pack_conn_request(
                b"\x00" * 5, cause="mt_access", s_tmsi=(1, self.nas.m_tmsi))
        else:
            # Msg3 = RRC ConnectionRequest on CCCH
            self.msg3 = rrc.pack_conn_request(self.ue_identity)
        self._msg3_sdu = self.msg3  # kept for MAC contention resolution
        delay = self.ul_grant_delay or _pusch_delay(self.tdd, tti) or FB_DELAY
        self.pending_tx[tti + delay] = _msg3_grant(self.cell, temp_crnti, grant20)

    def _handle_dl_pdu(self, pdu: bytes):
        from ..stack.mac_pdu import LCID_SCELL_ACT, scell_activation_parse

        for lcid, sdu in mac_unpack(pdu, ce_sizes=DL_CE_SIZES):
            if lcid == 29 and len(sdu) == 1:
                # Timing Advance Command CE: 31 = hold, delta in samples
                self.ta_samples += int(sdu[0]) - 31
                self.stats["ta_cmd"] = self.stats.get("ta_cmd", 0) + 1
            elif lcid == LCID_SCELL_ACT:
                self.scell_active = bool(scell_activation_parse(sdu)) and self.scell is not None
            elif lcid == LCID_CON_RES:
                self._con_res_ok = self.mac.handle_contention_resolution(
                    sdu, rrc.contention_resolution_id(getattr(self, "_msg3_sdu", b""))
                )
            elif lcid == LCID_CCCH:
                self._handle_ccch(sdu)
            elif lcid == LCID_SRB1:
                self.srb1_rlc.write_pdu(sdu)
                while (r := self.srb1_rlc.read_sdu()) is not None:
                    self._handle_srb1(r)
            elif lcid == LCID_DRB1:
                self.drb_rlc.write_pdu(sdu)
                while (r := self.drb_rlc.read_sdu()) is not None:
                    pkt = self.drb_pdcp.write_pdu(r)
                    if pkt is not None:
                        self.ip_rx.append(pkt)
                        if self.gw is not None:
                            # real kernel boundary (gw.cc write to TUN)
                            self.gw.deliver_dl(pkt)

    def _handle_ccch(self, sdu: bytes):
        kind, body = rrc.unpack_dl_ccch(sdu)
        if kind == "rrc_conn_setup" and getattr(self, "_con_res_ok", False):
            self.rrc_state = self.RRC_CONNECTED
            # ECM-IDLE resume carries a NAS Service Request instead of a
            # fresh Attach (nas.cc service-request path)
            nas_pdu = (self.nas.service_request() if self._resuming
                       else self.nas.attach_request())
            self._send_srb1(rrc.pack_conn_setup_complete(nas_pdu))
        elif kind == "rrc_conn_reest" and getattr(self, "_con_res_ok", False):
            # resume AS security with the kept KeNB (ncc 0 = horizontal)
            _oc, _pci, k_enb, ciph, integ = self._reest_ctx
            self._reest_ctx = None
            self.cipher_alg, self.integ_alg = ciph, integ
            self.srb1_pdcp, self.drb_pdcp = _bearer_set(k_enb, ciph, integ, is_enb=False)
            self.rrc_state = self.RRC_CONNECTED
            self.stats["reest"] = self.stats.get("reest", 0) + 1
            self._send_srb1(rrc.pack_reest_complete())
        elif kind == "rrc_conn_reest_reject":
            # no context at the eNB → fall back to a full attach
            self._reest_ctx = None
            self._reset_connection(keep_nas=False)

    def _handle_srb1(self, pdcp_pdu: bytes):
        rrc_pdu = self.srb1_pdcp.write_pdu(pdcp_pdu)
        if rrc_pdu is None:
            return
        kind, body = rrc.unpack_dl_dcch(rrc_pdu)
        if kind == "dl_info_transfer":
            resp = self.nas.handle_dl(body["ded_info_type"][1])
            if resp is not None:
                self._send_srb1(rrc.pack_ul_info_transfer(resp))
        elif kind == "security_mode_cmd":
            self.cipher_alg, self.integ_alg = rrc.smc_algorithms(body)
            # respond on the old (unsecured) entity, then switch; a
            # service-request resume derives KeNB from the SR's UL NAS
            # count (TS 33.401 §7.2.7), matching the MME's ICS key
            k_enb = (self.nas.get_k_enb_service() if self._resuming
                     else self.nas.get_k_enb())
            self._resuming = False
            self._send_srb1(rrc.pack_security_mode_complete())
            self.srb1_pdcp, self.drb_pdcp = _bearer_set(
                k_enb, self.cipher_alg, self.integ_alg, is_enb=False
            )
        elif kind == "rrc_conn_release":
            # graceful release → ECM-IDLE camping (NAS/IP context kept;
            # paging or MO data triggers a Service Request later)
            self.stats["released"] = self.stats.get("released", 0) + 1
            self._reest_ctx = None
            self._reset_connection(keep_nas=True)
            self.idle_camped = True
        elif kind == "rrc_conn_recfg":
            if "mob_ctrl_info" in body:
                self._execute_handover(body["mob_ctrl_info"], body.get("security_cfg_ho"))
                return  # complete is sent on the target cell after RA
            if "meas_cfg" in body:
                self.meas_cfg = body["meas_cfg"]
            adds, rels = rrc.reconfiguration_scells(body)
            for sc in adds:
                bw = {"n6": 6, "n15": 15, "n25": 25, "n50": 50, "n75": 75, "n100": 100}
                ports = {"an1": 1, "an2": 2, "an4": 4}
                nul = sc.get("rr_cfg_common_scell", {}).get("non_ul_cfg", {})
                self.scell = Cell(
                    nof_prb=bw[nul.get("dl_bw", "n6")],
                    nof_ports=ports[nul.get("ant_info_common", {}).get("ant_ports_count", "an1")],
                    id=sc["cell_identif"]["phys_cell_id"],
                )
                self.scell_active = False  # waits for the MAC Activation CE
            if rels:
                self.scell = None
                self.scell_active = False
            for nas_pdu in body.get("ded_info_nas_list", []):
                resp = self.nas.handle_dl(nas_pdu)
                if resp is not None:
                    self._send_srb1(rrc.pack_ul_info_transfer(resp))
            self._send_srb1(rrc.pack_reconfiguration_complete())
            self.rrc_state = self.RRC_ACTIVE

    def _execute_handover(self, mci: dict, sec_ho: dict | None = None):
        """Apply mobilityControlInfo (TS 36.331 §5.3.5.4; the reference's
        rrc.cc handover execution): retune to the target PCI, take the new
        C-RNTI, re-establish RLC/PDCP with the same keys, queue the
        ReconfigurationComplete for delivery after contention-free RA."""
        import dataclasses as _dc

        self.stats["ho"] += 1
        if "carrier_freq" in mci:  # inter-frequency HO: retune first
            self.earfcn = mci["carrier_freq"]["dl_carrier_freq"]
            self.meas_cfg = None  # gaps stop; target sends a fresh config
        self.cell = _dc.replace(self.cell, id=mci["target_pci"])
        self.crnti = mci["new_ue_id"]
        self.mac = UeMac()
        self.pending_tx.clear()
        self.pending_ack.clear()
        self.pending_ack_scell.clear()
        self._dl_softbuffers.clear()
        self._dl_ndi.clear()
        self._ul_inflight.clear()
        self.pending_retx.clear()
        self.msg3 = None
        self.srb1_rlc, self.drb_rlc = RlcAm(), RlcAm()
        if sec_ho is not None:  # S1 HO: vertical key from NH chaining count
            from ..stack import security as _sec

            ncc = sec_ho["handov_type"][1]["next_hop_chaining_count"]
            k_enb = _sec.generate_k_enb(self.nas.k_asme, ncc)
        else:  # intra-eNB: same KeNB (keyChangeIndicator absent/false)
            k_enb = self.nas.get_k_enb()
        self.srb1_pdcp, self.drb_pdcp = _bearer_set(
            k_enb, self.cipher_alg, self.integ_alg, is_enb=False
        )
        self._send_srb1(rrc.pack_reconfiguration_complete())
        self._ho_cf_preamble = mci.get("rach_cfg_ded", {}).get("ra_preamb_idx", self.preamble)
        self._con_res_ok = True  # CF-RA: no contention resolution
        self._samp_hist.clear()
        self._meas_prohibit_tti = self.tti + 100

    def _send_srb1(self, rrc_pdu: bytes):
        self.srb1_rlc.write_sdu(self.srb1_pdcp.write_sdu(rrc_pdu))

    # --- UL build ---
    def _buffer_state(self) -> int:
        n = self.srb1_rlc.buffer_state() + self.drb_rlc.buffer_state()
        n += sum(len(p) + 4 for p in self.ip_tx_queue)
        return n

    def _report_cqi(self) -> int:
        """Wideband CQI to report, shaped by the expert plane
        (cqi_fixed / cqi_max / snr_to_cqi_offset —
        ue.conf.example:327-329, applied in the reference's
        phy_common)."""
        e = self.expert
        if e.cqi_fixed >= 0:
            return min(e.cqi_fixed, e.cqi_max)
        snr = getattr(self, "_dl_snr_db", 20.0) + e.snr_to_cqi_offset
        return min(snr_db_to_cqi(snr), e.cqi_max)

    def _build_ul(self, tti: int, sf_idx: int) -> torch.Tensor | None:
        # contention-free RA on the handover target cell
        if self._ho_cf_preamble is not None and sf_idx == self.prach_sf:
            pre = self._ho_cf_preamble
            self._ho_cf_preamble = None
            self._ho_in_progress = True
            self.mac.start_ra(pre)
            self._ra_deadline = tti + 20
            return self._prach_subframe(pre)
        # PRACH occasion (gated on SI when acquisition is on: the UE may
        # not access the cell before SIB2's RACH parameters are known;
        # a camped idle UE accesses only for MO data or an MT page)
        if (self.rrc_state == self.RRC_IDLE and sf_idx == self.prach_sf
                and tti >= self.attach_delay and self._si_ready()
                and (not self.idle_camped or self.ip_tx_queue or self._paged)):
            if self.idle_camped:
                self._resuming = self.nas.sec_ctx is not None
                self.idle_camped = False
                self._paged = False
            self.mac.start_ra(self.preamble)
            self.rrc_state = self.RRC_WAIT_RAR
            self._ra_deadline = tti + 10  # RA response window (proc_ra.cc)
            return self._prach_subframe(self.preamble)
        # RA response window expiry → back to IDLE, retry at next occasion
        if self.rrc_state == self.RRC_WAIT_RAR and tti >= getattr(self, "_ra_deadline", 1 << 62):
            self.rrc_state = self.RRC_IDLE
        acks = self.pending_ack.pop(tti, None)
        grant = self.pending_tx.pop(tti, None)
        retx = self.pending_retx.pop(tti, None)
        if retx is not None and grant is None:
            # non-adaptive HARQ retransmission: same TB, cycled rv
            grant, tb_bits, tx_count = retx
            return self._encode_pusch(tti, sf_idx, grant, tb_bits, tx_count, acks)
        if grant is None:
            if acks:
                from ..phy.phch.pucch import (
                    ACK, DTX, NACK, PucchConfig, tdd_channel_selection)

                das = tdd.das_set(self.tdd, tti % 10) if self.tdd is not None else ()
                if self.tdd is not None and 1 < len(das) <= 4:
                    # HARQ-ACK multiplexing with channel selection (PUCCH
                    # 1b, TS 36.213 Tables 10.1.3-2/3/4): position i is the
                    # association-set entry k_i; missed grants are DTX
                    states = [DTX] * len(das)
                    resources = [None] * len(das)
                    for cce, bit, dl_tti in acks:
                        i = das.index(tti - dl_tti)
                        states[i] = ACK if bit else NACK
                        # position-dependent resource (TS 36.213 §10.1's
                        # n(1)PUCCH,i spreads by i — same CCE in different
                        # subframes must not collide)
                        resources[i] = cce + 2 * i
                    res_i, (b0, b1) = tdd_channel_selection(states)
                    if resources[res_i] is None:
                        return None  # nothing decodable to anchor on
                    cfgp = PucchConfig(n_pucch=resources[res_i])
                    return ue_ul_encode(self.cell, sf_idx, pucch1=(cfgp, [b0, b1]),
                                        ta_samples=self.ta_samples, device=self.device)
                sc_bit = self.pending_ack_scell.pop(tti, None)
                bit = 1 if all(b for _, b, _t in acks) else 0
                if sc_bit is not None and self.scell_active:
                    # FDD 2-CC ACK multiplexing on PUCCH format 3: both
                    # codebook bits ride ONE dedicated resource
                    # (pucch_proc.c format-3 selection)
                    self.stats["ca_ack_f3_sent"] = self.stats.get(
                        "ca_ack_f3_sent", 0) + 1
                    cfg3 = PucchConfig(n_pucch=_f3_resource(self.crnti))
                    return ue_ul_encode(
                        self.cell, sf_idx,
                        pucch3=(cfg3, np.array([bit, sc_bit], np.uint8),
                                self.crnti),
                        ta_samples=self.ta_samples, device=self.device)
                # FDD single ACK (format 1a) or TDD bundling fallback (M>4)
                cfgp = PucchConfig(n_pucch=acks[-1][0])
                return ue_ul_encode(self.cell, sf_idx, pucch1=(cfgp, [bit]),
                                    ta_samples=self.ta_samples, device=self.device)
            sc_only = self.pending_ack_scell.pop(tti, None)
            if sc_only is not None and self.scell_active:
                # SCell-only ACK occasion: format 3 with the PCell
                # codebook position as NACK/DTX
                self.stats["ca_ack_f3_sent"] = self.stats.get(
                    "ca_ack_f3_sent", 0) + 1
                from ..phy.phch.pucch import PucchConfig as _P3

                return ue_ul_encode(
                    self.cell, sf_idx,
                    pucch3=(_P3(n_pucch=_f3_resource(self.crnti)),
                            np.array([0, sc_only], np.uint8), self.crnti),
                    ta_samples=self.ta_samples, device=self.device)
            if (self.tdd is None and cqi_on_pusch(tti)
                    and self.rrc_state == self.RRC_ACTIVE):
                # periodic CQI/RI on PUCCH format 2 (cc_worker.cc:822
                # set_uci_periodic_cqi): the standing reporting loop when
                # no PUSCH is granted this TTI.  A colliding ACK took the
                # format-1a branch above (simultaneousAckNackAndCQI=false
                # drops the CQI, as the reference does).
                from ..phy.phch.pucch import PucchConfig

                if cqi_report_is_ri(tti) and self.tm >= 3:
                    bits = (1 if getattr(self, "_dl_rank", 1) == 2 else 0,)
                    self.stats["ri_pucch_sent"] = self.stats.get("ri_pucch_sent", 0) + 1
                else:
                    cqi = self._report_cqi()
                    bits = tuple(int(b) for b in np.binary_repr(cqi, 4))
                    if self.tm == 4:
                        pmi = int(getattr(self, "_dl_pmi", 0)) & 3
                        bits = bits + tuple(int(b) for b in np.binary_repr(pmi, 2))
                    self.stats["cqi_pucch_sent"] = self.stats.get("cqi_pucch_sent", 0) + 1
                cfg2 = PucchConfig(n_pucch=_cqi_resource(self.crnti))
                return ue_ul_encode(self.cell, sf_idx,
                                    pucch2=(cfg2, np.array(bits, np.uint8)),
                                    ta_samples=self.ta_samples, device=self.device)
            if _is_srs_sf(self.srs_enabled, self.tdd, tti) and self.rrc_state >= self.RRC_ACTIVE:
                # standalone wideband sounding on the SRS subframe
                return ue_ul_encode(self.cell, sf_idx, srs=(0, self.cell.nof_prb),
                                    ta_samples=self.ta_samples, device=self.device)
            if (_is_sr_sf(self.sr_enabled, self.tdd, tti)
                    and self.rrc_state >= self.RRC_CONNECTED
                    and self._buffer_state() > 0 and not self.pending_tx):
                # scheduling request: on-off keyed PUCCH 1 (proc_sr.cc)
                from ..phy.phch.pucch import PucchConfig

                self.stats["sr_sent"] = self.stats.get("sr_sent", 0) + 1
                return ue_ul_encode(
                    self.cell, sf_idx,
                    pucch1=(PucchConfig(n_pucch=_sr_resource(self.crnti)), []),
                    ta_samples=self.ta_samples, device=self.device)
            return None
        mac_pdu = self._build_ul_mac_pdu(grant.tbs // 8)
        tb_bits = np.unpackbits(np.frombuffer(mac_pdu, np.uint8))
        return self._encode_pusch(tti, sf_idx, grant, tb_bits, 1, acks)

    def _prach_subframe(self, preamble: int) -> torch.Tensor:
        """The preamble at the start of an otherwise empty UL subframe."""
        p = ue_prach_send(self.cell, self.prach_cfg, preamble, device=self.device)
        out = torch.zeros(self.cell.sf_len, dtype=torch.complex64, device=self.device)
        n = min(p.shape[0], self.cell.sf_len)
        out[:n] = p[:n]
        return out

    def _encode_pusch(self, tti: int, sf_idx: int, grant: UlGrant, tb_bits,
                      tx_count: int, acks) -> torch.Tensor:
        uci = None
        want_cqi = ((cqi_on_pusch(tti) or tti in self._apcqi_tx)
                    and self.rrc_state == self.RRC_ACTIVE)
        self._apcqi_tx.discard(tti)
        # CA: an SCell ACK colliding with a PUSCH rides UCI-on-PUSCH,
        # its codebook bit after the PCell's (the eNB expects the same)
        sc_bit = (self.pending_ack_scell.pop(tti, None)
                  if self.scell_active else None)
        if want_cqi or acks or sc_bit is not None:
            from ..phy.phch.pusch import UciCfg

            cqi_bits = ()
            ri_bits = ()
            if want_cqi and self.subband_cqi:
                # higher-layer-configured subband report, aperiodic
                # mode 3-0 (cqi.c:41-75): wideband + N x 2-bit offsets
                from ..phy.phch.uci import (cqi_diff_encode,
                                            cqi_hl_nof_subbands,
                                            cqi_hl_subband_pack)

                wb = self._report_cqi()
                n_sb = cqi_hl_nof_subbands(self.cell.nof_prb)
                sb = getattr(self, "_sb_snr", None)
                if sb is None:
                    diffs = [0] * n_sb
                else:
                    sb_cqis = [snr_db_to_cqi(10 * np.log10(max(float(s),
                                                               1e-12)))
                               for s in sb]
                    diffs = [cqi_diff_encode(c, wb) for c in sb_cqis]
                cqi_bits = tuple(cqi_hl_subband_pack(wb, diffs))
                self.stats["sb_cqi_sent"] = self.stats.get(
                    "sb_cqi_sent", 0) + 1
            elif want_cqi:
                cqi = self._report_cqi()
                cqi_bits = tuple(int(b) for b in np.binary_repr(cqi, 4))
                if self.tm == 4:
                    # aperiodic mode 1-1: wideband PMI rides the CQI report
                    # (TS 36.212 §5.2.2.6; cqi.c codebook index field)
                    pmi = int(getattr(self, "_dl_pmi", 0)) & 3
                    cqi_bits = cqi_bits + tuple(int(b) for b in np.binary_repr(pmi, 2))
                self.stats["cqi_sent"] = self.stats.get("cqi_sent", 0) + 1
                if self.tm >= 3:
                    # rank indicator from the measured channel condition
                    # (cc_worker.cc:566 measurements → RI/PMI feedback)
                    ri_bits = (1 if getattr(self, "_dl_rank", 1) == 2 else 0,)
                    self.stats["ri_sent"] = self.stats.get("ri_sent", 0) + 1
            # ACKs ride the PUSCH as UCI (ue_ul.c uci multiplexing);
            # the SCell codebook bit follows the PCell's
            ack_tuple = tuple(b for _, b, _t in acks or ())
            if sc_bit is not None:
                ack_tuple = ack_tuple + (sc_bit,)
            uci = UciCfg(cqi_bits=cqi_bits, ack=ack_tuple, ri=ri_bits)
        # watch the PHICH for this transmission (ul_harq.cc role)
        self._ul_inflight[self._phich_tti(tti)] = (grant, tb_bits, tx_count)
        srs = None
        if _is_srs_sf(self.srs_enabled, self.tdd, tti) and self.rrc_state >= self.RRC_ACTIVE:
            srs = (0, self.cell.nof_prb)  # wideband sounding, shortened PUSCH
        samples = ue_ul_encode(self.cell, sf_idx, pusch=(grant, tb_bits), uci=uci,
                               ta_samples=self.ta_samples, srs=srs, device=self.device)
        if self.ul_gain_db:
            samples = samples * float(np.float32(10.0 ** (self.ul_gain_db / 20.0)))
        return samples

    def _phr_due(self) -> bool:
        """proc_phr.cc trigger evaluation: periodic timer expiry, or a
        dl-PathlossChange beyond the threshold while prohibit is idle."""
        if self.rrc_state < self.RRC_CONNECTED:
            return False
        tti = self.tti
        trig = tti >= self._phr_next_periodic
        rsrp = getattr(self, "_dl_rsrp_dbfs", None)
        pl = None if rsrp is None else -rsrp  # pathloss ∝ −RSRP
        if pl is not None and self._phr_last_pl is not None:
            if (abs(pl - self._phr_last_pl) > self.phr_db_change
                    and tti >= self._phr_prohibit_until):
                trig = True
        if trig:
            self._phr_next_periodic = tti + self.phr_periodic_tti
            self._phr_prohibit_until = tti + self.phr_prohibit_tti
            if pl is not None:
                self._phr_last_pl = pl
        return trig

    def _build_ul_mac_pdu(self, tb_bytes: int) -> bytes:
        """Assemble one UL MAC PDU (Msg3/BSR/SRB1/DRB mux) — the PHY-free
        seam the TTCN-3-style harness pulls from (apps/ttcn3.py)."""
        # move pending IP packets into the DRB
        while self.ip_tx_queue and self.rrc_state == self.RRC_ACTIVE:
            self.drb_rlc.write_sdu(self.drb_pdcp.write_sdu(self.ip_tx_queue.pop(0)))
        sdus = []
        used = 0
        if self.msg3 is not None:
            sdus.append((LCID_CCCH, self.msg3))
            used += len(self.msg3) + 3
            self.msg3 = None
        from ..stack.mac import LCID_SHORT_BSR, bsr_index

        bs = self._buffer_state()
        sdus.append((LCID_SHORT_BSR, bytes([bsr_index(bs) & 0x3F])))
        used += 4
        if self._phr_due():
            # PH = remaining TPC range above the accumulated UL gain (the
            # digital-domain stand-in for Pcmax − estimated PUSCH power)
            sdus.append((LCID_PHR, bytes([phr_index(20.0 - self.ul_gain_db)])))
            used += 2
            self.stats["phr_sent"] = self.stats.get("phr_sent", 0) + 1
        for lcid, ent in ((LCID_SRB1, self.srb1_rlc), (LCID_DRB1, self.drb_rlc)):
            while used + 8 < tb_bytes:
                pdu = ent.read_pdu(tb_bytes - used - 3)
                if pdu is None:
                    break
                sdus.append((lcid, pdu))
                used += len(pdu) + 3
        return mac_pack(sdus, tb_bytes, ce_sizes=UL_CE_SIZES)


# ---------------------------------------------------------------------------
# Intra-eNB handover coordinator
# ---------------------------------------------------------------------------

class TwoCellEnb:
    """One eNB with two cells and intra-eNB handover (rrc_mobility.cc:
    meas report → target admission → RRCConnectionReconfiguration with
    mobilityControlInfo → CF-RA at the target → source context cleanup).
    The S1 context and GTP-U TEIDs survive the move — no path switch,
    exactly like the reference's intra-eNB case."""

    def __init__(self, cell_a: Cell, cell_b: Cell, mme: Mme, spgw: Spgw, **kw):
        assert cell_a.id != cell_b.id
        self.cells = [
            EnbStack(cell_a, mme, spgw, **kw),
            EnbStack(cell_b, mme, spgw, crnti=0x70, **kw),
        ]
        self.spgw = spgw
        for c in self.cells:
            c.meas_cfg = rrc.make_meas_config(a3_offset_db=-10.0)
            c.on_meas_report = self._on_meas_report
            c.on_ho_complete = self._on_ho_complete
        # both EnbStacks share one enb_id (one S1 association).  Partition
        # the enb_ue_s1ap_id space so the cells never collide, then demux
        # link-delivered PDUs by id ownership; only Paging (S-TMSI keyed,
        # no UE-associated id) fans out to BOTH cells' PCCH — the real eNB
        # pages on every cell of the tracking area but processes
        # UE-associated S1AP on exactly one (rrc_mobility.cc).
        self.cells[1]._next_enb_ue_id = 1 << 16
        if hasattr(mme, "register_enb"):
            mme.register_enb(self.cells[0].enb_id, self._s1ap_route)
        self._ho_src: dict[int, tuple[EnbStack, _EnbUe]] = {}  # target crnti -> source
        self._orphan_ttl: dict[int, int] = {}  # unknown-TEID age-out counters
        self.stats = {"ho_started": 0, "ho_completed": 0}

    def run_tti(self, ul_by_cell) -> list[np.ndarray]:
        self._route_spgw()
        return [c.run_tti(ul) for c, ul in zip(self.cells, ul_by_cell)]

    def _s1ap_route(self, pdu: bytes):
        """Demux MME→eNB S1AP on the shared association: Paging to every
        cell, UE-associated PDUs only to the cell owning the
        enb_ue_s1ap_id (ids are partitioned at construction)."""
        name, ies = s1ap.unpack(pdu)
        if name == "paging":
            for c in self.cells:
                c._s1ap_rx(pdu)
            return
        eid = ies.get("enb_ue_s1ap_id")
        if eid is None:  # ue_context_release_cmd nests the pair
            ids = ies.get("ue_s1ap_ids")
            if isinstance(ids, tuple) and isinstance(ids[1], dict):
                eid = ids[1].get("enb_ue_s1ap_id")
        for c in self.cells:
            if eid in c._by_enb_id:
                c._s1ap_rx(pdu)
                return
        # no owner yet (e.g. inbound S1 ho_request allocates a fresh
        # context): let the primary cell admit it
        self.cells[0]._s1ap_rx(pdu)

    def _route_spgw(self):
        """Central SPGW→cell routing by TEID (each cell's own pump would
        drop packets for the other cell's UEs)."""
        by_teid = {u.dl_teid: u for c in self.cells for u in c.ues.values()}
        requeue = []
        while (pkt := self.spgw.pop_tx()) is not None:
            out = gtpu_unpack(pkt)
            if out is None:
                continue
            hdr, payload = out
            ue = by_teid.get(hdr.teid)
            if ue is not None and ue.rrc_state == EnbStack.RRC_ACTIVE:
                ue.drb_rlc.write_sdu(ue.drb_pdcp.write_sdu(payload))
            elif ue is not None:
                # DRB not (re-)established yet — the SPGW flushes buffered
                # DL at Modify Bearer time, before the reconfiguration
                # completes; ciphering with the pre-SMC entity would
                # corrupt it (same hold as EnbStack._pump_spgw)
                requeue.append(pkt)
            else:
                # unknown TEID (detached / stale session): age out rather
                # than requeue forever
                ttl = self._orphan_ttl.get(hdr.teid, 32) - 1
                if ttl > 0:
                    self._orphan_ttl[hdr.teid] = ttl
                    requeue.append(pkt)
                else:
                    self._orphan_ttl.pop(hdr.teid, None)
        self.spgw.tx_queue.extendleft(reversed(requeue))

    def _on_meas_report(self, src: EnbStack, ue: _EnbUe, results: dict):
        neigh = results.get("meas_result_neigh_cells")
        if not neigh or neigh[0] != "meas_result_list_eutra":
            return
        if any(s is src and old is ue for s, old in self._ho_src.values()):
            return  # HO already in flight for this UE
        target_pci = neigh[1][0]["pci"]
        tgt = next((c for c in self.cells if c.cell.id == target_pci and c is not src), None)
        if tgt is None:
            return
        new_crnti = tgt.prepare_handover_target(ue, HO_CF_PREAMBLE,
                                                src.cipher_alg, src.integ_alg)
        mob = rrc.make_mobility_control(tgt.cell.id, new_crnti, HO_CF_PREAMBLE)
        src._send_srb1(ue, rrc.pack_reconfiguration(mob_ctrl=mob, transaction_id=3))
        self._ho_src[new_crnti] = (src, ue)
        self.stats["ho_started"] += 1

    def _on_ho_complete(self, tgt: EnbStack, ue: _EnbUe):
        ent = self._ho_src.pop(ue.crnti, None)
        if ent is not None:
            src, old = ent
            src._release_ue(old, notify_mme=False)
            self.stats["ho_completed"] += 1

    def get_metrics(self) -> dict:
        m = dict(self.stats)
        for i, c in enumerate(self.cells):
            m[f"cell{i}"] = c.get_metrics()
        return m


def _enb_metrics(self) -> dict:
    m = dict(self.stats)
    m["rrc_state"] = self.rrc_state
    m.update({f"sched_{k}": v for k, v in self.sched.metrics().items()})
    return m


def _ue_metrics(self) -> dict:
    m = dict(self.stats)
    m["rrc_state"] = self.rrc_state
    m["nas_state"] = self.nas.state
    m["ip"] = self.ue_ip
    return m


EnbStack.get_metrics = _enb_metrics
UeStack.get_metrics = _ue_metrics
