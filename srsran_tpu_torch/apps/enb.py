"""eNB application: MAC-lite scheduler + PHY DL transmitter.

Counterpart of `srsran_tpu/apps/enb.py`, the in-process analog of `srsenb`
(txrx.cc TTI loop + the scheduler's RR metric, scheduler_metric.h:29): each
TTI, pull pending SDUs from the bearer queue, pack a MAC PDU into the
largest TBS that fits, schedule it by DCI 1A, and render the subframe
(`enb_dl_subframe`: host grid, OFDM on the device).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..device import resolve
from ..phy.common import Cell
from ..phy.enb.enb_dl import DlSched, enb_dl_subframe
from ..phy.phch.dci import Dci1A
from ..phy.phch.pbch import Mib
from ..phy.phch.pdcch import nof_cce, search_space_candidates
from ..phy.phch.pdsch import DlGrant, pdsch_nof_re
from ..phy.phch.ra import dl_mcs_to_mod, dl_tbs, riv_encode
from ..runtime import MacPcap, get_logger
from ..stack.mac_pdu import LCID_DTCH, mac_pack


class EnbApp:
    """`device=None` is the card (raises where there is none)."""

    def __init__(self, cell: Cell, rnti: int = 0x46, mcs: int = 7, cfi: int = 2,
                 pcap_path: str | None = None, *, device=None):
        self.device = resolve(device)
        self.cell = cell
        self.rnti = rnti
        self.mcs = mcs
        self.cfi = cfi
        self.tti = 0
        self.tx_queue: deque[bytes] = deque()
        self.log = get_logger("enb")
        self.pcap = MacPcap(pcap_path) if pcap_path else None
        self.mib = Mib(nof_prb=cell.nof_prb)
        self.stats = {"tx_tbs": 0, "tx_bytes": 0}

    def write_sdu(self, data: bytes):
        """GW-side input (the srsenb gtpu→pdcp→rlc→mac path, flattened)."""
        self.tx_queue.append(data)

    def _pick_mcs(self, sf_idx: int, l_crb: int) -> int | None:
        """Largest MCS ≤ the configured one whose code rate fits the
        subframe's REs (sf 0/5 lose PBCH/PSS/SSS REs; scheduler_grid.cc)."""
        n_re = pdsch_nof_re(self.cell, sf_idx, self.cfi, tuple(range(l_crb)))
        for mcs in range(self.mcs, -1, -1):
            qm = dl_mcs_to_mod(mcs).bits_per_symbol
            if (dl_tbs(mcs, l_crb) + 24) / (n_re * qm) <= 0.75:
                return mcs
        return None

    def _schedule(self, sf_idx: int) -> DlSched:
        sched = DlSched(cfi=self.cfi)
        if not self.tx_queue:
            return sched
        l_crb = self.cell.nof_prb
        mcs = self._pick_mcs(sf_idx, l_crb)
        if mcs is None:
            return sched
        tbs_bits = dl_tbs(mcs, l_crb)
        tb_bytes = tbs_bits // 8
        sdus = []
        used = 0
        while self.tx_queue and used + len(self.tx_queue[0]) + 3 <= tb_bytes:
            sdu = self.tx_queue.popleft()
            sdus.append((LCID_DTCH, sdu))
            used += len(sdu) + 3
        if not sdus:
            return sched
        pdu = mac_pack(sdus, tb_bytes)
        tb_bits = np.unpackbits(np.frombuffer(pdu, np.uint8))
        tb_bits = np.concatenate([tb_bits, np.zeros(tbs_bits - len(tb_bits), np.uint8)])
        dci = Dci1A(riv=riv_encode(self.cell.nof_prb, 0, l_crb), mcs=mcs, ndi=1)
        cands = search_space_candidates(self.rnti, sf_idx, nof_cce(self.cell, sf_idx, self.cfi))
        agg = max(cands)
        grant = DlGrant(prb=tuple(range(l_crb)), mod=dl_mcs_to_mod(mcs), tbs=tbs_bits,
                        rnti=self.rnti)
        sched.dcis.append((dci.pack(self.cell.nof_prb), self.rnti, agg, cands[agg][0]))
        sched.grants.append((grant, tb_bits))
        self.stats["tx_tbs"] += 1
        self.stats["tx_bytes"] += sum(len(s) for _, s in sdus)
        if self.pcap:
            self.pcap.write_pdu(pdu, self.rnti, sfn=self.tti // 10, sf_idx=sf_idx)
        self.log.debug(f"tti {self.tti}: scheduled {len(sdus)} SDUs in TBS {tbs_bits}")
        return sched

    def run_tti(self) -> torch.Tensor:
        """One subframe of port-0 samples (sf_len,) complex64 on the device
        (the txrx.cc:90 master loop body)."""
        sf_idx = self.tti % 10
        sched = self._schedule(sf_idx)
        _, samples = enb_dl_subframe(self.cell, sf_idx, sched, mib=self.mib,
                                     sfn=(self.tti // 10) % 1024, device=self.device)
        self.tti += 1
        return samples[0]

    def get_metrics(self) -> dict:
        return dict(self.stats)
