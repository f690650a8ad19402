"""UE application: sync + DL receive + MAC-lite demux.

Counterpart of `srsran_tpu/apps/ue.py`, the in-process analog of `srsue`
(sync thread + cc_worker + MAC demux): raw samples go into `UeSync`, each
aligned subframe through `ue_dl_decode_subframe` on the device, and the
SDUs of the CRC-passing MAC PDUs into the GW-side queue.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..device import resolve
from ..phy.common import Cell
from ..phy.ue.ue_dl import ue_dl_decode_subframe
from ..phy.ue.ue_sync import UeSync
from ..runtime import MacPcap, get_logger
from ..stack.mac_pdu import LCID_DTCH, mac_unpack


class UeApp:
    """`device=None` is the card (raises where there is none)."""

    def __init__(self, nof_prb: int = 6, rnti: int = 0x46, cfi: int | None = None,
                 pcap_path: str | None = None, *, device=None):
        self.device = resolve(device)
        self.rnti = rnti
        self.cfi = cfi
        self.sync = UeSync(nof_prb=nof_prb, device=self.device)
        self.rx_queue: deque[bytes] = deque()
        self.log = get_logger("ue")
        self.pcap = MacPcap(pcap_path, ue_id=1) if pcap_path else None
        self.stats = {"rx_tbs": 0, "rx_tbs_ok": 0, "rx_bytes": 0, "in_sync": 0}

    @property
    def cell(self) -> Cell | None:
        return self.sync.cell

    def push_samples(self, samples):
        """Raw samples, numpy or a tensor."""
        self.sync.push(samples)

    def process(self, max_subframes: int = 10**9) -> int:
        """Drain available subframes; returns the number processed."""
        n = 0
        while n < max_subframes:
            out = self.sync.pop_subframe()
            if out is None:
                break
            sf, sf_idx = out
            n += 1
            if self.sync.cell is None:
                continue
            self.stats["in_sync"] = 1
            res = ue_dl_decode_subframe(self.sync.cell, sf[None], sf_idx, self.rnti,
                                        known_cfi=self.cfi, device=self.device)
            for tb, ok in res.tbs:
                self.stats["rx_tbs"] += 1
                if not ok:
                    self.log.warning(f"sf {sf_idx}: TB CRC KO")
                    continue
                self.stats["rx_tbs_ok"] += 1
                pdu = np.packbits(tb).tobytes()
                if self.pcap:
                    self.pcap.write_pdu(pdu, self.rnti, sf_idx=sf_idx)
                for lcid, sdu in mac_unpack(pdu):
                    if lcid == LCID_DTCH:
                        self.rx_queue.append(sdu)
                        self.stats["rx_bytes"] += len(sdu)
        return n

    def read_sdu(self) -> bytes | None:
        return self.rx_queue.popleft() if self.rx_queue else None

    def get_metrics(self) -> dict:
        return dict(self.stats)
