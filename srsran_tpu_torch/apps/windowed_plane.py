"""Windowed data planes for the full stack, on the port.

Counterpart of `srsran_tpu/apps/windowed_plane.py`.  The reference's
workers ARE the data plane: every PDSCH/PUSCH subframe flows through the
sf_worker pipeline with N subframes in flight
(`srsenb/src/phy/sf_worker.cc:166`, `srsue/src/phy/cc_worker.cc:214`,
`thread_pool.h:46-77`).  These planes put the windowed engines
(`pipeline_window.Windowed*`) underneath `apps/full_stack.py` the same
way: data-bearing subframes are queued per absolute W-TTI window,
dispatched as ONE device program chain, and realized a few TTIs later.

Timing contract (the analog of the reference's fixed 4-subframe worker
latency): with window W, HARQ feedback for a subframe at TTI t is
exchanged at t + (4 + W) instead of t + 4 — both stack ends are
constructed with the same `harq_delay`, so PUCCH ACK positions, PHICH
positions and retransmission timing stay consistent.  Windows align to
absolute TTI boundaries (`tti % W == W - 1` dispatches), so both ends can
derive the schedule without signaling; decode results are realized
`REALIZE_DELAY` TTIs after dispatch, which always lands before the first
ACK position of the window (boundary + 4 <= first-tti + W + 4).

The subframes a stack submits are tensors on its device; a window stacks
them into one (W, nrx, sf_len) tensor, which the engines take as
device-resident ingest (no host quantisation).

Cross-window HARQ: failed rows' device softbuffers are extracted
(`extract_softbuffer`) and re-attached to the retransmission's window
row keyed by (harq pid, NDI) — LLR combining across retransmissions
without ever leaving the device.
"""

from __future__ import annotations

from collections import deque

import torch

from ..pipeline_window import WindowedEnbUl, WindowedUeDl, WindowedUeDlMimo, extract_softbuffer

REALIZE_DELAY = 4  # TTIs between window dispatch and result realization


def _window_samples(metas, device: torch.device) -> torch.Tensor:
    """The window's subframes as one (W, nrx, sf_len) complex64 tensor on
    the engine's device."""
    return torch.stack([m["samples"] for m in metas]).to(device=device, dtype=torch.complex64)


def _as_rows(samples: torch.Tensor) -> torch.Tensor:
    """One subframe as (nrx, sf_len): a single antenna's (sf_len,) gains the axis."""
    return samples[None] if samples.ndim == 1 else samples


class WindowedUeDlPlane:
    """UE-side PDSCH data plane over `WindowedUeDl`/`WindowedUeDlMimo`.

    `submit` is called from the per-TTI PDCCH handling (the control
    decode stays per TTI, like the reference's dedicated sync thread);
    `flush` dispatches at window boundaries; `poll` returns completed
    decodes as dicts for the stack's deferred completion handler.
    `device=None` means the card.
    """

    def __init__(self, cell, cfi: int = 2, w: int = 4, tm: int = 2,
                 nrx: int = 1, max_iterations: int = 5, device=None,
                 ingest: str = "int8"):
        self.w = w
        self.tm = tm
        self.nrx = nrx
        self.mimo = tm >= 3
        if self.mimo:
            self.engine = WindowedUeDlMimo(cell, cfi=cfi, w=w,
                                           max_iterations=max_iterations,
                                           ingest=ingest, device=device)
        else:
            scheme = "diversity" if (tm == 2 and cell.nof_ports >= 2) else "port0"
            self.engine = WindowedUeDl(cell, cfi=cfi, w=w,
                                       max_iterations=max_iterations,
                                       scheme=scheme, ingest=ingest, device=device)
        self.device = self.engine.device
        self.cell = cell
        self._buf: list[dict] = []
        self._pending: deque = deque()   # (dispatch_tti, PendingWindow, metas)
        self._softbuf: dict = {}         # harq_pid -> (ndi, device block(s))
        self.current_tti = 0   # set by the stack before the PDCCH pass
        self.stats = {"windows": 0, "ttis": 0, "pad": 0, "crc_ko": 0}

    def submit(self, samples: torch.Tensor, sf_idx: int, grant, harq_pid: int, ndi,
               tti: int, dci, fmt: str, cce: int) -> bool:
        """Queue one data subframe ((nrx, sf_len) or (sf_len,) on the
        device); returns True (always accepted — the caller already gated
        on scheme/TBS)."""
        if tti < 0:
            tti = self.current_tti  # submit comes from inside ue_dl's pass
        self._buf.append(dict(samples=_as_rows(samples), sf_idx=sf_idx,
                              grant=grant, harq_pid=harq_pid, ndi=ndi,
                              tti=tti, dci=dci, fmt=fmt, cce=cce, pad=False))
        return True

    def _softbuffer_list(self, metas):
        rows_per_tti = 2 if self.mimo else 1
        entries = [None] * (len(metas) * rows_per_tti)
        for i, m in enumerate(metas):
            st = self._softbuf.get(m["harq_pid"])
            if st is not None and st[0] == m["ndi"] and not m["pad"]:
                if self.mimo:
                    entries[2 * i], entries[2 * i + 1] = st[1]
                else:
                    entries[i] = st[1]
        if all(e is None for e in entries):
            return None
        return entries

    def flush(self, tti: int):
        """Dispatch the buffered subframes at a window boundary.  Windows
        are absolute-TTI aligned; a partially filled window is padded by
        repeating the first real row (pad results are dropped)."""
        if tti % self.w != self.w - 1 or not self._buf:
            return
        metas = list(self._buf)
        self._buf.clear()
        while len(metas) < self.w:
            pad = dict(metas[0])
            pad["pad"] = True
            metas.append(pad)
            self.stats["pad"] += 1
        sfs = [m["sf_idx"] for m in metas]
        grants = [m["grant"] for m in metas]
        soft = self._softbuffer_list(metas)
        p = self.engine.dispatch_window(_window_samples(metas, self.device), sfs, grants,
                                        softbuffer=soft)
        self._pending.append((tti, p, metas))
        self.stats["windows"] += 1

    def poll(self, tti: int) -> list[dict]:
        """Realize windows whose results are due; returns completion
        events (meta + tbs list) in TTI order."""
        out = []
        while self._pending and tti - self._pending[0][0] >= REALIZE_DELAY:
            _disp, p, metas = self._pending.popleft()
            results = self.engine.results(p)
            for i, m in enumerate(metas):
                if m["pad"]:
                    continue
                self.stats["ttis"] += 1
                if self.mimo:
                    (t1, ok1), (t2, ok2), _n = results[i]
                    tbs = [(t1, bool(ok1)), (t2, bool(ok2))]
                    if ok1 and ok2:
                        self._softbuf.pop(m["harq_pid"], None)
                    else:
                        self.stats["crc_ko"] += 1
                        self._softbuf[m["harq_pid"]] = (m["ndi"], (
                            extract_softbuffer(p, 2 * i),
                            extract_softbuffer(p, 2 * i + 1)))
                else:
                    tb, ok, _n = results[i]
                    tbs = [(tb, bool(ok))]
                    if ok:
                        self._softbuf.pop(m["harq_pid"], None)
                    else:
                        self.stats["crc_ko"] += 1
                        self._softbuf[m["harq_pid"]] = (
                            m["ndi"], extract_softbuffer(p, i))
                out.append(dict(m, tbs=tbs))
        return out


class WindowedEnbUlPlane:
    """eNB-side PUSCH data plane over `WindowedEnbUl` (UCI-free data
    TTIs; UCI-bearing subframes stay on the per-TTI chain, as in the
    dynamic pipeline's split).  `device=None` means the card."""

    def __init__(self, cell, w: int = 4, max_iterations: int = 5,
                 device=None):
        self.w = w
        self.engine = WindowedEnbUl(cell, w=w, max_iterations=max_iterations, device=device)
        self.device = self.engine.device
        self._buf: list[dict] = []
        self._pending: deque = deque()
        self.stats = {"windows": 0, "ttis": 0, "pad": 0}

    def submit(self, samples: torch.Tensor, sf_idx: int, grant, rnti: int, tti: int,
               softbuffer=None, tx_count: int = 1) -> bool:
        self._buf.append(dict(samples=_as_rows(samples), sf_idx=sf_idx,
                              grant=grant, rnti=rnti, tti=tti,
                              softbuffer=softbuffer, tx_count=tx_count,
                              pad=False))
        return True

    def flush(self, tti: int):
        if tti % self.w != self.w - 1 or not self._buf:
            return
        metas = list(self._buf)
        self._buf.clear()
        while len(metas) < self.w:
            pad = dict(metas[0])
            pad["pad"] = True
            pad["softbuffer"] = None
            metas.append(pad)
            self.stats["pad"] += 1
        sfs = [m["sf_idx"] for m in metas]
        grants = [m["grant"] for m in metas]
        soft = [m["softbuffer"] for m in metas]
        if all(e is None for e in soft):
            soft = None
        p = self.engine.dispatch_window(_window_samples(metas, self.device), sfs, grants,
                                        softbuffer=soft)
        self._pending.append((tti, p, metas))
        self.stats["windows"] += 1

    def poll(self, tti: int) -> list[dict]:
        out = []
        while self._pending and tti - self._pending[0][0] >= REALIZE_DELAY:
            _disp, p, metas = self._pending.popleft()
            results = self.engine.results(p)
            for i, m in enumerate(metas):
                if m["pad"]:
                    continue
                self.stats["ttis"] += 1
                tb, ok, _n = results[i]
                soft = None if ok else extract_softbuffer(p, i)
                out.append(dict(m, tb=tb, ok=bool(ok), soft=soft))
        return out
