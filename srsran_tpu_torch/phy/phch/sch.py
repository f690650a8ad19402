"""DL-SCH transport-block decode (and host encode), TS 36.212 §5.3.2.

Counterpart of `srsran_tpu/phy/phch/sch.py`: per-codeblock de-rate-match
with filler bits pinned to a strong 0, one batched turbo decode per
distinct codeblock layout, CB CRC24B (when C > 1), reassembly and the TB
CRC24A.  `dlsch_decode_multi_device` writes out a leading batch axis of
subframes: every codeblock of every subframe in a (K, poly) group decodes
in one `turbo_decode`, its stages marked by the spans `tbd.rate_match`,
`tbd.turbo` and `tbd.crc` (`runtime.trace.span`); its callers decode the
same shapes call after call, so it asks for the turbo loop as CUDA
graphs.  `dlsch_decode` is the per-TB, host-orchestrated decode of the
facades, with HARQ softbuffers, whose group sizes change from TTI to TTI:
its loop runs eagerly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common import LTE_CRC24A, LTE_CRC24B
from ..crc import crc_attach_np, crc_check_np, crc_compute, crc_table
from ..fec.cbsegm import CbSegm, cbsegm
from ..fec.rate_match import turbo_rate_match_rx, turbo_rate_match_tx
from ..fec.turbo import turbo_decode, turbo_encode_np
from ...runtime.trace import span

FILLER_LLR = np.float32(-1e4)  # filler bits are known 0 (LLR>0 ⇒ 1)


def _e_split(g: int, c: int, qm: int, nof_layers: int = 1) -> list[int]:
    """Per-codeblock rate-matching output sizes (TS 36.212 §5.1.4.1.2)."""
    g_prime = g // (nof_layers * qm)
    gamma = g_prime % c
    e_minus = nof_layers * qm * (g_prime // c)
    e_plus = nof_layers * qm * int(np.ceil(g_prime / c))
    return [e_minus if i <= c - 1 - gamma else e_plus for i in range(c)]


@dataclasses.dataclass(frozen=True)
class TbCoding:
    """Static coding layout for one transport block."""

    tbs: int
    g: int  # total bits available on the channel
    qm: int  # modulation order (2/4/6/8)
    rv: int = 0
    nof_layers: int = 1

    @property
    def segm(self) -> CbSegm:
        return cbsegm(self.tbs)

    def e_sizes(self) -> list[int]:
        return _e_split(self.g, self.segm.C, self.qm, self.nof_layers)


def dlsch_encode_np(tb_bits: np.ndarray, cfg: TbCoding) -> np.ndarray:
    """Host encoder: TB bits (tbs,) → codeword bits (g,), for stimuli."""
    s = cfg.segm
    assert len(tb_bits) == cfg.tbs
    b = crc_attach_np(tb_bits.astype(np.uint8), LTE_CRC24A)
    cbs = []
    pos = 0
    for i, k in enumerate(s.cb_sizes):
        f = s.F if i == 0 else 0
        take = k - f - (24 if s.C > 1 else 0)
        cb = np.concatenate([np.zeros(f, np.uint8), b[pos : pos + take]])
        pos += take
        cbs.append(crc_attach_np(cb, LTE_CRC24B) if s.C > 1 else cb)
    assert pos == len(b)
    es = cfg.e_sizes()
    out = [turbo_rate_match_tx(turbo_encode_np(cb), es[i], cfg.rv,
                               n_filler=s.F if i == 0 else 0)
           for i, cb in enumerate(cbs)]
    return np.concatenate(out).astype(np.uint8)


def dlsch_decode_multi_device(llrs, cfgs, max_iterations: int = 5):
    """Decode ≥1 codewords jointly.

    llrs: list of codeword LLRs (B, g_i) float32; cfgs: matching TbCoding.
    Returns [(tb_bits (B, tbs) uint8, ok (B,) bool)] per codeword.
    """
    # (codeword, cb index, k, e, f, codeword offset, crc poly)
    groups: dict[tuple[int, int], list[tuple]] = {}
    with span("tbd.rate_match"):
        for ci, cfg in enumerate(cfgs):
            s = cfg.segm
            es = cfg.e_sizes()
            offs = np.concatenate([[0], np.cumsum(es)])
            poly = LTE_CRC24B if s.C > 1 else LTE_CRC24A
            for i, k in enumerate(s.cb_sizes):
                f = s.F if i == 0 else 0
                groups.setdefault((k, poly), []).append((ci, i, es[i], f, int(offs[i])))

    decoded: dict[tuple[int, int], torch.Tensor] = {}
    ok: dict[tuple[int, int], torch.Tensor] = {}
    for (k, poly), ents in groups.items():
        with span("tbd.rate_match"):
            rows = []
            for ci, _i, e, f, off in ents:
                d = turbo_rate_match_rx(llrs[ci][:, off : off + e], k, cfgs[ci].rv, n_filler=f)
                if f:
                    d[:, 0, :f] = float(FILLER_LLR)
                rows.append(d)
            d_llr = torch.stack(rows, dim=1)  # (B, ncb, 3, K+4)
        b, ncb = d_llr.shape[:2]
        with span("tbd.turbo"):
            bits, _post, _n_it = turbo_decode(d_llr.reshape(b * ncb, 3, k + 4), k,
                                              max_iterations,
                                              crc_table=crc_table(poly, k, d_llr.device),
                                              graphed=True)
        with span("tbd.crc"):
            # the CRC over all K bits (message and its CRC) is zero iff it passes
            cb_ok = torch.all(crc_compute(bits, poly) == 0, dim=-1)
            bits, cb_ok = bits.reshape(b, ncb, k), cb_ok.reshape(b, ncb)
            for j, (ci, i, *_rest) in enumerate(ents):
                decoded[(ci, i)] = bits[:, j]
                ok[(ci, i)] = cb_ok[:, j]

    out = []
    with span("tbd.crc"):
        for ci, cfg in enumerate(cfgs):
            s = cfg.segm
            crc_len = 24 if s.C > 1 else 0
            parts = [decoded[(ci, i)][:, (s.F if i == 0 else 0) : k - crc_len]
                     for i, k in enumerate(s.cb_sizes)]
            bits = torch.cat(parts, dim=-1)
            tb = bits[:, : cfg.tbs]
            tb_ok = torch.all(crc_compute(tb, LTE_CRC24A) == bits[:, cfg.tbs :], dim=-1)
            cw_ok = torch.stack([ok[(ci, i)] for i in range(s.C)], dim=-1).all(dim=-1)
            out.append((tb, tb_ok & cw_ok))
    return out


def dlsch_decode_device(llr: torch.Tensor, cfg: TbCoding, max_iterations: int = 5):
    """Decode one codeword: LLRs (B, g) → (tb_bits (B, tbs) uint8, ok (B,) bool)."""
    return dlsch_decode_multi_device([llr], [cfg], max_iterations)[0]


def dlsch_decode(llr: torch.Tensor, cfg: TbCoding, max_iterations: int = 5, softbuffers=None):
    """Decode one TB from its codeword LLRs (g,) float32 (positive ⇒ bit 1),
    on their device.

    Codeblocks are grouped by (K, E, F); each group is de-rate-matched into
    its HARQ softbuffers (when given) and turbo-decoded in one batch.  The CRC
    checks and desegmentation run on the host.  `softbuffers`: None, or one
    (3, K+4) tensor (or None) per codeblock, as an earlier call returned
    them.  Returns (tb_bits (tbs,) uint8 numpy, crc_ok bool, softbuffers)."""
    s = cfg.segm
    es = cfg.e_sizes()
    offsets = np.concatenate([[0], np.cumsum(es)]).astype(int)
    assert offsets[-1] == cfg.g
    groups: dict[tuple[int, int, int], list[int]] = {}
    for i, k in enumerate(s.cb_sizes):
        groups.setdefault((k, es[i], s.F if i == 0 else 0), []).append(i)

    new_softbuffers = [None] * s.C
    decoded = [None] * s.C
    ok = [False] * s.C
    crc_poly = LTE_CRC24B if s.C > 1 else LTE_CRC24A
    for (k, e, f), idxs in groups.items():
        batch = torch.stack([llr[offsets[i] : offsets[i] + e] for i in idxs])
        sb = None
        if softbuffers is not None and softbuffers[idxs[0]] is not None:
            sb = torch.stack([softbuffers[i] for i in idxs])
        d_llr = turbo_rate_match_rx(batch, k, cfg.rv, softbuffer=sb, n_filler=f)
        if f:
            d_llr[:, 0, :f] = float(FILLER_LLR)
        bits, _post, _n_it = turbo_decode(d_llr, k, max_iterations,
                                          crc_table=crc_table(crc_poly, k, llr.device))
        bits = bits.cpu().numpy()
        for j, i in enumerate(idxs):
            new_softbuffers[i] = d_llr[j]
            decoded[i] = bits[j]
            ok[i] = crc_check_np(bits[j], crc_poly)

    crc_len = 24 if s.C > 1 else 0
    b = np.concatenate([decoded[i][(s.F if i == 0 else 0) : k - crc_len]
                        for i, k in enumerate(s.cb_sizes)])
    tb_ok = all(ok) and crc_check_np(b, LTE_CRC24A)
    return b[:-24].astype(np.uint8), bool(tb_ok), new_softbuffers
