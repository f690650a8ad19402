"""DL-SCH transport-block decode (and host encode), TS 36.212 §5.3.2.

Counterpart of `srsran_tpu/phy/phch/sch.py`: per-codeblock de-rate-match
with filler bits pinned to a strong 0, one batched turbo decode per
distinct codeblock layout, CB CRC24B (when C > 1), reassembly and the TB
CRC24A.  `dlsch_decode_multi_device` writes out a leading batch axis of
subframes: every codeblock of every subframe in a (K, poly) group decodes
in one `turbo_decode`.  It runs its stages, `dlsch_rate_match` and
`dlsch_turbo` per group, then `dlsch_crc`, as the steps `dlsch_steps`
(`graphs.Step`) under the spans `tbd.rate_match`, `tbd.turbo` and
`tbd.crc` (`runtime.trace.span`); the DL entries take the same steps and
replay them as CUDA graphs around the turbo loop.  Its callers decode the
same shapes call after call, so it asks for the turbo loop as CUDA
graphs.  `dlsch_decode` is the per-TB, host-orchestrated decode of the
facades, with HARQ softbuffers, whose group sizes change from TTI to TTI:
its loop runs eagerly.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property, lru_cache

import numpy as np
import torch

from ..common import LTE_CRC24A, LTE_CRC24B
from ..crc import crc_attach_np, crc_check_np, crc_compute, crc_table
from ..fec.cbsegm import CbBlock, CbSegm, cbsegm
from ..fec.rate_match import turbo_rate_match_rx, turbo_rate_match_tx
from ..fec.turbo import turbo_decode, turbo_encode_np
from ...graphs import Step, run

FILLER_LLR = np.float32(-1e4)  # filler bits are known 0 (LLR>0 ⇒ 1)


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
        """Per-codeblock rate-matching output sizes (TS 36.212 §5.1.4.1.2)."""
        c, nq = self.segm.C, self.nof_layers * self.qm
        g_prime = self.g // nq
        gamma = g_prime % c
        e_minus, e_plus = nq * (g_prime // c), nq * int(np.ceil(g_prime / c))
        return [e_minus if i <= c - 1 - gamma else e_plus for i in range(c)]

    @cached_property
    def blocks(self) -> tuple[CbBlock, ...]:
        """Each code block's layout with its E and codeword offset, in order."""
        es = self.e_sizes()
        return tuple(blk._replace(e=e, off=int(off))
                     for blk, e, off in zip(self.segm.blocks, es, np.cumsum([0] + es)))


def dlsch_encode_np(tb_bits: np.ndarray, cfg: TbCoding) -> np.ndarray:
    """Host encoder: TB bits (tbs,) → codeword bits (g,), for stimuli."""
    assert len(tb_bits) == cfg.tbs
    b = crc_attach_np(tb_bits.astype(np.uint8), LTE_CRC24A)
    out = []
    for blk in cfg.blocks:
        cb = np.concatenate([np.zeros(blk.f, np.uint8), b[blk.pos : blk.pos + blk.msg]])
        if blk.crc:
            cb = crc_attach_np(cb, LTE_CRC24B)
        out.append(turbo_rate_match_tx(turbo_encode_np(cb), blk.e, cfg.rv, n_filler=blk.f))
    return np.concatenate(out).astype(np.uint8)


@lru_cache(maxsize=64)
def _cb_groups(cfgs: tuple[TbCoding, ...]):
    """The code blocks of codewords `cfgs` in (K, CRC) groups, in the order
    first met: (((k, poly), ((codeword, CbBlock), ...)), ...), and for each
    codeword the (group, row) of each of its code blocks."""
    groups: dict[tuple[int, int], list] = {}
    where = [[] for _ in cfgs]
    for ci, cfg in enumerate(cfgs):
        for blk in cfg.blocks:
            rows = groups.setdefault((blk.k, blk.poly), [])
            where[ci].append((list(groups).index((blk.k, blk.poly)), len(rows)))
            rows.append((ci, blk))
    return tuple((key, tuple(m)) for key, m in groups.items()), tuple(map(tuple, where))


def dlsch_rate_match(llrs, cfgs, group: int) -> torch.Tensor:
    """TB decode's first stage for (K, CRC) group `group` of the codewords
    `cfgs` (LLRs `llrs`, (B, g_i) each): its code blocks de-rate-matched,
    fillers pinned to a strong 0, as d-stream LLRs (B * ncb, 3, K + 4)."""
    (k, _poly), members = _cb_groups(tuple(cfgs))[0][group]
    rows = []
    for ci, blk in members:
        d = turbo_rate_match_rx(llrs[ci][:, blk.off : blk.off + blk.e], k, cfgs[ci].rv,
                                n_filler=blk.f)
        if blk.f:
            d[:, 0, : blk.f] = float(FILLER_LLR)
        rows.append(d)
    return torch.stack(rows, dim=1).reshape(-1, 3, k + 4)  # (B, ncb, 3, K+4) row by row


def dlsch_turbo(d_llr: torch.Tensor, cfgs, group: int, max_iterations: int = 5) -> torch.Tensor:
    """The second stage: group `group`'s d-stream LLRs turbo-decoded, with
    the CRC stop, into (B * ncb, K) uint8 bits.  Its callers decode the same
    shapes call after call, so the loop replays CUDA graphs from a shape's
    second call (`turbo_decode(graphed=True)`)."""
    (k, poly), _members = _cb_groups(tuple(cfgs))[0][group]
    bits, _post, _n_it = turbo_decode(d_llr, k, max_iterations,
                                      crc_table=crc_table(poly, k, d_llr.device), graphed=True)
    return bits


def dlsch_crc(bits, cfgs):
    """The last stage: each group's bits (B * ncb, K), in group order, to
    [(tb_bits (B, tbs) uint8, ok (B,) bool)] per codeword: the code-block
    CRCs, the reassembly and the TB CRC."""
    groups, where = _cb_groups(tuple(cfgs))
    decoded = []  # per group: (bits (B, ncb, K), ok (B, ncb))
    for ((k, poly), members), group_bits in zip(groups, bits):
        # the CRC over all K bits (message and its CRC) is zero iff it passes
        cb_ok = torch.all(crc_compute(group_bits, poly) == 0, dim=-1)
        decoded.append((group_bits.reshape(-1, len(members), k), cb_ok.reshape(-1, len(members))))
    out = []
    for cfg, rows in zip(cfgs, where):
        cw_bits = torch.cat([decoded[gi][0][:, j, blk.f : blk.k - blk.crc]
                             for (gi, j), blk in zip(rows, cfg.blocks)], dim=-1)
        tb = cw_bits[:, : cfg.tbs]
        tb_ok = torch.all(crc_compute(tb, LTE_CRC24A) == cw_bits[:, cfg.tbs :], dim=-1)
        cw_ok = torch.stack([decoded[gi][1][:, j] for gi, j in rows], dim=-1).all(dim=-1)
        out.append((tb, tb_ok & cw_ok))
    return out


@lru_cache(maxsize=64)
def dlsch_steps(cfgs: tuple[TbCoding, ...], max_iterations: int = 5) -> tuple[Step, ...]:
    """The decode of the codewords `cfgs` as steps (`graphs.Step`) over a
    state that holds their LLRs `llr0`, `llr1`, ... (B, g_i): for each
    (K, CRC) group in turn `dlsch_rate_match` (`tbd.rate_match`, writes
    `d<group>`) and `dlsch_turbo` (`tbd.turbo`, writes `bits<group>`; not a
    graph step: its host reads stay eager, and it replays graphs of its
    own), then `dlsch_crc` (`tbd.crc`), which writes `tb0`, `ok0`, ..."""
    n_groups = len(_cb_groups(cfgs)[0])

    def rate_match(gi):
        return lambda s: {f"d{gi}": dlsch_rate_match([s[f"llr{i}"] for i in range(len(cfgs))],
                                                     cfgs, gi)}

    def decode(gi):
        return lambda s: {f"bits{gi}": dlsch_turbo(s[f"d{gi}"], cfgs, gi, max_iterations)}

    def crc(s):
        out = dlsch_crc([s[f"bits{gi}"] for gi in range(n_groups)], cfgs)
        return {name: v for i, (tb, ok) in enumerate(out) for name, v in ((f"tb{i}", tb),
                                                                          (f"ok{i}", ok))}

    steps = []
    for gi in range(n_groups):
        steps += [Step(("tbd.rate_match",), rate_match(gi)),
                  Step(("tbd.turbo",), decode(gi), graphed=False)]
    return (*steps, Step(("tbd.crc",), crc))


def dlsch_decode_multi_device(llrs, cfgs, max_iterations: int = 5):
    """Decode ≥1 codewords jointly: `dlsch_steps` run eagerly.

    llrs: list of codeword LLRs (B, g_i) float32; cfgs: matching TbCoding.
    Returns [(tb_bits (B, tbs) uint8, ok (B,) bool)] per codeword.
    """
    cfgs = tuple(cfgs)
    state = run(dlsch_steps(cfgs, max_iterations), {f"llr{i}": x for i, x in enumerate(llrs)})
    return [(state[f"tb{i}"], state[f"ok{i}"]) for i in range(len(cfgs))]


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
    blocks = cfg.blocks
    assert blocks[-1].off + blocks[-1].e == cfg.g
    groups: dict[tuple[int, int, int], list[int]] = {}
    for i, blk in enumerate(blocks):
        groups.setdefault((blk.k, blk.e, blk.f), []).append(i)

    new_softbuffers = [None] * len(blocks)
    decoded = [None] * len(blocks)
    ok = [False] * len(blocks)
    for (k, e, f), idxs in groups.items():
        batch = torch.stack([llr[blocks[i].off : blocks[i].off + e] for i in idxs])
        sb = None
        if softbuffers is not None and softbuffers[idxs[0]] is not None:
            sb = torch.stack([softbuffers[i] for i in idxs])
        d_llr = turbo_rate_match_rx(batch, k, cfg.rv, softbuffer=sb, n_filler=f)
        if f:
            d_llr[:, 0, :f] = float(FILLER_LLR)
        poly = blocks[idxs[0]].poly
        bits, _post, _n_it = turbo_decode(d_llr, k, max_iterations,
                                          crc_table=crc_table(poly, k, llr.device))
        bits = bits.cpu().numpy()
        for j, i in enumerate(idxs):
            new_softbuffers[i] = d_llr[j]
            decoded[i] = bits[j]
            ok[i] = crc_check_np(bits[j], poly)

    b = np.concatenate([decoded[i][blk.f : blk.k - blk.crc] for i, blk in enumerate(blocks)])
    tb_ok = all(ok) and crc_check_np(b, LTE_CRC24A)
    return b[:-24].astype(np.uint8), bool(tb_ok), new_softbuffers
