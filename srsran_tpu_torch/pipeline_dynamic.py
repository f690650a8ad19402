"""Dynamic-grant decodes: any per-TTI grant through one object, with a
small, bounded set of shapes.

Counterpart of `DynamicUeDl` (port-0, transmit-diversity and one-codeword
spatial-multiplexing PDSCH grants) and `DynamicEnbUl` (data-only PUSCH
grants) in `srsran_tpu/pipeline_dynamic.py`.  The static path
(`pipeline.py`) fixes the PDSCH RE set, TBS and coding layout when the
decode is built; a live UE sees a new (PRB set, MCS, RV) every TTI.  Here
those are data over bucketed shapes:

1. stage A (per (sf_idx, CRS ports)): OFDM demod + CRS channel estimate —
   grant independent.
2. stage B (per (n_re bucket, modulation, transmit scheme)): padded RE
   gather → equalize → soft demod → CSI weight → descramble → masked LLR
   vector of the fixed length G_MAX.  The RE index vector, its true length
   and the scrambling signs are inputs.
3. stage C (per (K, B, rep) buckets): de-rate-match computed on the device
   from the TB's <= 3 codeblock layout variants, HARQ-combining into the
   softbuffer (`fec/rate_match_dev.py`) → dynamic-K batched turbo decode
   (`fec/turbo_dyn.py`, the MAP kernel's dynamic-K mode) → CRCs and TB
   reassembly by gathers.

Host work per TTI is a ~50-int parameter vector, memoized per grant
signature, and two uploads (the samples and that vector).  Nothing is
compiled: a "stage" is a closure over its device tables, and
`stats["compiles_*"]` count the distinct stage keys built, as the
reference counts its programs.  The buckets fix the softbuffer's shape
and keep every shape static.

The uplink mirrors it: stage A is the SC-FDMA demod (one per cell), stage B
(per (PRB bucket, modulation)) runs the DMRS channel estimate, the MRC
equalizer, the IDFT de-precoding and the de-interleaver over an allocation
padded to the bucket — the allocation's first subcarrier and width, the
DMRS, the IDFT matrix and the de-interleaver are inputs — and stage C is
the downlink's, unchanged.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .device import resolve, table
from .phy.chest.chest_dl import chest_dl
from .phy.chest.chest_ul import dmrs_symbols, time_interp_weights
from .phy.chest.refsignal_ul import pusch_dmrs
from .phy.common import LTE_CRC24A, Cell
from .phy.crc import crc_matrix_np
from .phy.dft_precoding import _dft_matrix
from .phy.fec.cbsegm import F1, F2, cb_size_index, cbsegm
from .phy.fec.rate_match_dev import codeword_d_fill_grouped_dev, ncb_max, qpp_dev
from .phy.fec.turbo_dyn import crc_ok_ab, crc_table_ab, turbo_decode_dyn
from .phy.mimo import (
    layerdemap,
    predecode_diversity2,
    predecode_single_mrc,
    predecode_zf_mmse,
)
from .phy.modem import Mod, demod_soft
from .phy.ofdm import OfdmConfig, ofdm_rx_sf
from .phy.phch.pdsch import DlGrant, pdsch_cinit, pdsch_re_indices
from .phy.phch.pusch import UlGrant, _interleaver_indices, pusch_cinit, pusch_symbols_data
from .phy.phch.sch import FILLER_LLR, TbCoding
from .phy.scrambling import scramble_soft
from .phy.sequence import gold_sequence_signs

K_BUCKETS = (768, 2112, 6144)
B_BUCKETS = (1, 2, 4, 8, 16, 32)
RE_BUCKETS = (1536, 3072, 6144, 9216, 15360)
# every stage B emits this fixed LLR vector length, so stage C keys only on
# (K, B, rep) buckets — the rate-matched length is data
G_MAX = RE_BUCKETS[-1] * 8
# rate-matching repetition-fold buckets: almost every grant folds <= 8x;
# tiny TBs on wide allocations (SIB/paging-style) can repeat hundreds of
# times
REP_BUCKETS = (8, 64, 4096)


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


# ---------------------------------------------------------------------------
# Stage A: grant-independent subframe front end
# ---------------------------------------------------------------------------


def _build_stage_a(cell: Cell, sf_idx: int, nof_ports: int):
    ofdm = OfdmConfig.from_cell(cell, normalize=True)

    def fn(samples):
        rx_grid = ofdm_rx_sf(ofdm, samples)  # (nrx, nsymb, nre)
        res = chest_dl(rx_grid, cell, sf_idx, nof_ports=nof_ports)
        return rx_grid, res["ce"], torch.mean(res["noise"]), torch.mean(res["snr"])

    return fn


# ---------------------------------------------------------------------------
# Stage B: bucketed grant front end (gather → equalize → demod → descramble)
# ---------------------------------------------------------------------------


def _build_stage_b(n_re_max: int, mod: Mod, qm: int, tx_scheme: str, nof_layers: int, pmi: int):
    if tx_scheme not in ("port0", "diversity", "spatialmux"):
        raise NotImplementedError(tx_scheme)
    bits_per_re = qm * (nof_layers if tx_scheme == "spatialmux" else 1)
    g_max = n_re_max * bits_per_re

    def fn(rx_grid, ce, noise, idx_pad, n_re, signs):
        y = rx_grid.reshape(rx_grid.shape[0], -1)[:, idx_pad]  # (nrx, n_re_max)
        h = ce.reshape(ce.shape[0], ce.shape[1], -1)[:, :, idx_pad]
        if tx_scheme == "port0":
            x, csi = predecode_single_mrc(y, h[:, 0], noise)
        elif tx_scheme == "diversity":
            x, csi = predecode_diversity2(y, h)
        else:
            xl, csil = predecode_zf_mmse(y, h, nof_layers, noise, pmi=pmi)
            x, csi = layerdemap(xl, 1)[0], layerdemap(csil, 1)[0]
        llr = demod_soft(mod, x) * torch.repeat_interleave(csi, qm, dim=-1)
        llr = scramble_soft(llr, signs)
        mask = torch.arange(g_max, device=llr.device) < n_re * bits_per_re
        # fixed-size output → stage C keys only on (K, B, rep) buckets
        out = llr.new_zeros((G_MAX,))
        out[:g_max] = torch.where(mask, llr, 0.0)
        return out

    return fn


# ---------------------------------------------------------------------------
# Stage C: bucketed dynamic TB decode
# ---------------------------------------------------------------------------


@lru_cache(maxsize=4096)
def _tb_params_v2(tbs: int, g: int, qm: int, nof_layers: int = 1):
    """Host-side TB layout for stage C: the buckets, the repetition folds
    this TB needs, and a small integer parameter template (rv patched per
    call): [rv, tbs, crcb, k3 x3, f3 x3, f1 x3, f2 x3, cb_e xB, cls xB]."""
    segm = cbsegm(tbs)
    blocks = TbCoding(tbs, g, qm, nof_layers=nof_layers).blocks
    k_bucket = _bucket(max(segm.cb_sizes), K_BUCKETS)
    b_bucket = _bucket(segm.C, B_BUCKETS)
    k_minus = segm.K_minus if segm.C_minus > 0 else 40
    k3 = (segm.cb_sizes[0], k_minus, segm.K_plus if segm.C_plus > 0 else 40)
    f3 = (blocks[0].f, 0, 0)
    rep_need = 1
    tmpl = np.zeros(15 + 2 * b_bucket, np.int64)
    tmpl[1] = tbs
    tmpl[2] = blocks[0].crc > 0
    for v in range(3):
        ki = cb_size_index(k3[v])
        tmpl[3 + v] = k3[v]
        tmpl[6 + v] = f3[v]
        tmpl[9 + v] = F1[ki]
        tmpl[12 + v] = F2[ki]
    for c, blk in enumerate(blocks):
        nv = 3 * (blk.k + 4) - 2 * blk.f
        rep_need = max(rep_need, -(-blk.e // nv))
        tmpl[15 + c] = blk.e
        tmpl[15 + b_bucket + c] = 0 if c == 0 else (1 if blk.k == k_minus else 2)
    rep_bucket = _bucket(rep_need, REP_BUCKETS)
    return k_bucket, b_bucket, rep_bucket, rep_need, k_bucket * b_bucket, tmpl


def _tb_crc_table(tbs_max: int) -> np.ndarray:
    return crc_matrix_np(LTE_CRC24A, tbs_max).astype(np.float32)


def _build_stage_c_v2(k_bucket: int, b_bucket: int, max_iterations: int, rep: int, device):
    """Bucketed dynamic TB decode: the de-rate-match is computed on the
    device from the TB's <= 3 codeblock layout variants
    (`rate_match_dev.codeword_d_fill_grouped_dev`), the QPP interleaves are
    per-row gathers inside `turbo_decode_dyn`, and the CRC rolls and the TB
    reassembly are gathers whose indices come from the parameter vector.
    E is no bucket dimension — the rate-matched length is data."""
    crc_ab = table(crc_table_ab, k_bucket, device=device)
    tbs_max = k_bucket * b_bucket
    tb_table = table(_tb_crc_table, tbs_max, device=device)
    ncb = ncb_max(k_bucket)
    out_pos = torch.arange(tbs_max + 24, device=device)

    def reassemble(bits, f_cb, nbits, tbs):
        """TB bits right-aligned in (tbs_max,) and the 24 received TB-CRC
        bits: codeblock c contributes bits [f_c, f_c + nbits_c) at offset
        base + sum(nbits[:c]); unused slots contribute nothing."""
        bounds = torch.cumsum(nbits, dim=0)
        u = out_pos - (tbs_max - tbs)  # position in the concatenation
        cb = torch.clamp(torch.bucketize(u, bounds, right=True), max=b_bucket - 1)
        local = u - (bounds[cb] - nbits[cb]) + f_cb[cb]
        src = cb * k_bucket + torch.clamp(local, 0, k_bucket - 1)
        scratch = torch.where(u >= 0, bits.reshape(-1)[src], 0)
        return scratch[:tbs_max], scratch[tbs_max:]

    def fn(llr_g, params, softbuffer, folds: int):
        rv, tbs, crcb = params[0], params[1], params[2]
        k3, f3 = params[3:6], params[6:9]
        f13, f23 = params[9:12], params[12:15]
        e_eff = params[15 : 15 + b_bucket]  # 0 for unused slots
        cls = params[15 + b_bucket : 15 + 2 * b_bucket]
        start = torch.cumsum(e_eff, dim=0) - e_eff
        llr_pad = torch.cat([llr_g, llr_g.new_zeros((ncb,))])
        new_soft = softbuffer + codeword_d_fill_grouped_dev(
            llr_pad, start, e_eff, cls, k3, f3, rv, k_bucket, rep, folds)
        cb_k = k3[cls]
        cb_f = f3[cls]
        vf = e_eff > 0
        bf = (crcb > 0).expand(b_bucket)
        # the decoder sees filler bits pinned to a strong 0; the softbuffer
        # handed back is the un-pinned sum
        d = new_soft.clone()
        pin = torch.arange(k_bucket + 4, device=d.device)[None, :] < cb_f[:, None]
        d[:, 0, :] = torch.where(pin, float(FILLER_LLR), d[:, 0, :])
        per3, inv3 = qpp_dev(k3, f13, f23, k_bucket)
        bits, _post, n_it = turbo_decode_dyn(
            d, cb_k, per3[cls], inv3[cls], vf, k_bucket, max_iterations,
            crc_table=crc_ab, crc_is_b=bf)
        cb_ok = crc_ok_ab(bits, cb_k, crc_ab, bf)

        nbits = torch.where(vf, cb_k - cb_f - 24 * crcb, 0)
        tbp, rx_crc = reassemble(bits, cb_f, nbits, tbs)
        crc_calc = (torch.matmul(tbp.to(torch.float32)[None], tb_table)
                    .to(torch.int32)[0] & 1).to(torch.uint8)
        tb_ok = torch.all(cb_ok | ~vf) & torch.all(crc_calc == rx_crc)
        packed = torch.cat([
            tbp,
            tb_ok.to(torch.uint8)[None],
            torch.clamp(torch.max(n_it), 0, 255).to(torch.uint8)[None],
        ])
        return packed, new_soft

    return fn


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


@lru_cache(maxsize=4096)
def _padded_re_indices(cell: Cell, sf_idx: int, cfi: int, prb: tuple[int, ...],
                       tdd: bool = False) -> tuple[np.ndarray, int, int]:
    idx = pdsch_re_indices(cell, sf_idx, cfi, prb, tdd=tdd)
    n_re = len(idx)
    bucket = _bucket(n_re, RE_BUCKETS)
    pad = np.zeros(bucket, np.int64)
    pad[:n_re] = idx
    return pad, n_re, bucket


def _idx_pad(*key) -> np.ndarray:
    return _padded_re_indices(*key)[0]


@dataclasses.dataclass
class PendingTb:
    """A dispatched TB decode whose result has not been read back (device
    tensors).  Created by `decode_async`; realize with the decoder's `result`.
    Keeping results on the device lets a caller hold several TTIs in flight
    and pay the device→host read once per TB."""

    packed: torch.Tensor  # (tbs_max + 2,) uint8: tb bits | ok | n_it
    softbuffer: torch.Tensor
    tbs: int
    tbs_max: int


class _DynamicDecoder:
    """What the two dynamic decoders share: the device, the stage caches
    (counted like the reference's compiles), stage C and the result read."""

    def __init__(self, cell: Cell, max_iterations: int, device):
        self.cell = cell
        self.max_iterations = max_iterations
        self.device = resolve(device)
        self._stage_a: dict = {}
        self._stage_b: dict = {}
        self._stage_c: dict = {}
        self.stats = {"compiles_a": 0, "compiles_b": 0, "compiles_c": 0,
                      "ttis": 0, "crc_ok": 0}

    def _get(self, stage: str, key, build):
        cache = getattr(self, f"_stage_{stage}")
        if key not in cache:
            cache[key] = build()
            self.stats[f"compiles_{stage}"] += 1
        return cache[key]

    def _decode_tb(self, llr, params, tbs: int, layout, softbuffer) -> PendingTb:
        """Stage C on one grant's LLR vector; `layout` is what
        `_tb_params_v2` returned and `params` its template on the device,
        rv patched."""
        kb, bb, rb, folds, tbs_max, _tmpl = layout
        cfn = self._get("c", (kb, bb, rb), lambda: _build_stage_c_v2(
            kb, bb, self.max_iterations, rb, self.device))
        if softbuffer is None:
            softbuffer = torch.zeros((bb, 3, kb + 4), dtype=torch.float32, device=self.device)
        elif softbuffer.device != self.device:
            raise ValueError(f"softbuffer is on {softbuffer.device}, expected {self.device}")
        packed, new_soft = cfn(llr, params, softbuffer, folds)
        return PendingTb(packed, new_soft, tbs, tbs_max)

    def result(self, p: PendingTb):
        """Realize a pending decode: one device→host read."""
        res = p.packed.cpu().numpy()
        tb = res[p.tbs_max - p.tbs : p.tbs_max]
        ok_host = bool(res[p.tbs_max])
        n_it = int(res[p.tbs_max + 1])
        self.stats["ttis"] += 1
        self.stats["crc_ok"] += int(ok_host)
        return tb, ok_host, p.softbuffer, n_it

    def decode(self, samples, sf_idx: int, grant, softbuffer=None):
        """Decode one grant from one subframe of samples.

        samples: (nrx, sf_len) complex64.  Returns
        (tb_bits (tbs,) uint8, crc_ok bool, softbuffer (b_bucket, 3,
        k_bucket+4) float32 tensor, n_iterations int)."""
        return self.result(self.decode_async(samples, sf_idx, grant, softbuffer))

    @property
    def total_compiles(self) -> int:
        return (self.stats["compiles_a"] + self.stats["compiles_b"]
                + self.stats["compiles_c"])


class DynamicUeDl(_DynamicDecoder):
    """Live UE DL data path: any port-0, transmit-diversity or one-codeword
    spatial-multiplexing grant, bounded shapes, HARQ combining.

    `device=None` means the first CUDA device (and raises when there is
    none); the tests pass "cpu"."""

    def __init__(self, cell: Cell, cfi: int = 1, max_iterations: int = 5, *, device=None):
        super().__init__(cell, max_iterations, device)
        self.cfi = cfi

    def decode_async(self, samples, sf_idx: int, grant: DlGrant, softbuffer=None) -> PendingTb:
        """Dispatch one PDSCH grant decode; results stay on the device.

        samples: (nrx, sf_len) complex64, a numpy array or a tensor.
        softbuffer: a (b_bucket, 3, k_bucket+4) float32 tensor on this
        object's device, as an earlier decode returned it, or None."""
        nof_ports = 1 if grant.tx_scheme == "port0" else 2
        a = self._get("a", (sf_idx, nof_ports),
                      lambda: _build_stage_a(self.cell, sf_idx, nof_ports))
        re_key = (self.cell, sf_idx, self.cfi, tuple(grant.prb))
        _, n_re, n_re_max = _padded_re_indices(*re_key)
        idx_dev = table(_idx_pad, *re_key, device=self.device)
        nof_layers = grant.nof_layers if grant.tx_scheme == "spatialmux" else 1
        g = n_re * grant.qm * nof_layers
        bfn = self._get(
            "b", (n_re_max, grant.mod, grant.tx_scheme, grant.nof_layers, grant.pmi),
            lambda: _build_stage_b(n_re_max, grant.mod, grant.qm, grant.tx_scheme,
                                   grant.nof_layers, grant.pmi))
        signs = table(gold_sequence_signs, pdsch_cinit(grant.rnti, sf_idx, self.cell.id),
                      n_re_max * grant.qm * nof_layers, device=self.device)
        layout = _tb_params_v2(grant.tbs, g, grant.qm, nof_layers)
        # two host→device transfers per TTI: the samples, and n_re with the
        # stage-C parameters
        tail = np.concatenate([[n_re], layout[-1]])
        tail[1] = grant.rv
        tail = torch.from_numpy(tail).to(self.device)
        samples = torch.as_tensor(samples, dtype=torch.complex64).to(self.device)

        rx_grid, ce, noise, _snr = a(samples)
        llr = bfn(rx_grid, ce, noise, idx_dev, tail[0], signs)
        return self._decode_tb(llr, tail[1:], grant.tbs, layout, softbuffer)


# ---------------------------------------------------------------------------
# Dynamic eNB UL (PUSCH)
# ---------------------------------------------------------------------------


def _build_stage_a_ul(cell: Cell):
    """Grant-independent SC-FDMA demod (-0.5 subcarrier shift)."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)
    return lambda samples: ofdm_rx_sf(ofdm, samples)


@lru_cache(maxsize=256)
def _ul_dmrs_conj(cell: Cell, nof_prb: int, m_max: int) -> np.ndarray:
    """Conjugated PUSCH DMRS of both slots, zero-padded to m_max: (2, m_max)
    complex64."""
    r = np.zeros((2, m_max), np.complex64)
    for s in range(2):
        r[s, : 12 * nof_prb] = np.conj(pusch_dmrs(cell, nof_prb, 0, s))
    return r


def _idft_padded(m_sc: int, m_max: int) -> np.ndarray:
    """(m_max, m_max) complex64 IDFT block, zero outside the allocation."""
    w = np.zeros((m_max, m_max), np.complex64)
    w[:m_sc, :m_sc] = _dft_matrix(m_sc, True)
    return w


@lru_cache(maxsize=8)
def _idft_padded_on(m_sc: int, m_max: int, device: torch.device) -> torch.Tensor:
    """`_idft_padded` on `device`; up to 11.5 MB each, so only the last few
    allocation widths stay."""
    return torch.from_numpy(_idft_padded(m_sc, m_max)).to(device)


@lru_cache(maxsize=4096)
def _ul_deint_gather(g: int, qm: int, g_max: int) -> np.ndarray:
    """Gather indices (g_max,) that undo the UL channel interleaver — a
    permutation, so the reference's scatter is a gather by the inverse —
    padded with g_max, the slot that holds a zero."""
    out = np.full(g_max, g_max, np.int64)
    out[_interleaver_indices(g, qm)] = np.arange(g)
    return out


def _box5(x: torch.Tensor) -> torch.Tensor:
    """5-tap box sum along the last axis, zeros outside ("same"), as five
    shifted adds in a fixed order."""
    m = x.shape[-1]
    z = x.new_zeros(tuple(x.shape[:-1]) + (2,))
    p = torch.cat([z, x, z], dim=-1)
    out = p[..., 0:m]
    for d in range(1, 5):
        out = out + p[..., d : d + m]
    return out


def _build_stage_b_ul(cell: Cell, m_max: int, mod: Mod, qm: int, device):
    """Bucketed UL grant front end: channel estimate over the (padded)
    allocation → MRC equalize → IDFT de-precoding (the matrix is data: one
    stage for every width of the bucket) → demod → CSI weight → descramble →
    de-interleave."""
    dmrs_syms = list(dmrs_symbols(cell))
    data_syms = pusch_symbols_data(cell)
    nsym = len(data_syms)
    g_blk = nsym * m_max * qm
    # time-interpolation weights between the two DMRS symbols
    t_data = torch.from_numpy(time_interp_weights(cell)[data_syms].astype(np.complex64)).to(device)
    pos = torch.arange(m_max, device=device)
    j = torch.arange(g_blk, device=device)

    def fn(grid, k0: int, m_sc: int, dmrs_conj, idft, signs, deint_idx):
        nrx = grid.shape[0]  # grid (nrx, nsymb, nre)
        # clipped gather, not a slice: allocations near the upper edge of a
        # small bucket overrun the band, and a slice would shift them
        alloc = grid[:, :, torch.clamp(k0 + pos, 0, grid.shape[2] - 1)]
        m_mask = (pos < m_sc)[None, :]
        # --- channel estimate: LS at DMRS, 5-tap masked smoothing, time interp ---
        ls = torch.where(m_mask[None], alloc[:, dmrs_syms, :] * dmrs_conj[None], 0.0)
        wsum = _box5(m_mask[0].to(torch.float32))
        sm = torch.where(m_mask[None], _box5(ls) / torch.clamp(wsum, min=1.0), 0.0)
        resid = torch.where(m_mask[None], ls - sm, 0.0)
        noise = torch.sum(resid.abs() ** 2) / max(2.0 * nrx * m_sc, 1.0)
        ce = torch.einsum("ls,rsn->rln", t_data, sm)  # (nrx, nsym, m_max)
        # --- MRC equalize over rx antennas ---
        y = alloc[:, data_syms, :]
        num = torch.sum(y * torch.conj(ce), dim=0)
        den = torch.sum(ce.abs() ** 2, dim=0) + noise
        xf = torch.where(m_mask, num / den, 0.0)  # (nsym, m_max)
        csi = torch.where(m_mask, den, 0.0)
        # --- IDFT de-precoding as a data product ---
        x = torch.matmul(xf, idft)
        llr = demod_soft(mod, x.reshape(-1))  # (nsym*m_max*qm,) padded layout
        csi_t = torch.sum(csi, dim=-1, keepdim=True) / max(float(m_sc), 1.0)
        llr = llr * torch.repeat_interleave(csi_t.expand(nsym, m_max).reshape(-1), qm)
        # compact (sym, m_max, qm) → (sym, m_sc, qm): codeword entry j reads
        # its padded position; the tail beyond the true G reads the zero slot
        true_pos = (j // (m_sc * qm)) * (m_max * qm) + j % (m_sc * qm)
        llr_c = torch.cat([llr, llr.new_zeros((1,))])[
            torch.where(j < nsym * m_sc * qm, true_pos, g_blk)]
        # scrambling and interleaving act on the compact codeword order
        llr_c = scramble_soft(llr_c, signs)
        out = torch.cat([llr_c, llr_c.new_zeros((G_MAX + 1 - g_blk,))])[deint_idx]
        return out, noise

    return fn


class DynamicEnbUl(_DynamicDecoder):
    """Live eNB UL data path: any data-only PUSCH grant with bounded shapes
    and HARQ combining — the UL mirror of `DynamicUeDl`.

    `device=None` means the first CUDA device (and raises when there is
    none); the tests pass "cpu"."""

    PRB_BUCKETS = (16, 40, 75, 100)

    def __init__(self, cell: Cell, max_iterations: int = 5, *, device=None):
        super().__init__(cell, max_iterations, device)
        self._nsym = len(pusch_symbols_data(cell))

    def decode_async(self, samples, sf_idx: int, grant: UlGrant, softbuffer=None) -> PendingTb:
        """Dispatch one PUSCH grant decode; results stay on the device.

        samples: (nrx, sf_len) complex64, a numpy array or a tensor."""
        a = self._get("a", (), lambda: _build_stage_a_ul(self.cell))
        m_max = 12 * _bucket(grant.nof_prb, self.PRB_BUCKETS)
        m_sc = 12 * grant.nof_prb
        qm = grant.qm
        g = self._nsym * m_sc * qm
        bfn = self._get("b", (m_max, grant.mod),
                        lambda: _build_stage_b_ul(self.cell, m_max, grant.mod, qm, self.device))
        signs = table(gold_sequence_signs, pusch_cinit(grant.rnti, sf_idx, self.cell.id),
                      self._nsym * m_max * qm, device=self.device)
        layout = _tb_params_v2(grant.tbs, g, qm, 1)
        # two host→device transfers per TTI: the samples and the stage-C
        # parameters; the allocation's start and width are host integers
        params = layout[-1].copy()
        params[0] = grant.rv
        params = torch.from_numpy(params).to(self.device)
        samples = torch.as_tensor(samples, dtype=torch.complex64).to(self.device)

        llr, _noise = bfn(
            a(samples), grant.prb_start * 12, m_sc,
            table(_ul_dmrs_conj, self.cell, grant.nof_prb, m_max, device=self.device),
            _idft_padded_on(m_sc, m_max, self.device), signs,
            table(_ul_deint_gather, g, qm, G_MAX, device=self.device))
        return self._decode_tb(llr, params, grant.tbs, layout, softbuffer)
