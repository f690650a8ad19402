"""Dynamic-grant UE DL decode: any per-TTI grant through one object, with
a small, bounded set of shapes.

Counterpart of `DynamicUeDl` in `srsran_tpu/pipeline_dynamic.py` (port-0
grants).  The static path (`pipeline.py`) fixes the PDSCH RE set, TBS and
coding layout when the decode is built; a live UE sees a new (PRB set,
MCS, RV) every TTI.  Here those are data over bucketed shapes:

1. stage A (per sf_idx): OFDM demod + CRS channel estimate — grant
   independent.
2. stage B (per (n_re bucket, modulation)): padded RE gather → MRC
   equalize → soft demod → CSI weight → descramble → masked LLR vector of
   the fixed length G_MAX.  The RE index vector, its true length and the
   scrambling signs are inputs.
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
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .device import require_cuda, table
from .phy.chest.chest_dl import chest_dl
from .phy.common import LTE_CRC24A, Cell
from .phy.crc import crc_matrix_np
from .phy.fec.cbsegm import F1, F2, cb_size_index, cbsegm
from .phy.fec.rate_match_dev import codeword_d_fill_grouped_dev, ncb_max, qpp_dev
from .phy.fec.turbo_dyn import crc_ok_ab, crc_table_ab, turbo_decode_dyn
from .phy.mimo import predecode_single_mrc
from .phy.modem import Mod, demod_soft
from .phy.ofdm import OfdmConfig, ofdm_rx_sf
from .phy.phch.pdsch import DlGrant, pdsch_cinit, pdsch_re_indices
from .phy.phch.sch import FILLER_LLR, _e_split
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


def _build_stage_a(cell: Cell, sf_idx: int):
    ofdm = OfdmConfig.from_cell(cell, normalize=True)

    def fn(samples):
        rx_grid = ofdm_rx_sf(ofdm, samples)  # (nrx, nsymb, nre)
        res = chest_dl(rx_grid, cell, sf_idx, nof_ports=1)
        return rx_grid, res["ce"], torch.mean(res["noise"]), torch.mean(res["snr"])

    return fn


# ---------------------------------------------------------------------------
# Stage B: bucketed grant front end (gather → equalize → demod → descramble)
# ---------------------------------------------------------------------------


def _build_stage_b(n_re_max: int, mod: Mod, qm: int, tx_scheme: str):
    if tx_scheme != "port0":
        raise NotImplementedError(f"tx_scheme {tx_scheme!r} is not ported")
    g_max = n_re_max * qm

    def fn(rx_grid, ce, noise, idx_pad, n_re, signs):
        y = rx_grid.reshape(rx_grid.shape[0], -1)[:, idx_pad]  # (nrx, n_re_max)
        h = ce[:, 0].reshape(ce.shape[0], -1)[:, idx_pad]
        x, csi = predecode_single_mrc(y, h, noise)
        llr = demod_soft(mod, x) * torch.repeat_interleave(csi, qm, dim=-1)
        llr = scramble_soft(llr, signs)
        mask = torch.arange(g_max, device=llr.device) < n_re * qm
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
    es = _e_split(g, segm.C, qm, nof_layers)
    k_bucket = _bucket(max(segm.cb_sizes), K_BUCKETS)
    b_bucket = _bucket(segm.C, B_BUCKETS)
    k_minus = segm.K_minus if segm.C_minus > 0 else 40
    k3 = (segm.cb_sizes[0], k_minus, segm.K_plus if segm.C_plus > 0 else 40)
    f3 = (segm.F, 0, 0)
    rep_need = 1
    tmpl = np.zeros(15 + 2 * b_bucket, np.int64)
    tmpl[1] = tbs
    tmpl[2] = 1 if segm.C > 1 else 0
    for v in range(3):
        ki = cb_size_index(k3[v])
        tmpl[3 + v] = k3[v]
        tmpl[6 + v] = f3[v]
        tmpl[9 + v] = F1[ki]
        tmpl[12 + v] = F2[ki]
    for c, k in enumerate(segm.cb_sizes):
        f = segm.F if c == 0 else 0
        nv = 3 * (k + 4) - 2 * f
        rep_need = max(rep_need, -(-es[c] // nv))
        tmpl[15 + c] = es[c]
        tmpl[15 + b_bucket + c] = 0 if c == 0 else (1 if k == k_minus else 2)
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
def _padded_re_indices(cell: Cell, sf_idx: int, cfi: int,
                       prb: tuple[int, ...]) -> tuple[np.ndarray, int, int]:
    idx = pdsch_re_indices(cell, sf_idx, cfi, prb)
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
    tensors).  Created by `decode_async`; realize with `DynamicUeDl.result`.
    Keeping results on the device lets a caller hold several TTIs in flight
    and pay the device→host read once per TB."""

    packed: torch.Tensor  # (tbs_max + 2,) uint8: tb bits | ok | n_it
    softbuffer: torch.Tensor
    tbs: int
    tbs_max: int


class DynamicUeDl:
    """Live UE DL data path: any port-0 grant, bounded shapes, HARQ combining.

    `device=None` means the first CUDA device (and raises when there is
    none); the tests pass "cpu"."""

    def __init__(self, cell: Cell, cfi: int = 1, max_iterations: int = 5, *, device=None):
        self.cell = cell
        self.cfi = cfi
        self.max_iterations = max_iterations
        dev = require_cuda() if device is None else torch.device(device)
        # with its index ("cuda" → "cuda:0"), as tensors report it
        self.device = torch.empty(0, device=dev).device
        self._stage_a: dict = {}
        self._stage_b: dict = {}
        self._stage_c: dict = {}
        self.stats = {"compiles_a": 0, "compiles_b": 0, "compiles_c": 0,
                      "ttis": 0, "crc_ok": 0}

    # -- stage caches (counted like the reference's compiles) --
    def _get_a(self, sf_idx: int):
        if sf_idx not in self._stage_a:
            self._stage_a[sf_idx] = _build_stage_a(self.cell, sf_idx)
            self.stats["compiles_a"] += 1
        return self._stage_a[sf_idx]

    def _get_b(self, n_re_max: int, grant: DlGrant):
        key = (n_re_max, grant.mod, grant.tx_scheme, grant.nof_layers, grant.pmi)
        if key not in self._stage_b:
            self._stage_b[key] = _build_stage_b(n_re_max, grant.mod, grant.qm, grant.tx_scheme)
            self.stats["compiles_b"] += 1
        return self._stage_b[key]

    def _get_c(self, k_bucket: int, b_bucket: int, rep: int):
        key = (k_bucket, b_bucket, rep)
        if key not in self._stage_c:
            self._stage_c[key] = _build_stage_c_v2(
                k_bucket, b_bucket, self.max_iterations, rep, self.device)
            self.stats["compiles_c"] += 1
        return self._stage_c[key]

    def decode_async(self, samples, sf_idx: int, grant: DlGrant, softbuffer=None) -> PendingTb:
        """Dispatch one PDSCH grant decode; results stay on the device.

        samples: (nrx, sf_len) complex64, a numpy array or a tensor.
        softbuffer: a (b_bucket, 3, k_bucket+4) float32 tensor on this
        object's device, as an earlier decode returned it, or None."""
        a = self._get_a(sf_idx)
        re_key = (self.cell, sf_idx, self.cfi, tuple(grant.prb))
        _, n_re, n_re_max = _padded_re_indices(*re_key)
        idx_dev = table(_idx_pad, *re_key, device=self.device)
        g = n_re * grant.qm
        bfn = self._get_b(n_re_max, grant)
        signs = table(gold_sequence_signs, pdsch_cinit(grant.rnti, sf_idx, self.cell.id),
                      n_re_max * grant.qm, device=self.device)
        kb, bb, rb, folds, tbs_max, tmpl = _tb_params_v2(grant.tbs, g, grant.qm)
        # two host→device transfers per TTI: the samples, and n_re with the
        # stage-C parameters
        tail = np.concatenate([[n_re], tmpl])
        tail[1] = grant.rv
        tail = torch.from_numpy(tail).to(self.device)
        samples = torch.as_tensor(samples, dtype=torch.complex64).to(self.device)

        rx_grid, ce, noise, _snr = a(samples)
        llr = bfn(rx_grid, ce, noise, idx_dev, tail[0], signs)
        cfn = self._get_c(kb, bb, rb)
        if softbuffer is None:
            softbuffer = torch.zeros((bb, 3, kb + 4), dtype=torch.float32, device=self.device)
        elif softbuffer.device != self.device:
            raise ValueError(f"softbuffer is on {softbuffer.device}, expected {self.device}")
        packed, new_soft = cfn(llr, tail[1:], softbuffer, folds)
        return PendingTb(packed, new_soft, grant.tbs, tbs_max)

    def result(self, p: PendingTb):
        """Realize a pending decode: one device→host read."""
        res = p.packed.cpu().numpy()
        tb = res[p.tbs_max - p.tbs : p.tbs_max]
        ok_host = bool(res[p.tbs_max])
        n_it = int(res[p.tbs_max + 1])
        self.stats["ttis"] += 1
        self.stats["crc_ok"] += int(ok_host)
        return tb, ok_host, p.softbuffer, n_it

    def decode(self, samples, sf_idx: int, grant: DlGrant, softbuffer=None):
        """Decode one PDSCH grant from one subframe of samples.

        samples: (nrx, sf_len) complex64.  Returns
        (tb_bits (tbs,) uint8, crc_ok bool, softbuffer (b_bucket, 3,
        k_bucket+4) float32 tensor, n_iterations int)."""
        return self.result(self.decode_async(samples, sf_idx, grant, softbuffer))

    @property
    def total_compiles(self) -> int:
        return (self.stats["compiles_a"] + self.stats["compiles_b"]
                + self.stats["compiles_c"])
