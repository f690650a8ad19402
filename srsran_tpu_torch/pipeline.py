"""Subframe pipelines on the device: the single-device entry points
of `srsran_tpu/pipeline.py`.

* `ue_dl_subframe`: OFDM demod → CRS channel estimate → equalize (MRC on
  port 0, SFBC combining for transmit diversity, 2x2 MMSE for one-codeword
  spatial multiplexing) → soft demod → CSI weighting → descramble →
  de-rate-match → batched turbo decode → CRC.
* `multi_carrier_ue_dl`: `ue_dl_subframe` over a carriers axis, as a batch
  on one device or block by block over the positions of a
  `parallel.carrier_mesh`.
* `ue_dl_subframe_mimo`: the 2x2 two-codeword (TM3/TM4) decode; both
  codewords' codeblocks decode in one `turbo_decode` per distinct
  (K, CRC polynomial).
* `enb_dl_subframe_encode`: the DL data-subframe encoder — CRCs as GF(2)
  products → segmentation → closed-form turbo encoder → rate-match gathers →
  scramble → modulate → RE scatter into a CRS template → batched IFFT.
* `enb_ul_subframe`: the PUSCH decode — SC-FDMA demod (-0.5 subcarrier
  shift) → DMRS channel estimate → MRC → IDFT de-precoding → soft demod →
  descramble → de-interleave → UL-SCH turbo decode.

`ue_dl_subframe`, `ue_dl_subframe_mimo` and `enb_ul_subframe` mark their
front-end stages with `runtime.trace.span` (`fe.ofdm`, `fe.chest`,
`fe.equalize`, `fe.demap`; `fe.mimo`, inside `fe.equalize`, around the
precoder fold, the 2x2 MMSE solve and the layer demapping); TB decode and
the turbo loop mark theirs (`tbd.*`, `turbo.*`).  Only the snr_db tail of
each lies outside every span.  The two DL entries share their front end
(`_dl_front_end`).

The reference vmaps one subframe; here the leading batch axis of subframes
is written out, and every codeblock of the batch decodes in one
`turbo_decode`.  Each of them moves its tables to `device` once;
`device=None` means the first CUDA device (and raises when there is none);
the tests pass "cpu".
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from .device import resolve, table
from .parallel.mesh import split_rows
from .phy.chest.chest_dl import chest_dl
from .phy.chest.chest_ul import chest_ul
from .phy.chest.refsignal_dl import put_crs_np
from .phy.common import LTE_CRC24A, LTE_CRC24B, Cell
from .phy.crc import crc_compute
from .phy.dft_precoding import dft_predecode
from .phy.fec.cbsegm import cbsegm
from .phy.fec.rate_match import turbo_rm_indices
from .phy.fec.turbo import turbo_encode_device
from .phy.mimo import (
    layerdemap,
    predecode_diversity2,
    predecode_single_mrc,
    predecode_zf_mmse,
)
from .phy.modem import demod_soft, modulate
from .phy.ofdm import OfdmConfig, ofdm_rx_sf, ofdm_tx_sf
from .phy.phch.pdsch import DlGrant, DlGrant2, pdsch_cinit, pdsch_re_indices
from .phy.phch.pusch import UlGrant, _deinterleaver_indices, pusch_cinit, pusch_symbols_data
from .phy.phch.sch import TbCoding, dlsch_decode_device, dlsch_decode_multi_device
from .phy.sequence import gold_sequence, gold_sequence_signs
from .runtime.trace import span


def _check_on(samples: torch.Tensor, device: torch.device):
    if samples.device != device:
        raise ValueError(f"input is on {samples.device}, expected {device}")


def _snr_db(snr: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.mean(snr, dim=(1, 2)))


def _dl_front_end(cell: Cell, sf_idx: int, cfi: int, prb: tuple[int, ...], nof_ports: int,
                  device: torch.device):
    """The DL entries' front end for one (cell, subframe, allocation):
    returns (the number of PDSCH REs, front_end), where
    `with front_end(samples) as (y, h, noise, snr):` runs OFDM demod
    (`fe.ofdm`), CRS estimation of `nof_ports` ports and the noise mean
    (`fe.chest`), then opens `fe.equalize` with the RE gathers and keeps it
    open around the caller's equalizer.  y (B, nrx, M), h (B, nrx,
    nof_ports, M), noise (B, 1), snr (B, nrx, nof_ports)."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    idx = table(pdsch_re_indices, cell, sf_idx, cfi, prb, device=device, dtype=torch.int64)

    @contextmanager
    def front_end(samples: torch.Tensor):
        with span("fe.ofdm"):
            rx_grid = ofdm_rx_sf(ofdm, samples)  # (B, nrx, nsymb, nre)
        with span("fe.chest"):
            res = chest_dl(rx_grid, cell, sf_idx, nof_ports=nof_ports)
            noise = torch.mean(res["noise"], dim=(1, 2))[:, None]  # (B, 1)
        with span("fe.equalize"):
            b, nrx = rx_grid.shape[:2]
            y = rx_grid.reshape(b, nrx, -1)[..., idx]  # (B, nrx, M)
            h = res["ce"].reshape(b, nrx, nof_ports, -1)[..., idx]
            yield y, h, noise, res["snr"]

    return idx.numel(), front_end


def ue_dl_subframe(cell: Cell, sf_idx: int, cfi: int, grant: DlGrant,
                   max_iterations: int = 5, *, device=None):
    """Build the UE DL subframe decode for one (cell, subframe, grant), for
    the port0, diversity (2 ports) and spatialmux (2 ports, one codeword)
    transmit schemes.

    Returns fn(samples (B, nrx, sf_len) complex64 on `device`) ->
      (tb_bits (B, tbs) uint8, crc_ok (B,) bool, snr_db (B,) float32).
    """
    if grant.tx_scheme not in ("port0", "diversity", "spatialmux"):
        raise NotImplementedError(grant.tx_scheme)
    device = resolve(device)
    nof_ports = 1 if grant.tx_scheme == "port0" else 2
    n_re, front_end = _dl_front_end(cell, sf_idx, cfi, grant.prb, nof_ports, device)
    nof_layers = grant.nof_layers if grant.tx_scheme == "spatialmux" else 1
    g = n_re * grant.qm * nof_layers
    coding = TbCoding(tbs=grant.tbs, g=g, qm=grant.qm, rv=grant.rv, nof_layers=nof_layers)
    signs = table(gold_sequence_signs, pdsch_cinit(grant.rnti, sf_idx, cell.id), g,
                  device=device)

    def fn(samples: torch.Tensor):
        _check_on(samples, device)
        with front_end(samples) as (y, h, noise, snr):
            if grant.tx_scheme == "port0":
                x, csi = predecode_single_mrc(y, h[:, :, 0], noise)
            elif grant.tx_scheme == "diversity":
                x, csi = predecode_diversity2(y, h)
            else:
                with span("fe.mimo"):
                    xl, csil = predecode_zf_mmse(y, h, grant.nof_layers, noise, pmi=grant.pmi)
                    x, csi = layerdemap(xl, 1)[0], layerdemap(csil, 1)[0]
        with span("fe.demap"):
            llr = demod_soft(grant.mod, x) * torch.repeat_interleave(csi, grant.qm, dim=-1)
            llr = llr * signs
        tb, ok = dlsch_decode_device(llr, coding, max_iterations)
        return tb, ok, _snr_db(snr)

    return fn


def multi_carrier_ue_dl(cell: Cell, sf_idx: int, cfi: int, grant: DlGrant, mesh=None,
                        axis: str = "carriers", max_iterations: int = 5, *, device=None):
    """The carrier pipeline: `ue_dl_subframe` over a leading carriers axis.

    Returns fn(samples (n_carriers, nrx, sf_len) complex64) ->
      (tb (n_carriers, tbs) uint8, ok (n_carriers,) bool, total_ok () int32).
    Without a mesh the carriers are the batch axis of one decode on
    `device`.  With a mesh (`parallel.carrier_mesh`) the positions along
    `axis` each decode a contiguous block of carriers on their own device,
    from wherever the samples lie; `tb` and `ok` come back in carrier order
    and `total_ok` is their sum, all on the first position's device.
    `device` is for the meshless form only."""
    if mesh is None:
        single = ue_dl_subframe(cell, sf_idx, cfi, grant, max_iterations, device=device)

        def all_carriers(samples: torch.Tensor):
            tb, ok, _snr = single(samples)
            return tb, ok, ok.sum(dtype=torch.int32)

        return all_carriers
    if device is not None:
        raise ValueError("with a mesh the positions name the devices; leave device=None")
    positions = mesh.axis_devices(axis)
    per_device = {d: ue_dl_subframe(cell, sf_idx, cfi, grant, max_iterations, device=d)
                  for d in dict.fromkeys(positions)}

    def sharded(samples: torch.Tensor):
        blocks = split_rows(samples, positions)
        outs = [per_device[d](blk) for d, blk in zip(positions, blocks)]
        home = positions[0]
        tb = torch.cat([o[0].to(home) for o in outs])
        ok = torch.cat([o[1].to(home) for o in outs])
        return tb, ok, ok.sum(dtype=torch.int32)

    return sharded


def ue_dl_subframe_mimo(cell: Cell, sf_idx: int, cfi: int, grant: DlGrant2,
                        max_iterations: int = 5, *, device=None):
    """Build the 2x2 spatial-multiplexing (TM4 codebook) two-codeword decode.

    Returns fn(samples (B, 2, sf_len) complex64 on `device`) ->
      ((tb1 (B, tbs1) uint8, ok1 (B,) bool), (tb2, ok2), snr_db (B,) float32).
    """
    device = resolve(device)
    n_re, front_end = _dl_front_end(cell, sf_idx, cfi, grant.prb, 2, device)
    cws = ((grant.mod1, grant.qm1, grant.tbs1, grant.rv1),
           (grant.mod2, grant.qm2, grant.tbs2, grant.rv2))
    signs = [table(gold_sequence_signs, pdsch_cinit(grant.rnti, sf_idx, cell.id, q=q),
                   n_re * qm, device=device) for q, (_, qm, _, _) in enumerate(cws)]
    codings = [TbCoding(tbs=tbs, g=n_re * qm, qm=qm, rv=rv, nof_layers=1)
               for _, qm, tbs, rv in cws]

    def fn(samples: torch.Tensor):
        _check_on(samples, device)
        if samples.shape[-2] != 2:
            raise ValueError(f"the 2x2 decode takes 2 receive antennas, got {samples.shape[-2]}")
        with front_end(samples) as (y, h, noise, snr):
            with span("fe.mimo"):
                x, csi = predecode_zf_mmse(y, h, 2, noise, pmi=grant.pmi)
                sym_cws, csi_cws = layerdemap(x, 2), layerdemap(csi, 2)
        with span("fe.demap"):
            llrs = [demod_soft(mod, sym_cws[q]) * torch.repeat_interleave(csi_cws[q], qm, dim=-1)
                    * signs[q] for q, (mod, qm, _, _) in enumerate(cws)]
        # both codewords' codeblocks decode in one batched turbo call per
        # distinct (K, CRC polynomial), not in per-codeword chains
        outs = dlsch_decode_multi_device(llrs, codings, max_iterations)
        return outs[0], outs[1], _snr_db(snr)

    return fn


def enb_ul_subframe(cell: Cell, sf_idx: int, grant: UlGrant, max_iterations: int = 5, *,
                    device=None):
    """Build the eNB UL PUSCH subframe decode for one (cell, subframe, grant).

    Returns fn(samples (B, nrx, sf_len) complex64 on `device`) ->
      (tb_bits (B, tbs) uint8, crc_ok (B,) bool, snr_db (B,) float32).
    """
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)
    device = resolve(device)
    m_sc = 12 * grant.nof_prb
    k0 = grant.prb_start * 12
    data_syms = torch.as_tensor(pusch_symbols_data(cell), device=device)
    nsym = data_syms.numel()
    g = nsym * m_sc * grant.qm
    coding = TbCoding(tbs=grant.tbs, g=g, qm=grant.qm, rv=grant.rv)
    signs = table(gold_sequence_signs, pusch_cinit(grant.rnti, sf_idx, cell.id), g, device=device)
    # the interleaver is a permutation: undoing it is a gather by its inverse
    deint = table(_deinterleaver_indices, g, grant.qm, device=device, dtype=torch.int64)

    def fn(samples: torch.Tensor):
        _check_on(samples, device)
        with span("fe.ofdm"):
            rx_grid = ofdm_rx_sf(ofdm, samples)  # (B, nrx, nsymb, nre)
        with span("fe.chest"):
            ce, noise = chest_ul(rx_grid, cell, grant.prb_start, grant.nof_prb)
            noise = torch.mean(noise, dim=1)  # (B,)
        with span("fe.equalize"):
            b, nrx = rx_grid.shape[:2]
            y = rx_grid[:, :, data_syms, k0 : k0 + m_sc]
            h = ce[:, :, data_syms, :]
            xf, csi = predecode_single_mrc(y.reshape(b, nrx, -1), h.reshape(b, nrx, -1),
                                           noise[:, None])
            x = dft_predecode(xf.reshape(b, nsym, m_sc))
        with span("fe.demap"):
            llr = demod_soft(grant.mod, x.reshape(b, -1))
            # the CSI of an SC-FDMA symbol is its mean over the allocation
            csi_t = torch.mean(csi.reshape(b, nsym, m_sc), dim=-1)
            llr = llr * torch.repeat_interleave(csi_t, m_sc * grant.qm, dim=-1)
            llr = (llr * signs)[:, deint]
        tb, ok = dlsch_decode_device(llr, coding, max_iterations)
        sig = torch.mean(ce.abs() ** 2, dim=(1, 2, 3))
        return tb, ok, 10.0 * torch.log10(sig / (noise + 1e-12))

    return fn


def enb_dl_subframe_encode(cell: Cell, sf_idx: int, cfi: int, grant: DlGrant, *, device=None):
    """Build the eNB DL data-subframe encoder for one (cell, subframe, grant):
    port 0, codeblocks of one size (as the reference).

    Returns fn(tb_bits (B, tbs) uint8 on `device`) ->
      samples (B, nports, sf_len) complex64.
    """
    if grant.tx_scheme != "port0":
        raise ValueError(f"the device encoder is the port-0 path, got {grant.tx_scheme!r}")
    segm = cbsegm(grant.tbs)
    ka = segm.cb_sizes[0]
    if any(k != ka for k in segm.cb_sizes):
        raise ValueError(f"tbs {grant.tbs} segments into codeblocks of two sizes")
    device = resolve(device)
    idx = table(pdsch_re_indices, cell, sf_idx, cfi, grant.prb, device=device,
                dtype=torch.int64)
    g = idx.numel() * grant.qm
    blocks = TbCoding(grant.tbs, g, grant.qm).blocks
    rm_idx = [table(turbo_rm_indices, ka, blk.e, grant.rv, blk.f, device=device,
                    dtype=torch.int64) for blk in blocks]
    seq = table(gold_sequence, pdsch_cinit(grant.rnti, sf_idx, cell.id), g, device=device,
                dtype=torch.uint8)
    tmpl = table(_crs_template, cell, sf_idx, device=device)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    f0, crc_len = blocks[0].f, blocks[0].crc

    def fn(tb_bits: torch.Tensor):
        _check_on(tb_bits, device)
        tb_bits = tb_bits.to(torch.uint8)
        nb = tb_bits.shape[0]
        b = torch.cat([tb_bits, crc_compute(tb_bits, LTE_CRC24A)], dim=-1)
        # segment: filler zeros on codeblock 0, a CRC24B each when C > 1
        cbs = torch.cat([b.new_zeros((nb, f0)), b], dim=-1).reshape(nb, segm.C, ka - crc_len)
        if crc_len:
            cbs = torch.cat([cbs, crc_compute(cbs, LTE_CRC24B)], dim=-1)
        d = turbo_encode_device(cbs.reshape(nb * segm.C, ka), ka)  # (B*C, 3, ka+4)
        flat = d.reshape(nb, segm.C, -1)
        e = torch.cat([flat[:, i, rm_idx[i]] for i in range(segm.C)], dim=-1)
        sym = modulate(grant.mod, e ^ seq)
        grid = tmpl.reshape(1, tmpl.shape[0], -1).repeat(nb, 1, 1)
        grid[:, 0, idx] = sym
        return ofdm_tx_sf(ofdm, grid.reshape((nb,) + tuple(tmpl.shape)))

    return fn


def _crs_template(cell: Cell, sf_idx: int) -> np.ndarray:
    """(nports, nsymb, nre) complex64 grid holding the CRS and nothing else
    (the control region stays empty)."""
    tmpl = np.zeros((max(cell.nof_ports, 1), cell.nsymb_per_sf, cell.nof_re_per_symbol),
                    np.complex64)
    return put_crs_np(tmpl, cell, sf_idx)
