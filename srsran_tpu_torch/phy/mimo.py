"""MIMO: layer mapping, precoding and ZF/MMSE predecoding, TS 36.211 §6.3.3-4.

Counterpart of `srsran_tpu/phy/mimo.py`:

* layer map/demap for 1-4 layers, 1-2 codewords;
* precoding: single port, 2-port transmit diversity (SFBC/Alamouti), 2-port
  spatial multiplexing with the TS 36.211 Table 6.3.4.2.3-1 codebook,
  large-delay CDD, 4-port SFBC-FSTD and the 4-port codebook.  The precoders
  serve the host transmitter and are numpy;
* predecoding on the device (torch): MRC for a single layer, SFBC combining
  and the closed-form 2x2 ZF/MMSE solve, elementwise over the RE axis, and
  the N-layer MMSE of the 4-port codebook; each returns the CSI that weights
  the LLRs.

Shape conventions (RE-last, batch-first):
  symbols  (..., nof_re)                 one codeword's modulated symbols
  layers   (..., nof_layers, nof_re)
  ports    (..., nof_ports, nof_re)
  channel  (..., nof_rx, nof_ports, nof_re)  estimated H per RE
A noise estimate is a scalar or a tensor that broadcasts against (..., M):
per-subframe noise (B,) goes in as (B, 1).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import table

SQRT2_INV = np.float32(1.0 / np.sqrt(2.0))


# --- layer mapping (TS 36.211 Table 6.3.3.2-1) ------------------------------


def _to_layers(x, nl: int):
    m = x.shape[-1] // nl
    return x.reshape(tuple(x.shape[:-1]) + (m, nl)).swapaxes(-1, -2)


def _from_layers(layers):
    x = layers.swapaxes(-1, -2)
    return x.reshape(tuple(x.shape[:-2]) + (-1,))


def layermap(codewords: list, nof_layers: int) -> np.ndarray:
    """List of per-codeword symbol arrays → (..., nof_layers, M_layer) (host)."""
    if len(codewords) == 1:
        return _to_layers(np.asarray(codewords[0]), nof_layers)
    if len(codewords) == 2:
        per_cw = (nof_layers // 2, nof_layers - nof_layers // 2)
        return np.concatenate(
            [_to_layers(np.asarray(cw), nl) for cw, nl in zip(codewords, per_cw)], axis=-2)
    raise ValueError("1 or 2 codewords")


def layerdemap(layers, nof_codewords: int) -> list:
    """(..., nof_layers, M) → list of codeword arrays (inverse of `layermap`);
    tensors or numpy arrays."""
    if nof_codewords == 1:
        return [_from_layers(layers)]
    n0 = layers.shape[-2] // 2
    return [_from_layers(layers[..., :n0, :]), _from_layers(layers[..., n0:, :])]


# --- precoding (host, numpy) ---------------------------------------------------


def precode_single(layers):
    """(..., 1, M) → (..., 1, M): single antenna port, identity."""
    return layers


def precode_diversity2(symbols: np.ndarray) -> np.ndarray:
    """SFBC for 2 ports: (..., M) codeword symbols → (..., 2, M).

    TS 36.211 §6.3.4.3: per symbol pair (x0, x1), port 0 transmits
    (x0, x1)/sqrt(2) and port 1 (-x1*, x0*)/sqrt(2)."""
    symbols = np.asarray(symbols)
    m = symbols.shape[-1]
    x = symbols.reshape(symbols.shape[:-1] + (m // 2, 2))
    x0, x1 = x[..., 0], x[..., 1]
    p0 = np.stack([x0, x1], axis=-1).reshape(symbols.shape) * SQRT2_INV
    p1 = np.stack([-np.conj(x1), np.conj(x0)], axis=-1).reshape(symbols.shape) * SQRT2_INV
    return np.stack([p0, p1], axis=-2)


@lru_cache(maxsize=None)
def _codebook_2x2(pmi: int, nof_layers: int) -> np.ndarray:
    """2-port spatial-multiplexing codebook, TS 36.211 Table 6.3.4.2.3-1:
    (2, nof_layers) complex64."""
    if nof_layers == 1:
        vecs = {0: np.array([1, 1]), 1: np.array([1, -1]),
                2: np.array([1, 1j]), 3: np.array([1, -1j])}[pmi]
        return (vecs / np.sqrt(2.0)).reshape(2, 1).astype(np.complex64)
    mats = {0: np.array([[1, 0], [0, 1]]) / np.sqrt(2.0),
            1: np.array([[1, 1], [1, -1]]) / 2.0,
            2: np.array([[1, 1], [1j, -1j]]) / 2.0}[pmi]
    return mats.astype(np.complex64)


def precode_cdd2(layers: np.ndarray) -> np.ndarray:
    """Large-delay CDD for 2 layers / 2 ports (TM3), TS 36.211 §6.3.4.2.2:
    y = W D(i) U x with W = I/sqrt(2), alternating phase on layer 2."""
    layers = np.asarray(layers)
    m = layers.shape[-1]
    u = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2.0)
    x = np.einsum("lk,...km->...lm", u.astype(np.complex64), layers)
    # D(i) = diag(1, e^{-j*2*pi*i/2}) = diag(1, (-1)^i)
    x[..., 1, :] *= np.where(np.arange(m) % 2 == 0, 1.0, -1.0).astype(np.complex64)
    return (x * SQRT2_INV).astype(np.complex64)


def precode_spatialmux(layers: np.ndarray, pmi: int) -> np.ndarray:
    """Closed-loop spatial multiplexing (TM4), 2 ports."""
    layers = np.asarray(layers)
    return np.einsum("pl,...lm->...pm", _codebook_2x2(pmi, layers.shape[-2]), layers)


def precode_diversity4(symbols: np.ndarray) -> np.ndarray:
    """SFBC-FSTD for 4 ports (TS 36.211 §6.3.4.3): (..., M) with M % 4 == 0
    → (..., 4, M).  Per group of 4 symbols over 4 REs, ports (0, 2) carry the
    Alamouti pair of (x0, x1) on REs 0-1 and ports (1, 3) that of (x2, x3) on
    REs 2-3; the other ports are zero on those REs."""
    symbols = np.asarray(symbols)
    m = symbols.shape[-1]
    x = symbols.reshape(symbols.shape[:-1] + (m // 4, 4))
    x0, x1, x2, x3 = (x[..., i] for i in range(4))
    z = np.zeros_like(x0)
    p0 = np.stack([x0, x1, z, z], axis=-1)
    p1 = np.stack([z, z, x2, x3], axis=-1)
    p2 = np.stack([-np.conj(x1), np.conj(x0), z, z], axis=-1)
    p3 = np.stack([z, z, -np.conj(x3), np.conj(x2)], axis=-1)
    out = np.stack([p0, p1, p2, p3], axis=-3) * SQRT2_INV
    return out.reshape(symbols.shape[:-1] + (4, m))


_S2 = 1.0 / np.sqrt(2.0)
_U4 = np.array([
    [1, -1, -1, -1],
    [1, -1j, 1, 1j],
    [1, 1, -1, 1],
    [1, 1j, 1, -1j],
    [1, (-1 - 1j) * _S2, -1j, (1 - 1j) * _S2],
    [1, (1 - 1j) * _S2, 1j, (-1 - 1j) * _S2],
    [1, (1 + 1j) * _S2, -1j, (-1 + 1j) * _S2],
    [1, (-1 + 1j) * _S2, 1j, (1 + 1j) * _S2],
    [1, -1, 1, 1],
    [1, -1j, -1, -1j],
    [1, 1, 1, -1],
    [1, 1j, -1, 1j],
    [1, -1, -1, 1],
    [1, -1, 1, -1],
    [1, 1, -1, -1],
    [1, 1, 1, 1],
], np.complex64)
# column sets (1-based) of TS 36.211 Table 6.3.4.2.3-2
_COLS_4 = {
    2: ("14", "12", "12", "12", "14", "14", "13", "13",
        "12", "14", "13", "13", "12", "13", "13", "12"),
    3: ("124", "123", "123", "123", "124", "124", "134", "134",
        "124", "134", "123", "134", "123", "123", "123", "123"),
    4: ("1234", "1234", "3214", "3214", "1234", "1234", "1324", "1324",
        "1234", "1234", "1324", "1324", "1234", "1324", "3214", "1234"),
}


@lru_cache(maxsize=None)
def _codebook_4(idx: int, nof_layers: int) -> np.ndarray:
    """4-port precoder W_n^{(cols)} (TS 36.211 Table 6.3.4.2.3-2): with
    W_n = I - 2 u_n u_n^H / (u_n^H u_n), the rank-r precoder takes the
    table's column set of W_n scaled by 1/sqrt(r).  Returns (4, r)."""
    u = _U4[idx].reshape(4, 1)
    w = np.eye(4, dtype=np.complex64) - 2.0 * (u @ u.conj().T) / (u.conj().T @ u).real.item()
    cols = [0] if nof_layers == 1 else [int(c) - 1 for c in _COLS_4[nof_layers][idx]]
    return (w[:, cols] / np.sqrt(nof_layers)).astype(np.complex64)


def precode_spatialmux4(layers: np.ndarray, codebook_idx: int) -> np.ndarray:
    """Closed-loop spatial multiplexing on 4 ports: layers (..., L, M) →
    ports (..., 4, M)."""
    layers = np.asarray(layers)
    return np.einsum("pl,...lm->...pm", _codebook_4(codebook_idx, layers.shape[-2]), layers)


# --- predecoding (equalization, device) -------------------------------------


def _fold_precoder(h: torch.Tensor, w) -> torch.Tensor:
    """Effective channel (..., nrx, L, M) of h (..., nrx, P, M) behind the
    (P, L) precoder w (numpy, or a tensor on h's device)."""
    return torch.einsum("...rpm,pl->...rlm", h, torch.as_tensor(w, device=h.device))


def predecode_single_mrc(y: torch.Tensor, h: torch.Tensor, noise_est=0.0):
    """MRC: x = h^H y / (|h|^2 + n); y, h (..., nrx, M) → (x_hat, csi), each
    (..., M)."""
    hh = torch.sum(h.abs() ** 2, dim=-2) + noise_est
    x = torch.sum(torch.conj(h) * y, dim=-2) / hh
    return x, hh


def predecode_diversity2(y: torch.Tensor, h: torch.Tensor):
    """SFBC combining: y (..., nrx, M), h (..., nrx, 2, M) → (symbols (..., M),
    csi (..., M)).  Alamouti combining per RE pair, inverse of
    `precode_diversity2`; the channel of a pair is the mean of its two
    estimates and the CSI is repeated over the pair."""
    m = y.shape[-1]
    if m % 2:
        raise ValueError(f"transmit diversity needs an even number of REs, got {m}")
    shp = tuple(y.shape[:-1]) + (m // 2, 2)
    yp = y.reshape(shp)  # (..., nrx, M/2, 2)
    h0 = h[..., 0, :].reshape(shp)
    h1 = h[..., 1, :].reshape(shp)
    h0p = (h0[..., 0] + h0[..., 1]) * 0.5
    h1p = (h1[..., 0] + h1[..., 1]) * 0.5
    y0, y1 = yp[..., 0], yp[..., 1]
    hh = h0p.abs() ** 2 + h1p.abs() ** 2 + 1e-12
    x0 = torch.sum(torch.conj(h0p) * y0 + h1p * torch.conj(y1), dim=-2)
    x1 = torch.sum(torch.conj(h0p) * y1 - h1p * torch.conj(y0), dim=-2)
    csi = torch.sum(hh, dim=-2)
    scale = float(np.float32(np.sqrt(2.0))) / csi
    x = torch.stack([x0 * scale, x1 * scale], dim=-1).reshape(tuple(y.shape[:-2]) + (m,))
    return x, torch.repeat_interleave(csi, 2, dim=-1)


def select_pmi(h: torch.Tensor, nof_layers: int, noise_est=1e-3):
    """PMI selection for 2-port closed loop: the post-equalization SINR
    proxy of every codebook entry in one batched computation.  Returns
    (best_pmi, per_pmi_capacity, condition_number_db).

    h: (..., nrx, 2, M) channel estimates over the REs of interest."""
    caps = []
    for pmi in range(4 if nof_layers == 1 else 3):
        heff = _fold_precoder(h, _codebook_2x2(pmi, nof_layers))
        if nof_layers == 1:
            sinr = torch.sum(heff[..., 0, :].abs() ** 2, dim=-2) / noise_est
            caps.append(torch.mean(torch.log2(1.0 + sinr), dim=-1))
        else:
            a00 = torch.sum(heff[..., 0, :].abs() ** 2, dim=-2) + noise_est
            a11 = torch.sum(heff[..., 1, :].abs() ** 2, dim=-2) + noise_est
            a01 = torch.sum(torch.conj(heff[..., 0, :]) * heff[..., 1, :], dim=-2)
            det = a00 * a11 - a01.abs() ** 2
            sinr0 = det / (a11 * noise_est)
            sinr1 = det / (a00 * noise_est)
            caps.append(torch.mean(torch.log2(1.0 + sinr0) + torch.log2(1.0 + sinr1), dim=-1))
    cap = torch.stack(caps, dim=-1)
    best = torch.argmax(cap, dim=-1)
    # condition number (dB) of the Gram matrix over rx antennas, averaged over REs
    g00 = torch.sum(h[..., 0, :].abs() ** 2, dim=-2)
    g11 = torch.sum(h[..., 1, :].abs() ** 2, dim=-2)
    g01 = torch.sum(torch.conj(h[..., 0, :]) * h[..., 1, :], dim=-2).abs()
    tr = g00 + g11
    d = torch.sqrt(torch.clamp((g00 - g11) ** 2 + 4 * g01**2, min=0.0))
    lam_max = (tr + d) / 2
    lam_min = torch.clamp((tr - d) / 2, min=1e-12)
    cond_db = 10.0 * torch.log10(torch.mean(lam_max / lam_min, dim=-1))
    return best, cap, cond_db


def _solve2x2(a00, a01, a10, a11, b0, b1):
    det = a00 * a11 - a01 * a10
    inv_det = 1.0 / det
    x0 = (a11 * b0 - a01 * b1) * inv_det
    x1 = (a00 * b1 - a10 * b0) * inv_det
    return x0, x1


def predecode_zf_mmse(y: torch.Tensor, h: torch.Tensor, nof_layers: int, noise_est=0.0,
                      pmi: int | None = None):
    """ZF (noise_est=0) / MMSE equalizer for 1-2 layers over 2 TX ports.

    y (..., nrx, M); h (..., nrx, nports, M).  If `pmi` is given the codebook
    precoder is folded into H (closed-loop TM4).  Returns (x_hat, csi), each
    (..., nof_layers, M), csi float32.  As in the reference the Gram entries
    stay complex64 and 1/det is a complex reciprocal."""
    if pmi is not None:
        # the codebook entry as a table on h's device, copied there once: a
        # copy from the host on every call would wait for the device
        h = _fold_precoder(h, table(_codebook_2x2, pmi, nof_layers, device=h.device))
    if nof_layers == 1:
        heff = h[..., 0, :] if h.shape[-2] == 1 else h.sum(dim=-2)
        x, csi = predecode_single_mrc(y, heff, noise_est)
        return x[..., None, :], csi[..., None, :]

    # Gram matrix A = H^H H + sigma2 I per RE (2x2), b = H^H y
    hc = torch.conj(h)
    a00 = torch.sum(hc[..., :, 0, :] * h[..., :, 0, :], dim=-2) + noise_est
    a11 = torch.sum(hc[..., :, 1, :] * h[..., :, 1, :], dim=-2) + noise_est
    a01 = torch.sum(hc[..., :, 0, :] * h[..., :, 1, :], dim=-2)
    a10 = torch.conj(a01)
    b0 = torch.sum(hc[..., :, 0, :] * y, dim=-2)
    b1 = torch.sum(hc[..., :, 1, :] * y, dim=-2)
    x0, x1 = _solve2x2(a00, a01, a10, a11, b0, b1)
    x = torch.stack([x0, x1], dim=-2)
    # CSI: diagonal of the equalized SNR proxy, 1/diag(A^-1)
    det = a00 * a11 - a01 * a10
    csi = torch.stack([(det / a11).real, (det / a00).real], dim=-2)
    return x, csi


def predecode_diversity4(y: torch.Tensor, h: torch.Tensor):
    """SFBC-FSTD receiver: y (..., nrx, M), h (..., nrx, 4, M) →
    (x (..., M), csi (..., M))."""
    m = y.shape[-1]
    if m % 4:
        raise ValueError(f"4-port transmit diversity needs a multiple of 4 REs, got {m}")
    yg = y.reshape(tuple(y.shape[:-1]) + (m // 4, 4))
    hg = h.reshape(tuple(h.shape[:-2]) + (4, m // 4, 4))
    xs, gains = [], []
    for pair, (pa, pb) in ((0, (0, 2)), (1, (1, 3))):
        y0, y1 = yg[..., 2 * pair], yg[..., 2 * pair + 1]
        h0, h1 = hg[..., pa, :, 2 * pair], hg[..., pb, :, 2 * pair]
        gain = torch.sum(h0.abs() ** 2 + h1.abs() ** 2, dim=-2)
        xs.append(torch.sum(torch.conj(h0) * y0 + h1 * torch.conj(y1), dim=-2) / (gain + 1e-12))
        xs.append(torch.sum(torch.conj(h0) * y1 - h1 * torch.conj(y0), dim=-2) / (gain + 1e-12))
        gains += [gain, gain]
    out = tuple(y.shape[:-2]) + (m,)
    x = torch.stack(xs, dim=-1).reshape(out) * float(np.sqrt(2.0))
    return x.to(torch.complex64), torch.stack(gains, dim=-1).reshape(out)


def predecode_cdd2(y: torch.Tensor, h: torch.Tensor, noise_est=0.0):
    """TM3 open-loop (large-delay CDD) receiver: fold W D(i) U into H per RE
    parity, then the 2x2 MMSE solve.  y (..., nrx, M), h (..., nrx, 2, M) →
    (layers (..., 2, M), csi (..., 2, M))."""
    m = y.shape[-1]
    u = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2.0)
    signs = torch.as_tensor(np.where(np.arange(m) % 2 == 0, 1.0, -1.0).astype(np.complex64),
                            device=y.device)
    # effective precoder per RE, (1/sqrt2) D(i) U acting on the layers
    r0, r1 = u[0] * SQRT2_INV, u[1] * SQRT2_INV
    heff = torch.stack([
        h[..., 0, :] * complex(r0[0]) + h[..., 1, :] * complex(r1[0]) * signs,
        h[..., 0, :] * complex(r0[1]) + h[..., 1, :] * complex(r1[1]) * signs,
    ], dim=-2)
    return predecode_zf_mmse(y, heff, 2, noise_est, pmi=None)


def predecode_mmse_nl(y: torch.Tensor, heff: torch.Tensor, noise_est=0.0):
    """N-layer MMSE predecode: y (..., nrx, M), heff (..., nrx, L, M) the
    effective channel (precoder folded in).  Returns (x (..., L, M),
    csi (..., L, M)) — the NxN generalization of `_solve2x2`; `noise_est` is
    a scalar."""
    n_l = heff.shape[-2]
    hm = torch.movedim(heff, -1, -3)  # (..., M, nrx, L)
    ym = torch.movedim(y, -1, -2)[..., None]  # (..., M, nrx, 1)
    a = torch.einsum("...mrl,...mrk->...mlk", torch.conj(hm), hm)
    a = a + noise_est * torch.eye(n_l, dtype=a.dtype, device=a.device)
    b = torch.einsum("...mrl,...mro->...mlo", torch.conj(hm), ym)  # (..., M, L, 1)
    x = torch.linalg.solve(a, b)[..., 0]  # (..., M, L)
    # csi from the diagonal of A^-1: post-MMSE SNR proxy 1/[A^-1]_ll
    diag = torch.diagonal(torch.linalg.inv(a), dim1=-2, dim2=-1).real
    csi = 1.0 / torch.clamp(diag, min=1e-12)
    return torch.movedim(x, -1, -2), torch.movedim(csi, -1, -2)


def predecode_spatialmux4(y: torch.Tensor, h: torch.Tensor, nof_layers: int,
                          codebook_idx: int, noise_est=0.0):
    """4-port codebook receiver: fold W into H, N-layer MMSE.
    y (..., nrx, M); h (..., nrx, 4, M)."""
    return predecode_mmse_nl(y, _fold_precoder(h, _codebook_4(codebook_idx, nof_layers)),
                             noise_est)
