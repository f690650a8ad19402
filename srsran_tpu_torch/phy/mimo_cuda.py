"""Wrapper and build of the 4x4 MMSE detector (`csrc/mmse4.cu`).

`mmse4` detects the four layers of closed-loop spatial multiplexing on 4
ports (TM4 at rank 4) per resource element: the codebook matrix folded
into the channel estimate, A = (H W)^H (H W) + s2 I and c = (H W)^H y,
x = A^-1 c by a Cholesky factor, and each layer's CSI 1 / [A^-1]_ll, the
N-layer MMSE of `mimo.predecode_spatialmux4` at 4 layers.  On a CUDA tensor
it launches the kernel; on a CPU tensor it runs `mmse4_plain`, the same
arithmetic as elementwise operations over (B, M) planes, which calls no
`torch.linalg` function (their CUDA forms read their `info` on the host,
which no CUDA graph can hold).  Each call counts `mmse4_launches`
(`runtime.trace.count`); a CUDA graph that holds a call adds one at every
replay (`graphs.Graphed`).

The kernel is built at first use like the MAP kernel
(`turbo_cuda.build_library`: nvcc for sm_90a, a plain C interface loaded
through ctypes, `srsran_tpu_torch/_build/` named by a hash of the source).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..runtime.trace import count
from .fec.turbo_cuda import build_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mmse4.cu"
NOF = 4  # antennas, ports and layers

_lib = None
_lock = threading.Lock()


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path."""
    return build_library(SOURCE)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mmse4_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                                         + [ctypes.c_void_p])
            lib.mmse4_launch.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, shape: tuple[int, ...], dtype: torch.dtype,
           device: torch.device):
    if t.device != device:
        raise ValueError(f"mmse4: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"mmse4: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"mmse4: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"mmse4: {name} is not contiguous")


def mmse4(y: torch.Tensor, h: torch.Tensor, w: torch.Tensor, noise: torch.Tensor):
    """y (B, 4 rx, M) and h (B, 4 rx, 4 ports, M) complex64, w (4 ports, 4
    layers) complex64 and noise (B,) or (B, 1) float32, all contiguous and
    on one device, to (x (B, 4 layers, M) complex64, csi (B, 4, M)
    float32)."""
    device = y.device
    if y.dim() != 3 or y.shape[1] != NOF or y.shape[0] < 1 or y.shape[2] < 1:
        raise ValueError(f"mmse4: y has shape {tuple(y.shape)}, expected (B, {NOF}, M)")
    b, _, m = y.shape
    noise = noise.reshape(b)
    _check("y", y, (b, NOF, m), torch.complex64, device)
    _check("h", h, (b, NOF, NOF, m), torch.complex64, device)
    _check("w", w, (NOF, NOF), torch.complex64, device)
    _check("noise", noise, (b,), torch.float32, device)
    count("mmse4_launches")
    if device.type == "cpu":
        return mmse4_plain(y, h, w, noise)
    if device.type != "cuda":
        raise ValueError(f"mmse4: no kernel for device {device}")
    lib = _load()
    x = torch.empty_like(y)
    csi = torch.empty((b, NOF, m), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mmse4_launch(y.data_ptr(), h.data_ptr(), w.data_ptr(), noise.data_ptr(),
                               x.data_ptr(), csi.data_ptr(), b, m, stream)
    if err != 0:
        raise RuntimeError(f"mmse4 kernel launch failed: CUDA error {err}")
    return x, csi


def _norm2(a: torch.Tensor) -> torch.Tensor:
    return a.real * a.real + a.imag * a.imag


def mmse4_plain(y: torch.Tensor, h: torch.Tensor, w: torch.Tensor, noise: torch.Tensor):
    """The kernel's arithmetic in plain torch, step for step, over (B, M)
    planes: same arguments and results as `mmse4`."""
    b = y.shape[0]
    s2 = noise.reshape(b, 1)
    a_d, a_u, c = [None] * NOF, {}, [None] * NOF
    for r in range(NOF):
        hr = [h[:, r, p] for p in range(NOF)]
        g = []
        for layer in range(NOF):
            acc = hr[0] * w[0, layer]
            for p in range(1, NOF):
                acc = acc + hr[p] * w[p, layer]
            g.append(acc)
        for i in range(NOF):
            di, ci = _norm2(g[i]), torch.conj(g[i]) * y[:, r]
            a_d[i] = di if r == 0 else a_d[i] + di
            c[i] = ci if r == 0 else c[i] + ci
            for j in range(i + 1, NOF):
                e = torch.conj(g[i]) * g[j]
                a_u[i, j] = e if r == 0 else a_u[i, j] + e
    a_d = [a + s2 for a in a_d]

    # Cholesky A = L L^H: L_i0 = A_i0 / L_00 with A_i0 = conj(A_0i), and so on
    d = [None] * NOF
    low = {}
    for j in range(NOF):
        diag = a_d[j]
        for k in range(j):
            diag = diag - _norm2(low[j, k])
        d[j] = 1.0 / torch.sqrt(diag)
        for i in range(j + 1, NOF):
            acc = torch.conj(a_u[j, i])
            for k in range(j):
                acc = acc - low[i, k] * torch.conj(low[j, k])
            low[i, j] = acc * d[j]

    # L z = c, then L^H x = z
    z = [None] * NOF
    for i in range(NOF):
        acc = c[i]
        for k in range(i):
            acc = acc - low[i, k] * z[k]
        z[i] = acc * d[i]
    x = [None] * NOF
    for i in reversed(range(NOF)):
        acc = z[i]
        for k in range(i + 1, NOF):
            acc = acc - torch.conj(low[k, i]) * x[k]
        x[i] = acc * d[i]

    # L^-1 (lower, its diagonal d_i), then [A^-1]_ll = sum_k |(L^-1)_kl|^2
    inv = {}
    for col in range(NOF):
        for i in range(col + 1, NOF):
            acc = low[i, col] * d[col]
            for k in range(col + 1, i):
                acc = acc + low[i, k] * inv[k, col]
            inv[i, col] = acc * -d[i]
    csi = []
    for col in range(NOF):
        acc = d[col] * d[col]
        for i in range(col + 1, NOF):
            acc = acc + _norm2(inv[i, col])
        csi.append(1.0 / acc)
    return torch.stack(x, 1), torch.stack(csi, 1)
