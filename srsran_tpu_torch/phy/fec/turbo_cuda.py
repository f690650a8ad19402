"""Wrapper and build of the Hopper MAP kernel (`csrc/map_window.cu`).

Counterpart of `srsran_tpu/phy/fec/turbo_pallas.py`.  `map_windows` takes
the same lane-layout inputs as `map_windows_pallas`, its optional `kq`
(the dynamic-K mode) included, checks them and launches the kernel; it
raises for anything it cannot launch, a tensor that is not on a CUDA device included.  The choice of the
plain version for a CPU tensor is made by its caller, `turbo.map_decoder`.

The kernel is compiled at first use with `nvcc` for sm_90a into a shared
library with a plain C interface, loaded through ctypes.  The library
lives in `srsran_tpu_torch/_build/`, named by a hash of the source, so a
changed source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "map_window.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# launches of the CUDA kernel since the count was last set to 0: both modes,
# and those of the dynamic-K mode (`kq` given) alone
LAUNCHES = 0
LAUNCHES_DYN = 0

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the MAP kernel cannot be built")
    return str(path)


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libmap_window_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)], check=True)
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    return lib_path


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, nptr in ((lib.map_window_launch, 11), (lib.map_window_dyn_launch, 12)):
                fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, shape: tuple[int, int], device: torch.device,
           dtype: torch.dtype = torch.float32):
    if t.device != device:
        raise ValueError(f"map_windows: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"map_windows: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"map_windows: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"map_windows: {name} is not contiguous")


def map_windows(ax_tr, az_tr, ax, az, bx_tr, bz_tr, a_mask, b_mask, b_known,
                T: int, lw: int, kq: torch.Tensor | None = None) -> torch.Tensor:
    """Windowed MAP pass over all lanes → posterior LLRs (lw, bn) float32.

    Shapes: ax_tr/az_tr/bx_tr/bz_tr (T, bn); ax/az (lw, bn);
    a_mask/b_mask (1, bn); b_known (8, bn), all float32 on one CUDA device;
    kq, when given, (1, bn) int32 and the dynamic-K mode runs —
    see `turbo.map_windows_plain`."""
    global LAUNCHES, LAUNCHES_DYN
    device = ax.device
    bn = ax.shape[1]
    if not 0 <= T <= lw or lw < 1 or bn < 1:
        raise ValueError(f"map_windows: invalid T={T}, lw={lw}, bn={bn}")
    ins = dict(ax_tr=ax_tr, az_tr=az_tr, ax=ax, az=az, bx_tr=bx_tr, bz_tr=bz_tr,
               a_mask=a_mask, b_mask=b_mask, b_known=b_known)
    rows = dict(ax_tr=T, az_tr=T, ax=lw, az=lw, bx_tr=T, bz_tr=T,
                a_mask=1, b_mask=1, b_known=8)
    for name, t in ins.items():
        _check(name, t, (rows[name], bn), device)
    if kq is not None:
        _check("kq", kq, (1, bn), device, torch.int32)
    if device.type != "cuda":
        raise ValueError(f"map_windows: no kernel for device {device}")
    lib = _load()
    out = torch.empty((lw, bn), dtype=torch.float32, device=device)
    scratch = torch.empty((2 * (lw // 2), 8, bn), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [t.data_ptr() for t in ins.values()]
        tail = (out.data_ptr(), scratch.data_ptr(), T, lw, bn, stream)
        if kq is None:
            err = lib.map_window_launch(*ptrs, *tail)
        else:
            err = lib.map_window_dyn_launch(*ptrs, kq.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"map_window kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_DYN += kq is not None
    return out
