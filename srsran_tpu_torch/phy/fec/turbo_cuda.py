"""Wrapper and build of the Hopper MAP kernel (`csrc/map_window.cu`).

Counterpart of `srsran_tpu/phy/fec/turbo_pallas.py`.  `map_pass` is one
constituent max-log-MAP pass over codeblocks: (B, K) LLRs in natural order
and the exact tail beta_K (B, 8) in, (B, K) posteriors out, with `k_vec`
for the dynamic-K mode.  The kernel stages each codeblock in shared memory
and keeps its metrics there, so the wrapper allocates nothing but the
output.  `map_pass` checks its inputs and launches the kernel; it raises
for anything it cannot launch, a tensor that is not on a CUDA device
included.  The choice of the plain version (`turbo.map_pass_plain`) for a
CPU tensor is made by its callers, `turbo.map_decoder` and
`turbo_dyn.map_decoder_dyn`.

The kernel is compiled at first use with `nvcc` for sm_90a into a shared
library with a plain C interface, loaded through ctypes.  The library
lives in `srsran_tpu_torch/_build/`, named by a hash of the source, so a
changed source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import lru_cache
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "map_window.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# the kernel's launch geometry (the constants of the same names in the source)
CKPT = 8  # window steps between two kept metric vectors
SMEM_MAX = 232448  # dynamic shared memory one block may ask for on sm_90
# the most a block may take for three blocks to share an SM (228 KB, 1 KB of
# it reserved per block)
SMEM_THREE_BLOCKS = (228 * 1024) // 3 - 1024
MAX_LANES = 128  # lanes of a block that holds several codeblocks

# launches of the CUDA kernel since the count was last set to 0: both modes,
# and those of the dynamic-K mode (`k_vec` given) alone
LAUNCHES = 0
LAUNCHES_DYN = 0
# launches by shape (B, nw, lw, T, dynamic-K mode) since the record was last
# cleared: the shapes a path gave the kernel
SHAPES: collections.Counter = collections.Counter()

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
            for fn, nptr in ((lib.map_pass_launch, 4), (lib.map_pass_dyn_launch, 5)):
                fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * 6 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def smem_bytes(lanes: int, lw: int) -> int:
    """Dynamic shared memory of a block of `lanes` windows of length lw: x
    and z at a window stride of lw | 1 floats (odd, so the lanes of a warp
    fall on different banks), each rounded up to 16 bytes, and per lane the
    kept alphas and betas of 32 bytes: one of each per CKPT steps of the
    half-window, and one more for the middle position of an odd lw."""
    staged = -(-lanes * (lw | 1) // 4) * 4
    kept = -(-(lw // 2) // CKPT) + (lw & 1)
    return 2 * staged * 4 + lanes * 2 * kept * 32


def block_threads(lanes: int) -> int:
    """Threads of a block of `lanes` windows: one forward and one backward
    thread per lane, the backward ones from a warp boundary on."""
    return -(-lanes // 32) * 32 + lanes


@lru_cache(maxsize=None)
def launch_plan(b: int, nw: int, lw: int, n_sm: int = 132) -> tuple[int, int]:
    """(codeblocks per block, shared-memory bytes per block) for a pass over
    b codeblocks of nw windows of lw; the same in both modes.

    One codeblock per block at the large K.  Where a codeblock has few
    windows, a block takes as many as fill MAX_LANES lanes and leave room
    for two more blocks on the SM, but no more than spread the batch over
    the card's n_sm multiprocessors."""
    fit = max((g for g in range(1, max(1, MAX_LANES // nw) + 1)
               if smem_bytes(g * nw, lw) <= SMEM_THREE_BLOCKS), default=1)
    cpb = max(1, min(fit, -(-b // n_sm)))
    smem = smem_bytes(cpb * nw, lw)
    if smem > SMEM_MAX or block_threads(cpb * nw) > 1024:
        raise ValueError(f"map_pass: nw={nw}, lw={lw} needs {smem} bytes of shared memory "
                         f"and {block_threads(cpb * nw)} threads a block")
    return cpb, smem


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name: str, t: torch.Tensor, shape: tuple[int, ...], device: torch.device,
           dtype: torch.dtype = torch.float32):
    if t.device != device:
        raise ValueError(f"map_pass: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"map_pass: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"map_pass: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"map_pass: {name} is not contiguous")


def map_pass(lx: torch.Tensor, lz: torch.Tensor, beta_k: torch.Tensor, nw: int, lw: int,
             T: int, k_vec: torch.Tensor | None = None) -> torch.Tensor:
    """One windowed MAP pass over B codeblocks → posterior LLRs (B, K) float32.

    lx, lz: (B, K) systematic-plus-apriori and parity LLRs, unscaled, with
    K = nw * lw (`turbo._window_layout`); beta_k: (B, 8) exact beta at
    position K; T: boundary training steps (`turbo._train_len`); all
    float32, contiguous, on one CUDA device.  k_vec, when given, (B,) int32
    true sizes K_i <= K, and the dynamic-K mode runs: lx and lz must be zero
    at positions >= K_i, beta_k is beta at K_i, and the posteriors there are
    garbage — see `turbo.map_pass_plain`, the same function in plain torch."""
    global LAUNCHES, LAUNCHES_DYN
    device = lx.device
    if lx.dim() != 2 or lx.shape[0] < 1 or lw < 1 or nw < 1 or not 0 <= T <= lw:
        raise ValueError(f"map_pass: invalid lx shape {tuple(lx.shape)}, nw={nw}, lw={lw}, T={T}")
    b = lx.shape[0]
    _check("lx", lx, (b, nw * lw), device)
    _check("lz", lz, (b, nw * lw), device)
    _check("beta_k", beta_k, (b, 8), device)
    if k_vec is not None:
        _check("k_vec", k_vec, (b,), device, torch.int32)
    if device.type != "cuda":
        raise ValueError(f"map_pass: no kernel for device {device}")
    lib = _load()
    cpb, smem = launch_plan(b, nw, lw, _sm_count(device))
    out = torch.empty_like(lx)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        tail = (out.data_ptr(), b, nw, lw, T, cpb, smem, stream)
        if k_vec is None:
            err = lib.map_pass_launch(lx.data_ptr(), lz.data_ptr(), beta_k.data_ptr(), *tail)
        else:
            err = lib.map_pass_dyn_launch(lx.data_ptr(), lz.data_ptr(), beta_k.data_ptr(),
                                          k_vec.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"map_window kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_DYN += k_vec is not None
    SHAPES[(b, nw, lw, T, k_vec is not None)] += 1
    return out
