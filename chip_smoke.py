#!/usr/bin/env python
"""Smoke test of the PyTorch port (`srsran_tpu_torch`) on one NVIDIA GPU.

Run from the repo root:  python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the MAP kernel (csrc/map_window.cu) from the sources, timed;
  3. the kernel against its plain PyTorch version on the card at the
     main path's MAP shapes (K=5632: lw=88, T=32, 88 and 1408 codeblocks;
     and K=512): posteriors within atol 1e-4, identical hard bits;
  4. the UE DL SISO slice at full width — 100 PRB, MCS 26 QAM64, B=128
     subframes — through `ue_dl_subframe`: the two stored reference
     subframes of `srsran_tpu_torch/testdata/ue_dl_siso_20mhz.npz` must give
     the reference's crc_ok and TB bits, every CRC-passing TB must equal the
     transmitted one, and the kernel must have been launched;
  5. times with CUDA events after warmup: ms per B=128 batch and Mbps of
     CRC-passing TBs, and the MAP kernel against the plain version per pass.
Prints one JSON line of kernel results, then as its last line
{"ok": true, "device": {...}}.  TF32 stays off: the channel-estimate
einsums and the CRC products keep full fp32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B = 128
MAP_ATOL = 1e-4
SNR_ATOL_DB = 1e-3
FIXTURE = Path(__file__).resolve().parent / "srsran_tpu_torch" / "testdata" / "ue_dl_siso_20mhz.npz"


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of fn() over n runs, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def map_inputs(k: int, ncb: int, seed: int, device):
    """Lane-layout inputs of one MAP pass over ncb random codeblocks."""
    from srsran_tpu_torch.phy.fec.turbo import map_window_inputs

    rng = np.random.default_rng(seed)
    lx, lz = (torch.from_numpy(4.0 * rng.standard_normal((ncb, k)).astype(np.float32)).to(device)
              for _ in range(2))
    lxt, lzt = (torch.from_numpy(4.0 * rng.standard_normal((ncb, 3)).astype(np.float32)).to(device)
                for _ in range(2))
    return map_window_inputs(lx, lz, lxt, lzt, k)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from srsran_tpu_torch.device import require_cuda
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.fec import turbo_cuda
    from srsran_tpu_torch.phy.fec.turbo import map_windows_plain
    from srsran_tpu_torch.phy.modem import Mod
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant
    from srsran_tpu_torch.pipeline import ue_dl_subframe

    # phase 1: the card
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # phase 2: build
    t0 = time.perf_counter()
    lib = turbo_cuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib.name})")

    # phase 3: kernel against plain on the card
    max_err = 0.0
    headline = None
    for k, ncb in ((5632, 88), (5632, 1408), (512, 64)):
        *ins, T, lw = map_inputs(k, ncb, seed=k + ncb, device=dev)
        got = turbo_cuda.map_windows(*ins, T=T, lw=lw)
        ref = map_windows_plain(*ins, T, lw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        same_bits = bool(torch.equal(got > 0, ref > 0))
        print(f"map K={k} codeblocks={ncb} T={T} lw={lw} bn={ins[2].shape[1]}: "
              f"max_abs_err {err:.3g}, hard bits identical {same_bits}")
        check(bool(torch.isfinite(got).all()), f"non-finite posteriors at K={k}")
        check(err <= MAP_ATOL and same_bits, f"kernel disagrees with plain at K={k}")
        max_err = max(max_err, err)
        if ncb == 1408:
            headline = (ins, T, lw)

    # phase 4: the slice at full width
    fx = np.load(FIXTURE)
    tbs = int(fx["tbs"])
    nof_prb = int(fx["nof_prb"])
    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=int(fx["cell_id"]))
    grant = DlGrant(prb=tuple(range(nof_prb)), mod=Mod.QAM64, tbs=tbs)
    fn = ue_dl_subframe(cell, int(fx["sf_idx"]), int(fx["cfi"]), grant,
                        int(fx["max_iterations"]), device=dev)
    tx = fx["tx"]
    rng = np.random.default_rng(int(fx["seed"]) + 2)
    shape = (B - 2, 1, tx.size)
    noisy = (tx[None, None, :] + float(fx["noise_amp"]) * (
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)
    samples = torch.from_numpy(np.concatenate([fx["rx"], noisy])).to(dev)
    tb_tx = torch.from_numpy(np.unpackbits(fx["tb_packed"], count=tbs)).to(dev)
    ref_tb = torch.from_numpy(np.unpackbits(fx["ref_tb_packed"], axis=-1, count=tbs)).to(dev)

    turbo_cuda.LAUNCHES = 0
    tb, ok, snr_db = fn(samples)
    torch.cuda.synchronize()
    launches = turbo_cuda.LAUNCHES
    n_ok = int(ok.sum())
    print(f"slice: 100 PRB MCS 26 B={B}: crc_ok {n_ok}/{B}, map launches {launches}, "
          f"snr_db[:2] {snr_db[:2].tolist()} (reference {fx['ref_snr_db'].tolist()})")
    check(tuple(tb.shape) == (B, tbs) and tb.dtype == torch.uint8, "TB shape/dtype")
    check(tuple(ok.shape) == (B,) and ok.dtype == torch.bool, "crc_ok shape/dtype")
    check(bool(torch.isfinite(snr_db).all()), "non-finite snr_db")
    check(launches > 0, "the main path did not launch the MAP kernel")
    check(ok[:2].cpu().numpy().tolist() == fx["ref_crc_ok"].tolist(), "crc_ok differs from the reference")
    check(bool(torch.equal(tb[:2], ref_tb)), "TB bits differ from the reference")
    snr_err = float(np.abs(snr_db[:2].cpu().numpy() - fx["ref_snr_db"]).max())
    check(snr_err <= SNR_ATOL_DB, f"snr_db differs from the reference by {snr_err} dB")
    check(bool((tb[ok] == tb_tx).all()), "a CRC-passing TB differs from the transmitted one")
    check(n_ok >= B // 2, f"only {n_ok}/{B} TBs pass CRC at the ~18 dB operating point")

    # phase 5: times (CUDA events, after warmup)
    slice_ms = cuda_ms(lambda: fn(samples), 5)
    mbps = n_ok * tbs / (slice_ms * 1e-3) / 1e6
    ins, T, lw = headline
    kern_ms = cuda_ms(lambda: turbo_cuda.map_windows(*ins, T=T, lw=lw), 20)
    plain_ms = cuda_ms(lambda: map_windows_plain(*ins, T, lw), 3)
    print(f"slice: {slice_ms:.3f} ms per B={B} batch, {mbps:.1f} Mbps of CRC-passing TBs")
    print(f"map pass at bn={ins[2].shape[1]}: kernel {kern_ms:.4f} ms, plain {plain_ms:.3f} ms")

    print(json.dumps({"kernels": [{
        "name": "map_window", "route": "cuda", "source": "srsran_tpu_torch/csrc/map_window.cu",
        "replaces": "srsran_tpu/phy/fec/turbo_pallas.py:99", "launches": launches,
        "max_abs_err": max_err, "ms": kern_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
