#!/usr/bin/env python
"""Smoke test of the PyTorch port (`srsran_tpu_torch`) on one NVIDIA GPU.

Run from the repo root:  python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the MAP kernel (csrc/map_window.cu) from the sources, timed,
     and print its registers and spills as ptxas reports them;
  3. the kernel (`turbo_cuda.map_pass`, (B, K) LLRs in, posteriors out)
     against its plain PyTorch version (`turbo.map_pass_plain`) on the card
     at the main paths' MAP shapes: static mode at K=5632 (lw=88, T=32, 88
     and 1408 codeblocks) and K=512, at K=40 (one window), 6080 (76 windows
     of 80), 6144, and one odd window length (3 windows of 45); dynamic-K
     mode at K_max=6144 (lw=96, T=24, 32 codeblocks of mixed K), 2112 and
     768, compared below each codeblock's K: posteriors within atol 1e-4,
     identical hard bits;
  4. the UE DL SISO slice at full width — 100 PRB, MCS 26 QAM64, B=128
     subframes — through `ue_dl_subframe`: the two stored reference
     subframes of `srsran_tpu_torch/testdata/ue_dl_siso_20mhz.npz` must give
     the reference's crc_ok and TB bits, every CRC-passing TB must equal the
     transmitted one, and the kernel must have been launched;
  5. times with CUDA events after warmup: ms per B=128 batch and Mbps of
     CRC-passing TBs, and the MAP kernel against the plain version per pass
     (the kernel's launches queued behind a busy card, so that the time is
     the device's and not the host's);
  6. the dynamic-grant decode at full width — one `DynamicUeDl` on a
     100 PRB cell, stimuli rendered by the port's host transmitter from a
     seed: a 40-grant scheduler-style mix (MCS 0-28 x random contiguous
     allocations x subframes 0-9), MCS 28 on 100 PRB, the headline grant
     against `ue_dl_subframe` on the same samples, HARQ rv 0 → rv 2 at low
     SNR, and the stored grants of
     `srsran_tpu_torch/testdata/ue_dl_dynamic_20mhz.npz` against the
     reference's results; the dynamic-K kernel mode must have been launched;
  7. times of that path: ms per TTI (CUDA events, and host wall beside
     them) for MCS 28 on 100 PRB and for a 6 PRB QPSK grant, kernel
     launches per TTI, and the dynamic-K kernel mode against the plain
     version per pass at 16 codeblocks of K_max 6144.
Prints one JSON line of kernel results, then as its last line
{"ok": true, "device": {...}}.  TF32 stays off: the channel-estimate
einsums and the CRC products keep full fp32.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B = 128
MAP_ATOL = 1e-4
SNR_ATOL_DB = 1e-3
TESTDATA = Path(__file__).resolve().parent / "srsran_tpu_torch" / "testdata"
FIXTURE = TESTDATA / "ue_dl_siso_20mhz.npz"
FIXTURE_DYN = TESTDATA / "ue_dl_dynamic_20mhz.npz"
# published peaks of one H100 SXM: HBM bytes/s, fp32 operations/s outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# add/max operations of the recursion: a training step runs one alpha and
# one beta step (2 x (2 + 16 + 8)); a window position runs an alpha step
# (26), the beta branches (18) and maxima (8), and one posterior (16 + 14 + 1)
OPS_TRAIN_STEP = 52
OPS_WINDOW_POS = 83
DYN_KS = {6144: (6144, 6080, 5824, 4800, 3136, 2112, 512, 40),
          2112: (2112, 2048, 1056, 528, 1408, 40),
          768: (768, 512, 384, 40)}


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


def queued_ms(fn, n: int) -> float:
    """Mean device milliseconds of fn()'s kernels over n runs queued behind a
    busy card (a spin of some tens of milliseconds), so that a host slower
    than the kernel does not count; fn must not synchronize."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(5e7))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def map_inputs(k: int, ncb: int, seed: int, device):
    """(lx, lz, beta_k) of one MAP pass over ncb random codeblocks of size k."""
    from srsran_tpu_torch.phy.fec.turbo import _beta_tail

    rng = np.random.default_rng(seed)
    lx, lz = (torch.from_numpy(4.0 * rng.standard_normal((ncb, k)).astype(np.float32)).to(device)
              for _ in range(2))
    lxt, lzt = (torch.from_numpy(4.0 * rng.standard_normal((ncb, 3)).astype(np.float32)).to(device)
                for _ in range(2))
    return lx, lz, _beta_tail(lxt, lzt)


def wall_ms(fn, n: int) -> float:
    """Mean host milliseconds of fn() over n runs, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def map_bound(lx, lz, beta_k, layout, k_vec=None):
    """(bound_ms, bound_by) of one MAP pass on these inputs: the larger of
    the bytes the function must move (lx, lz, beta_k and k_vec read once,
    the (B, K) posteriors written once) over the card's memory rate and its
    add/max operations over the fp32 rate."""
    nw, lw, T = layout
    ins = [lx, lz, beta_k] + ([] if k_vec is None else [k_vec])
    nbytes = sum(t.numel() * t.element_size() for t in ins) + lx.numel() * 4
    ops = lx.shape[0] * nw * (OPS_TRAIN_STEP * T + OPS_WINDOW_POS * lw)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def dyn_map_inputs(k_max: int, ks, seed: int, device):
    """Inputs of one dynamic-K MAP pass: codeblocks of the sizes `ks` in
    K_max buffers, zero LLRs beyond each K, random exact tail betas.
    Returns (lx, lz, beta_k, k_vec (B,) int32, below_k (B, K_max) bool)."""
    rng = np.random.default_rng(seed)
    k_vec = torch.tensor(ks, device=device, dtype=torch.int32)
    below_k = torch.arange(k_max, device=device)[None, :] < k_vec[:, None]
    lx, lz = (torch.from_numpy(4.0 * rng.standard_normal((len(ks), k_max)).astype(np.float32))
              .to(device) * below_k for _ in range(2))
    beta_k = torch.from_numpy(4.0 * rng.standard_normal((len(ks), 8)).astype(np.float32)).to(device)
    return lx, lz, beta_k, k_vec, below_k


def render(cell, ofdm, sf_idx: int, grant, tb: np.ndarray, rng, amp: float) -> np.ndarray:
    """One noisy subframe (1, sf_len) complex64 carrying `tb` under `grant`,
    from the port's host transmitter (CFI 1)."""
    from srsran_tpu_torch.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu_torch.phy.ofdm import ofdm_tx_sf
    from srsran_tpu_torch.phy.phch.pdsch import pdsch_encode_np

    grid = put_crs_np(pdsch_encode_np(cell, sf_idx, 1, grant, tb), cell, sf_idx)
    rx = ofdm_tx_sf(ofdm, torch.from_numpy(grid)).numpy()
    rx = rx + amp * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    return rx.astype(np.complex64)


def load_slice(dev):
    """The UE DL SISO slice at full width: the fixture's cell and grant
    (100 PRB, MCS 26), `ue_dl_subframe` for them, and B subframes of samples
    on `dev`: the two stored ones, then the stored transmit signal with
    seeded noise.  Returns (fx, cell, grant, fn, samples)."""
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.modem import Mod
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant
    from srsran_tpu_torch.pipeline import ue_dl_subframe

    fx = np.load(FIXTURE)
    nof_prb = int(fx["nof_prb"])
    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=int(fx["cell_id"]))
    grant = DlGrant(prb=tuple(range(nof_prb)), mod=Mod.QAM64, tbs=int(fx["tbs"]))
    fn = ue_dl_subframe(cell, int(fx["sf_idx"]), int(fx["cfi"]), grant,
                        int(fx["max_iterations"]), device=dev)
    tx = fx["tx"]
    rng = np.random.default_rng(int(fx["seed"]) + 2)
    shape = (B - 2, 1, tx.size)
    noisy = (tx[None, None, :] + float(fx["noise_amp"]) * (
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)
    samples = torch.from_numpy(np.concatenate([fx["rx"], noisy])).to(dev)
    return fx, cell, grant, fn, samples


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from srsran_tpu_torch.device import require_cuda
    from srsran_tpu_torch.phy.fec import turbo_cuda
    from srsran_tpu_torch.phy.fec.turbo import map_pass_plain, pass_layout
    from srsran_tpu_torch.phy.ofdm import OfdmConfig
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu_torch.pipeline_dynamic import DynamicUeDl

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
    usage = subprocess.run([turbo_cuda._nvcc(), *turbo_cuda.NVCC_FLAGS[:4], "-Xptxas", "-v", "-cubin",
                            "-o", str(lib.with_suffix(".cubin")), str(turbo_cuda.SOURCE)],
                           capture_output=True, text=True, check=True).stderr
    kernels = re.findall(
        r"Compiling entry function '\w*kernelILb(\d)E.*?frame, (.*?spill loads).*?Used (\d+) registers",
        usage, re.DOTALL)
    check(len(kernels) == 2, f"ptxas reported {len(kernels)} kernels, expected 2")
    for dyn, spills, regs in kernels:
        print(f"build: {'dynamic-K' if dyn == '1' else 'static'} mode {regs} registers, {spills}")

    # phase 3: kernel against plain on the card
    max_err = 0.0
    headline = None
    for k, ncb, layout in ((5632, 88, None), (5632, 1408, None), (512, 64, None), (40, 300, None),
                           (6080, 16, None), (6144, 16, None), (135, 64, (3, 45, 32))):
        lx, lz, beta_k = map_inputs(k, ncb, seed=k + ncb, device=dev)
        nw, lw, T = layout or pass_layout(k)
        got = turbo_cuda.map_pass(lx, lz, beta_k, nw, lw, T)
        ref = map_pass_plain(lx, lz, beta_k, k, layout=layout)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        same_bits = bool(torch.equal(got > 0, ref > 0))
        cpb, smem = turbo_cuda.launch_plan(ncb, nw, lw, torch.cuda.get_device_properties(dev)
                                           .multi_processor_count)
        print(f"map K={k} codeblocks={ncb} nw={nw} lw={lw} T={T} ({cpb} codeblocks and {smem} B "
              f"of shared memory a block): max_abs_err {err:.3g}, hard bits identical {same_bits}")
        check(bool(torch.isfinite(got).all()), f"non-finite posteriors at K={k}")
        check(err <= MAP_ATOL and same_bits, f"kernel disagrees with plain at K={k}")
        max_err = max(max_err, err)
        if ncb == 1408:
            headline = (lx, lz, beta_k, (nw, lw, T))
    max_err_dyn = 0.0
    for k_max, ks in DYN_KS.items():
        ks = ks * (32 // len(ks))
        lx, lz, beta_k, k_vec, below_k = dyn_map_inputs(k_max, ks, seed=k_max, device=dev)
        nw, lw, T = pass_layout(k_max)
        got = turbo_cuda.map_pass(lx, lz, beta_k, nw, lw, T, k_vec=k_vec)
        ref = map_pass_plain(lx, lz, beta_k, k_max, k_vec)
        torch.cuda.synchronize()
        err = float((got - ref)[below_k].abs().max())
        same_bits = bool(torch.equal((got > 0)[below_k], (ref > 0)[below_k]))
        print(f"map dyn K_max={k_max} codeblocks={len(ks)} K={sorted(set(ks))} nw={nw} lw={lw} "
              f"T={T}: max_abs_err below K {err:.3g}, hard bits identical {same_bits}")
        check(bool(torch.isfinite(got[below_k]).all()), f"non-finite posteriors at K_max={k_max}")
        check(err <= MAP_ATOL and same_bits, f"dyn kernel disagrees with plain at K_max={k_max}")
        max_err_dyn = max(max_err_dyn, err)

    # phase 4: the slice at full width
    fx, cell, grant, fn, samples = load_slice(dev)
    tbs, nof_prb = grant.tbs, cell.nof_prb
    tb_tx = torch.from_numpy(np.unpackbits(fx["tb_packed"], count=tbs)).to(dev)
    ref_tb = torch.from_numpy(np.unpackbits(fx["ref_tb_packed"], axis=-1, count=tbs)).to(dev)

    turbo_cuda.LAUNCHES = turbo_cuda.LAUNCHES_DYN = 0
    tb, ok, snr_db = fn(samples)
    torch.cuda.synchronize()
    launches = turbo_cuda.LAUNCHES - turbo_cuda.LAUNCHES_DYN
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
    lx, lz, beta_k, layout = headline
    kern_ms = queued_ms(lambda: turbo_cuda.map_pass(lx, lz, beta_k, *layout), 20)
    eager_ms = cuda_ms(lambda: turbo_cuda.map_pass(lx, lz, beta_k, *layout), 20)
    plain_ms = cuda_ms(lambda: map_pass_plain(lx, lz, beta_k, lx.shape[1]), 3)
    bound_ms, bound_by = map_bound(lx, lz, beta_k, layout)
    print(f"slice: {slice_ms:.3f} ms per B={B} batch, {mbps:.1f} Mbps of CRC-passing TBs")
    print(f"map pass at {tuple(lx.shape)}: kernel {kern_ms:.4f} ms ({eager_ms:.4f} ms launched "
          f"one by one from an idle queue), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"by {bound_by}")
    # other shapes: one block, one wave of three blocks an SM, other K
    for k, ncb in ((6144, 1), (6144, 396), (6144, 1408), (2048, 1408), (512, 4096), (40, 4096)):
        ins = map_inputs(k, ncb, seed=1, device=dev)
        ms = queued_ms(lambda: turbo_cuda.map_pass(*ins, *pass_layout(k)), 50)
        print(f"map pass at ({ncb}, {k}): kernel {ms:.4f} ms, bound "
              f"{map_bound(*ins, pass_layout(k))[0]:.4f} ms")

    # phase 6: the dynamic-grant decode at full width
    ue = DynamicUeDl(cell, cfi=1, max_iterations=int(fx["max_iterations"]))
    check(ue.device == dev, "DynamicUeDl did not take the card by default")
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    turbo_cuda.LAUNCHES = turbo_cuda.LAUNCHES_DYN = 0

    def decode_and_check(tag, sf_idx, grant, tb_sent, rx, soft=None, want_ok=True):
        tb_hat, ok_, soft_, n_it = ue.decode(rx, sf_idx, grant, soft)
        check(tb_hat.shape == (grant.tbs,) and tb_hat.dtype == np.uint8, f"{tag}: TB shape/dtype")
        check(soft_.device == dev and bool(torch.isfinite(soft_).all()), f"{tag}: softbuffer")
        check(ok_ == want_ok, f"{tag}: crc_ok {ok_}, expected {want_ok}")
        if want_ok:
            check(bool((tb_hat == tb_sent).all()), f"{tag}: TB differs from the sent one")
        return tb_hat, soft_, n_it

    # (a) scheduler-style random grant mix
    rng = np.random.default_rng(7)
    built_at, n_mix = [], 0
    for i in range(40):
        sf_idx, mcs = int(rng.integers(0, 10)), int(rng.integers(0, 29))
        l = int(rng.integers(1, nof_prb + 1))
        s0 = int(rng.integers(0, nof_prb + 1 - l))
        g = DlGrant(prb=tuple(range(s0, s0 + l)), mod=dl_mcs_to_mod(mcs),
                    tbs=dl_tbs(mcs, l), rnti=0x46)
        tb_sent = rng.integers(0, 2, g.tbs).astype(np.uint8)
        rx = render(cell, ofdm, sf_idx, g, tb_sent, rng, 0.05)
        decode_and_check(f"mix {i} (sf {sf_idx}, MCS {mcs}, PRB {s0}+{l}, tbs {g.tbs})",
                         sf_idx, g, tb_sent, rx)
        built_at.append(ue.total_compiles)
        n_mix += 1
    print(f"dynamic: grant mix {n_mix}/{n_mix} TBs ok; stage keys built {ue.stats}")
    check(ue.stats["compiles_a"] <= 10, "more stage A keys than subframes")
    check(ue.stats["compiles_b"] <= 15 and ue.stats["compiles_c"] <= 14,
          "stage keys exceed the bucket grid")
    check(built_at[-1] - built_at[-len(built_at) // 4] <= 2,
          f"the last quarter of the mix still builds stages: {built_at}")

    # (b) MCS 28 on 100 PRB
    g28 = DlGrant(prb=tuple(range(nof_prb)), mod=dl_mcs_to_mod(28), tbs=dl_tbs(28, nof_prb), rnti=0x46)
    tb28 = rng.integers(0, 2, g28.tbs).astype(np.uint8)
    rx28 = render(cell, ofdm, 3, g28, tb28, rng, 0.05)
    _, _, n_it28 = decode_and_check("MCS 28", 3, g28, tb28, rx28)
    print(f"dynamic: MCS 28 on {nof_prb} PRB, tbs {g28.tbs}: ok, {n_it28} iterations")

    # (c) the headline grant: the TB of the static path on the same samples
    tb_h, _, n_it_h = decode_and_check("headline grant", int(fx["sf_idx"]), grant, tb_tx.cpu().numpy(),
                                       fx["rx"][0], want_ok=bool(fx["ref_crc_ok"][0]))
    check(bool((tb_h == tb[0].cpu().numpy()).all()), "dynamic and static paths give different TBs")
    print(f"dynamic: headline grant equals ue_dl_subframe's TB, {n_it_h} iterations")

    # (d) HARQ: rv 0 alone fails at low SNR, rv 2 combines and decodes
    tbs_h = dl_tbs(16, nof_prb)
    tb_harq = rng.integers(0, 2, tbs_h).astype(np.uint8)
    g0 = DlGrant(prb=tuple(range(nof_prb)), mod=dl_mcs_to_mod(16), tbs=tbs_h, rv=0)
    g2 = DlGrant(prb=tuple(range(nof_prb)), mod=dl_mcs_to_mod(16), tbs=tbs_h, rv=2)
    _, soft, _ = decode_and_check("HARQ rv 0", 1, g0, tb_harq,
                                  render(cell, ofdm, 1, g0, tb_harq, rng, 0.42), want_ok=False)
    decode_and_check("HARQ rv 2", 2, g2, tb_harq,
                     render(cell, ofdm, 2, g2, tb_harq, rng, 0.42), soft=soft)
    print("dynamic: HARQ rv 0 fails alone, rv 2 combines and decodes")

    # (e) stored grants with the reference's results
    fd = np.load(FIXTURE_DYN)
    ue_fx = DynamicUeDl(cell, cfi=1, max_iterations=int(fd["max_iterations"]))
    for i in range(len(fd["mcs"])):
        l, s0, mcs = int(fd["prb_len"][i]), int(fd["prb_start"][i]), int(fd["mcs"][i])
        g = DlGrant(prb=tuple(range(s0, s0 + l)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, l),
                    rnti=int(fd["rnti"]))
        tb_hat, ok_, _, n_it = ue_fx.decode(fd["rx"][i], int(fd["sf_idx"][i]), g)
        ref_tb = np.unpackbits(fd["ref_tb_packed"][i], count=g.tbs)
        check(ok_ == bool(fd["ref_crc_ok"][i]) and n_it == int(fd["ref_n_it"][i]),
              f"stored grant {i}: crc_ok {ok_}, {n_it} iterations; reference "
              f"{bool(fd['ref_crc_ok'][i])}, {int(fd['ref_n_it'][i])}")
        # a TB that does not converge has no bits to hold: rounding
        # differences grow from one iteration to the next
        check(not ok_ or bool((tb_hat == ref_tb).all()),
              f"stored grant {i}: TB bits differ from the reference")
    print(f"dynamic: {len(fd['mcs'])} stored grants give the reference's crc_ok "
          f"{fd['ref_crc_ok'].tolist()}, iterations {fd['ref_n_it'].tolist()} and, where the CRC "
          f"passes, TB bits")
    torch.cuda.synchronize()
    launches_dyn = turbo_cuda.LAUNCHES_DYN
    check(launches_dyn > 0, "the dynamic path did not launch the dynamic-K kernel mode")
    check(turbo_cuda.LAUNCHES == launches_dyn, "the dynamic path launched the static mode")
    print(f"dynamic: {ue.stats['ttis'] + ue_fx.stats['ttis']} TTIs, "
          f"dynamic-K map launches {launches_dyn}")

    # phase 7: times of the dynamic path
    g6 = DlGrant(prb=tuple(range(47, 53)), mod=dl_mcs_to_mod(5), tbs=dl_tbs(5, 6), rnti=0x46)
    tb6 = rng.integers(0, 2, g6.tbs).astype(np.uint8)
    rx6 = torch.from_numpy(render(cell, ofdm, 3, g6, tb6, rng, 0.05)).to(dev)
    rx28_d = torch.from_numpy(rx28).to(dev)
    for tag, g, rx in ((f"MCS 28 {nof_prb} PRB (tbs {g28.tbs})", g28, rx28_d),
                       (f"MCS 5 6 PRB (tbs {g6.tbs})", g6, rx6)):
        ue.decode(rx, 3, g)  # warm the tables of this grant
        before = turbo_cuda.LAUNCHES_DYN
        dev_ms = cuda_ms(lambda: ue.decode(rx, 3, g), 10)
        per_tti = (turbo_cuda.LAUNCHES_DYN - before) / 10
        host_ms = wall_ms(lambda: ue.decode(rx, 3, g), 10)
        print(f"dynamic: {tag}: {dev_ms:.3f} ms per TTI by CUDA events, {host_ms:.3f} ms host "
              f"wall, {per_tti:g} map launches per TTI")
    lx_d, lz_d, beta_d, k_vec_d, _ = dyn_map_inputs(6144, DYN_KS[6144] * 2, seed=1, device=dev)
    layout_d = pass_layout(6144)

    def dyn_pass():
        return turbo_cuda.map_pass(lx_d, lz_d, beta_d, *layout_d, k_vec=k_vec_d)

    kern_dyn_ms = queued_ms(dyn_pass, 100)
    static_small_ms = queued_ms(lambda: turbo_cuda.map_pass(lx_d, lz_d, beta_d, *layout_d), 100)
    eager_dyn_ms, host_dyn_ms = cuda_ms(dyn_pass, 100), wall_ms(dyn_pass, 100)
    plain_dyn_ms = cuda_ms(lambda: map_pass_plain(lx_d, lz_d, beta_d, 6144, k_vec_d), 3)
    bound_dyn_ms, bound_dyn_by = map_bound(lx_d, lz_d, beta_d, layout_d, k_vec_d)
    print(f"map dyn pass at {tuple(lx_d.shape)}: kernel {kern_dyn_ms:.4f} ms (static mode on "
          f"the same codeblocks {static_small_ms:.4f} ms; launched one by one {eager_dyn_ms:.4f} "
          f"ms by CUDA events, {host_dyn_ms:.4f} ms of host time a call), plain "
          f"{plain_dyn_ms:.3f} ms, bound {bound_dyn_ms:.5f} ms by {bound_dyn_by}")

    common = {"route": "cuda", "source": "srsran_tpu_torch/csrc/map_window.cu", "library_ms": None}
    print(json.dumps({"kernels": [
        dict(common, name="map_window", replaces="srsran_tpu/phy/fec/turbo_pallas.py:99",
             launches=launches, max_abs_err=max_err, ms=kern_ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by),
        dict(common, name="map_window_dyn", replaces="srsran_tpu/phy/fec/turbo_pallas.py:232",
             launches=launches_dyn, max_abs_err=max_err_dyn, ms=kern_dyn_ms,
             plain_ms=plain_dyn_ms, bound_ms=bound_dyn_ms, bound_by=bound_dyn_by)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
