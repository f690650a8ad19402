#!/usr/bin/env python
"""Smoke test of the PyTorch port (`srsran_tpu_torch`) on one NVIDIA GPU.

Run from the repo root:  python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the MAP kernel (csrc/map_window.cu) from the sources, timed,
     and print its registers and spills as ptxas reports them; build the
     native library (`native.py`: the sample ring and the log backend);
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
     version per pass at 16 codeblocks of K_max 6144;
  8. the 2x2 MIMO decode at full width (`bench.py` `bench_ue_dl_mimo`) —
     100 PRB, 2 ports, two codewords of MCS 26 QAM64, pmi 1, the bench's 2x2
     channel, noise amplitude 0.045, B=64 — through `ue_dl_subframe_mimo`:
     the stored reference subframes of `testdata/ue_dl_mimo_20mhz.npz` give
     the reference's crc_ok, TB bits and snr_db, every CRC-passing TB equals
     the sent one, ms per batch and Mbps; then one call of the QAM256 row
     (MCS 27, tbs 97896, 16 codeblocks of K=6144 a codeword, amplitude 0.016);
  9. the eNB DL encoder at full width (`bench_enb_dl`): B=64 TBs of 61664
     bits through `enb_dl_subframe_encode`; the coded bits read back from
     the samples equal `dlsch_encode_np` for two of them; ms per batch and
     Mbps; then the loopback: those subframes plus noise 0.09 through
     `ue_dl_subframe` give back the TBs;
  10. the eNB UL decode at full width (`bench_enb_ul`): PRB 1..96 of 100,
     MCS 20 16QAM (tbs 40576, 7 codeblocks of K=5824), B=128, amplitude 0.09,
     through `enb_ul_subframe`, with the stored reference subframes of
     `testdata/enb_ul_20mhz.npz`, the same checks and times;
  11. `DynamicEnbUl` on the 100 PRB cell: a seeded PUSCH grant mix (MCS 0-23
     x valid allocations x subframes), HARQ rv 0 → rv 2, the stored grants of
     `testdata/enb_ul_dynamic_20mhz.npz`, stage keys, ms per TTI; and two
     transmit-diversity and two spatial-multiplexing grants through
     `DynamicUeDl` behind the 2x2 channel;
  12. (run last, after phases 13-21, 30-31 and 43, whose windows give it its shapes) the
     kernel's dynamic-K mode at every launch shape those phases gave it:
     each dense-slot bucket N that a window of this run reached (N x K_max
     6144, K_i the window's own per-slot sizes, 40 in the unused slots),
     and N = 384 and 768 with K_i drawn over the 188 codeblock sizes,
     against the plain version (compared below each K_i), ms per pass with
     the launches queued, bound and share of bound;
  13. `WindowedUeDl` at full width (`bench.py` `bench_window_rtf`): 100 PRB,
     1 port, W = 128, a 16-grant mix (MCS 0-26 x 4-100 PRB x subframes 0-9)
     repeated to W with fresh noise of amplitude 0.09 per TTI (the bench
     repeats its 16 noisy subframes) and one window in flight (the bench
     keeps 4), 6 iterations, int8 ingest: every CRC-passing TB is the sent one and at least 124 of
     128 pass; a second window with a fresh mix through the same stage
     functions; HARQ across windows (rv 0 fails in one window, its
     softbuffer block moves to another row of the next, rv 2 combines and
     passes); a transmit-diversity window at 2 ports (W = 32);
  14. `WindowedUeDlMimo` (`bench_window_mimo_rtf`): 2 ports, the bench's 2x2
     channel, W = 64, 2 x MCS 4-24 on 20-100 PRB, PMI 0-2 and one CDD grant,
     amplitude 0.045, checked per codeword;
  15. `WindowedEnbUl` (`bench_window_ul_rtf`): W = 64, widths 9/25/50/96 PRB,
     MCS 0-23, amplitude 0.05;
     for each engine: ms per window and per TTI by CUDA events and on the
     host clock (warm medians), the real-time factor (1 ms over ms per TTI),
     the host's ingest quantisation alone, `stage_times` A/B/C, kernels per window and the device's busy share
     (`torch.profiler`), dense slots real and bucketed, MAP launches per
     window;
  16. the stored reference windows of `testdata/window_*_20mhz.npz` (W = 4,
     one per engine) give the reference's stage C key, CRC flags, iteration
     counts and, where the CRC passes, TB bits;
  17. the generate windows at full width (`bench.py` `bench_window_dlgen_rtf`,
     `bench_window_ulgen_rtf`): `WindowedEnbDl` (MCS 0-26 on 4-100 PRB),
     `WindowedUeUl` (widths 9/25/50/96, MCS 0-23) and `WindowedEnbDlMimo` (2 x
     MCS 4-24 on 20-100 PRB, PMI 0-2 and a CDD grant), W = 64, a 16-grant mix
     repeated: no MAP launch, finite samples, the codewords of four rows
     equal `dlsch_encode_np`, and the stored W = 4 window of
     `testdata/window_gen_*.npz` gives the reference's codewords bit for bit
     and its samples within 2e-6 absolute; ms per window, `stage_times`;
  18. the loopbacks, generator → `window_channel` → decode engine without the
     baseband leaving the card (`bench_window_loopback_rtf`,
     `bench_window_ul_loopback_rtf`): DL W = 128 (h 0.95-0.2j) into
     `WindowedUeDl`, UL W = 128 (h 0.9+0.25j) into `WindowedEnbUl`, 2x2 W = 64
     behind H_2X2 into `WindowedUeDlMimo`, noise 0.02, W fresh grants, 6
     iterations: every TB decodes and equals the sent one;
     for the windows of phases 17 and 18: ms per window and per TTI by CUDA
     events and on the host clock (warm medians after two warm calls), the
     real-time factor, kernels per window, the device's busy share and MAP
     launches per window;
  19. the DL control loopback at full width (`bench.py`
     `bench_stack_window_rtf`'s W = 64, at 100 PRB, cell 301, CFI 2): four
     C-RNTIs; per TTI a `Dci1A` DL assignment at aggregation 4 with its PDSCH
     TB, a `Dci0` for another RNTI at aggregation 2 (both in their RNTIs'
     search spaces, apart), one PHICH and, on subframe 0, the MIB, rendered
     by `enb_ctrl_overlay` into `WindowedEnbDl(template="full", overlay=)`;
     `window_channel` (h 0.95-0.2j, noise 0.02); `WindowedUeFrontEnd` with
     device-resident ingest, `realize`, `window_blind_search` over the four
     RNTIs in every TTI (one Viterbi on the card); every sent DCI found with
     its bits (found DCIs that were not sent are counted), the PCFICH gives
     CFI 2, every PHICH ACK and MIB right, the grants unpacked from the found
     DCIs go through `dispatch_data` and every TB comes back; the Viterbi on
     the card gives the CPU's bits for the whole hypothesis batch;
  20. the UL control loopback: `WindowedUeUl(pucch=)` with PUSCH grants and
     format-1 ACKs (1 and 2 bits on two resources), `window_channel` (h
     0.9+0.25j, noise 0.02), `WindowedEnbUlFrontEnd(edge_prbs=4)`,
     `realize_pucch`, `pucch_prb_grid`, `pucch_format1_decode_batch`: every
     ACK right with metric > 0.25, each PUSCH PRB above every empty PRB in
     power, every TB back from `dispatch_data` and equal to the inner
     engine's own pass over the samples;
     for both: ms per window and per TTI (host clock, synchronised, and CUDA
     events), the fenced spans of the front end, blind search host part,
     Viterbi, collect, data and results, kernels per window, the busy share,
     the Viterbi's calls, kernels and device ms;
  21. the stored control windows of `testdata/window_ctrl_{ue_dl,enb_ul}.npz`
     (W = 4, 100 PRB, CFI 2) decoded on the card: the reference's control
     REs, band edges and PRB powers within 2e-5 of the largest magnitude,
     its found DCIs, PHICH decisions, PUCCH format-1 and format-2 bits
     (metrics within 1e-3), CRC flags, iteration counts and TB bits;
  22. the golden vectors on the card (`tests/vectors/`, the four checks of
     `tests/test_golden_vectors.py`): the MIB of signal.1.92M.dat (2 ports,
     SFN offset 0, sfn 28, 50 PRB, the payload); on signal.1.92M.amar.dat
     `cell_search` (PCI 1, sf 0, psr > 10), CFI 3 in all ten subframes with
     the correlation margin, and the SI-RNTI SIBs of subframes 5 and 2;
  23. the stored received frame `testdata/ue_dl_frame_100prb.npz` (100 PRB,
     cell 301, CFI 2, a C-RNTI 1A grant per subframe; CFO, timing offset and
     noise; int8 I/Q): `cell_search`, `mib_search`, then `UeSync` fed one
     subframe a push and every popped subframe through
     `ue_dl_decode_subframe`, against the reference's results
     (`check_ue_dl_frame`);
  24. the 20 MHz link: `EnbApp` (100 PRB, cell 301, MCS 26, CFI 2, a full
     buffer of 1400-byte SDUs) → h 0.9·e^{0.3j}, CFO 0.12, 12345 samples of
     timing offset, AWGN 0.01 → `UeApp` (CFI from the PCFICH), one subframe
     a push over 5 frames (`link_run`): every decoded TB CRC-clean, the SDUs
     an unbroken run in order over every TTI from the first complete frame
     in TRACK, `UeSync` never leaving TRACK; FIND ms, ms per TRACK subframe
     (host and CUDA events, warm medians) and the real-time factor,
     `EnbApp.run_tti` ms, the sync step and the fenced spans of one subframe
     (`ue_dl_steps`: OFDM + chest, PCFICH, blind search host part, Viterbi,
     collect, PDSCH), kernels and busy share, the Viterbi's calls and
     kernels, MAP launches;
  25. (after 22-24 and 26-32) the static kernel against `map_pass_plain`
     at every (B, K) that phases 22-24, 26-30 and 32 launched it at
     (`turbo_cuda.SHAPES`; phase 32's from its processes' result lines),
     with ms, bound and share of bound;
  26. the stored UL subframes `testdata/enb_ul_100prb.npz` (100 PRB, cell
     301, int8 I/Q; `check_enb_ul`): a plain PUSCH subframe and an SRS
     subframe (shortened PUSCH with ACK, RI and the 30-bit subband CQI; the
     SRS over PRB 2..97) through `enb_ul_decode_pusch` and `srs_estimate`,
     PUCCH formats 1a/2/3 through `enb_ul_decode_pucch`, a PRACH subframe
     through `prach_detect`, and `refsignal_dl_sync_run` on phase 23's
     stored frame under its PCI and a wrong one, against the reference's
     results;
  27. the 20 MHz UL link (`ul_link_run`, 4 frames): UE A's PUSCH (MCS 20
     on PRB 2..97, PRB 8..97 in the PRACH subframe) with UCI every TTI and
     the SRS on subframe 3, UEs B/C/D on PUCCH formats 1a (SR on subframe
     7), 2 and 3, UE E's preamble 17 on subframe 1, each UE through its own
     EPA `Channel`, delay and gain, summed with AWGN on the card; the eNB
     runs `enb_ul_receive` (`enb_ul_fft`, PUCCH, PRACH, SRS,
     `enb_ul_decode_pusch` with the expected UCI) per subframe, and every
     TB, UCI value, PUCCH bit, the preamble and the SRS SNR are gated; ms
     per UL subframe (host and CUDA events, warm medians), the real-time
     factor, the fenced spans of `enb_ul_steps` with kernels and device ms,
     `ue_ul_encode` ms per UE, MAP launches and the busy share;
  28. the stored reference attach `testdata/full_stack_attach_100prb.json`
     (100 PRB, cell 301, MCS 20, SRS and SR on, no noise): the port's
     `EnbStack`/`UeStack` on the card through `StackRun` — attach, 4 DL
     packets of 1400 bytes, 3 UL of 1000 — give the reference's stats, RRC
     and NAS states in every TTI, its IP, IMSIs and packets;
  29. the 20 MHz attached link (`stack_link_run`): one `EnbStack` and two
     `UeStack`s (preambles 11 and 29, the second 40 TTIs later) through EPA
     `Channel`s (the common DL, each UE's UL) with AWGN 0.01; both attach
     with AS security on, distinct C-RNTIs and IPs, two PRACH detections;
     20 TTIs of 1400-byte DL packets a UE a TTI, 20 of 1000-byte UL ones,
     every packet through in order and intact, no PUCCH ACK or SR read
     where its UE sent none (`PucchWatch`); warm medians over the
     attached TTIs of ms per TTI of each end (host clock, synchronised, and
     CUDA events) and their DL/UL halves, the real-time factors, host
     synchronisations, kernels and busy share of one TTI, MAP launches per
     TTI, Mbps of IP payload each way;
  30. phase 28's script (plus 2 DL and 2 UL packets) with
     `dynamic_phy=True` and with `windowed_phy=True, phy_window=4` on both
     ends (`stack_planes_run`): the same gates, each plane used at both
     ends; ms per TTI and MAP launches by mode.  Phase 25 then also takes
     the static shapes of phases 28-30, and phase 12 the windows of phase
     30 (`note_shape`) and the dynamic plane's launch shapes;
  31. (after 30, before 25 and 12) the windowed control-plane stack
     (`bench.py` `bench_stack_window_rtf`), at the bench's 25 PRB and at 100
     PRB (`stack_window_run`): `WindowedCtrlEnb` and `WindowedCtrlUe` (cell
     7, MCS 8, W = 64) over `WindowedDeviceLoopback` at 30 dB; the UE
     attaches (at most 9000 TTIs), then the bench's load (48 DL packets of
     400 B and one UL packet of 400 B every 64 TTIs) for 20 warm and 10
     timed windows, then 2 windows with each end's `run_tti` fenced, then a
     drain: every packet once and in order within 40 windows of the offer's
     end, RRC active, control windows run, no static MAP launch; ms per TTI
     (host clock after a synchronize, and CUDA events), the real-time
     factor, the attach's TTI and seconds, IP Mbps each way of air and wall
     time, kernels per TTI and the busy share (`torch.profiler`, one
     window), `map_window_dyn` launches and Viterbi calls per window, and
     the fenced `run_tti` ms of each end at the window positions that
     dispatch or realise a window against the quiet ones.  Phase 12 takes
     its windows' shapes.
  32. (after 31, before 25 and 12) the three-process `run_lte` at 100 PRB
     (`run_lte_3proc`): `python -m srsran_tpu_torch.apps.run_lte_3proc` as
     three child processes on free ports, the EPC (host only), the eNB and
     the UE on the card, S1AP on length-framed TCP, GTP-U on UDP, the PHY's
     complex64 subframes in lockstep over TCP, the reference test's traffic
     (12 DL and 6 UL packets) for 12 s from the first exchange: the UE
     registered, the EPC attached the one IMSI, at least 6 DL and 3 UL
     packets through; each PHY process's device, MAP launches by mode and
     launch shapes (phase 25 takes the static ones), ms per lockstep TTI and
     each process's own part of it, the attach's TTI and seconds;
  33. `run_lte_demo` at 100 PRB in one process with its defaults: attached,
     every DL ping and UL pong through (its own prints); the attach TTI, the
     wall time and the MAP launches;
  34. `enb_app` -> `ue_app` over UDP through the native ring at the README's
     6 PRB and cell 42 (the eNB's 200 TTIs, a payload every 5): at least one
     SDU, each of the UE's SDUs (read from its MAC pcap) a payload the eNB
     wrote; the ring's dropped samples and the SDU count.  The native
     library is built in phase 2 from `native/` with g++;
  35-37. (after 34) the stored TDD attach, the 20 MHz TDD link, and the
     example scripts with the Wiener estimators and the resamplers.  The
     TDD link (36) runs three times: `TddConfig(2, 4)` with one UE and
     blind UL grants, then two UEs each, `TddConfig(2, 4)` with SRs and
     `TddConfig(1, 4)` with SRS and SRs; each run keeps its UEs attached
     (none released), receives DL HARQ ACKs from each UE with no PUCCH ACK
     read as DTX and no PUCCH ACK or SR read where none was sent, an SR
     from each UE where SRs are on, SRS measurements where the UEs sound,
     and gates frame structure 2 (PRACH on subframe 2, UEs silent outside
     U subframes, the eNB silent in U and past the DwPTS);
  38. (after 37, before 25 and 12) more than one device on the one card,
     whose eight positions of a mesh stand in for eight cards:
     `multi_carrier_ue_dl` at 100 PRB, MCS 26, 8 carriers (each its own TB
     and noise) over a 1-position and an 8-position mesh, identical TBs,
     total_ok 8, each TB the sent one; ms per call and carriers per card, and
     the weak-scaling curve over 1, 2, 4 and 8 positions (reported); the
     sharded `WindowedUeDl` at `bench.py` `bench_window_carriers`' shape (100
     PRB, W = 128 = 8 carriers x 16 TTIs, MCS 8/16/26, noise 0.05) bit for
     bit the unsharded window (packed results and softbuffer), ms per
     window both ways; `sharded_resample_fft` (2/1, halo 64) on one 30.72
     Msps frame over 8 positions against `resample_fft_blocks` within 1e-4
     and `sharded_fir` against one FIR over the stream within 1e-5; the 2-D
     (4 carriers x 2 subframes) step of `__graft_entry__.dryrun_multichip` at
     100 PRB.  With more than one card the carriers also run over distinct
     cards; with one, that branch prints as skipped;
  39. eMBMS: PMCH in a mixed-CP MBSFN subframe at 100 PRB (extended CP, 2
     normal-CP control symbols, the zero guard), MCS 9 and MCS 28 (at the
     TBS of 0.75 x N_PRB: its own exceeds the region's coded bits), through
     `ofdm_tx_sf_mbsfn` → AWGN 0.01 → `ofdm_rx_sf_mbsfn` → `pmch_decode`:
     the guard exactly zero, each TB CRC-ok and the sent one; ms per
     subframe;
  40. NB-IoT: `nbiot_acquire_raw` on a 40 ms seeded capture (offset 777, CFO
     0.02 subcarrier, AWGN), `nbiot_cell_search_scan` over 8 EARFCN captures
     (4 cells, 4 noise), NPDCCH → NPDSCH on the acquired grids of
     `npdsch_ue`'s stream, `nprach_detect` on three preambles and on noise,
     the `cell_search_nbiot` and `npdsch_ue` scripts' `--selftest`; the
     reference tests' gates; ms per step (host clock);
  41. sidelink: `pssch_ue` on each stored capture of `tests/vectors/`
     (the SCIs and TBs the reference script finds on it), the 100 PRB TM2
     chain whose TB reads c8e4, the four subframes of the 100 PRB UXM
     capture (4 SCIs, 4 CRC-ok 9528-bit TBs), a seeded PSSCH at 100 PRB MCS
     20; ms per subframe.  Phase 25 takes the static MAP shapes of 38, 39
     and 41, phase 12 the sharded windows of 38;
  42. (after 41, before 25 and 12) NR: the PDSCH DM-RS (`dmrs_nr.put_sf`,
     `get_sf`) at 52, 106 and 270 PRB for every valid configuration at
     durations 14, 12 and 9 over subframes 0-19 on batches of 64 seeded
     grids: `put_sf` bit for bit the same call on CPU tensors, `get_sf` of
     h·grid + noise within 1e-6 of it, a flat channel back as h within
     1e-5; ms per batch.  The coreless NR link (`NrAirLink`, host only):
     MIB and SIB1, the RRC setup, NAS both ways, 50 x 300 B DRB SDUs each
     way, the release; every byte back; TTIs to connect, ms per step.  The
     TTCN-3 system interface over localhost TCP with the port's `UeStack`
     on the card at 100 PRB: cell_cfg, attach, RAR, Msg3, the setup, the
     C-RNTI read back;
  43. (after 42, before 25 and 12) the grid-form rate match:
     `turbo_rm_positions_dev` for all 188 K x rv 0-3 (F = 0, and one filler
     case) against the host's `turbo_rm_indices`; a W = 8 window of 100 PRB
     grants at CFI 1, MCS 0-28 (B_CB 13, the codeblocks of MCS 28), codeword
     LLRs from the host encoder plus seeded noise, through
     `codeword_scatter_dev` and `codeword_d_fill_dev` (the two softbuffers
     within 1e-5), `qpp_dev`, `turbo_decode_dyn(perm_groups=)` and
     `tb_reassembly_gather_dev` with the TB CRC: every TB back and the
     sent one, bits, posteriors and iterations identical to the per-row
     form, the dynamic-K kernel launched and bit for bit its plain version
     on the window's first pass; ms per window by CUDA events and on the
     host clock.  Phase 12 takes its N = 8 x B_CB.
Every path is driven with the launch counts set to 0 just before and read
just after.  Prints one JSON line of kernel results, then as its last line
{"ok": true, "device": {...}}.  TF32 stays off: the channel-estimate
einsums and the CRC products keep full fp32.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

B = 128
MAP_ATOL = 1e-4
SNR_ATOL_DB = 1e-3
TESTDATA = Path(__file__).resolve().parent / "srsran_tpu_torch" / "testdata"
FIXTURE = TESTDATA / "ue_dl_siso_20mhz.npz"
FIXTURE_DYN = TESTDATA / "ue_dl_dynamic_20mhz.npz"
FIXTURE_MIMO = TESTDATA / "ue_dl_mimo_20mhz.npz"
FIXTURE_UL = TESTDATA / "enb_ul_20mhz.npz"
FIXTURE_UL_DYN = TESTDATA / "enb_ul_dynamic_20mhz.npz"
B_MIMO = B_ENCODE = 64
W_DL, W_DIV, W_MIMO, W_UL = 128, 32, 64, 64
# the 2x2 channel of `bench.py` `bench_ue_dl_mimo`: rx antenna x tx port
H_2X2 = np.array([[1.0 + 0.1j, 0.25 - 0.55j], [-0.45 + 0.3j, 0.95 + 0.05j]], np.complex64)
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


T0 = time.perf_counter()


def mark(what: str):
    """One line with the seconds since the script started, at a phase's start."""
    print(f"[{time.perf_counter() - T0:.1f} s] {what}", flush=True)


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


def batch_ms(fn) -> float:
    """Milliseconds of one fn() by CUDA events: two warm calls, then the
    median of 5 runs of 3 calls (a host that stalls once does not count)."""
    for _ in range(2):
        fn()
    return sorted(cuda_ms(fn, 3) for _ in range(5))[2]


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


def awgn(rng, x: np.ndarray, amp: float) -> np.ndarray:
    return (x + amp * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)


def render(cell, ofdm, sf_idx: int, grant, tb: np.ndarray, rng, amp: float) -> np.ndarray:
    """One noisy subframe (1, sf_len) complex64 carrying `tb` under `grant`,
    from the port's host transmitter (CFI 1)."""
    from srsran_tpu_torch.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu_torch.phy.ofdm import ofdm_tx_sf
    from srsran_tpu_torch.phy.phch.pdsch import pdsch_encode_np

    grid = put_crs_np(pdsch_encode_np(cell, sf_idx, 1, grant, tb), cell, sf_idx)
    return awgn(rng, ofdm_tx_sf(ofdm, torch.from_numpy(grid)).numpy(), amp)


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


def reset_launches():
    from srsran_tpu_torch.phy.fec import turbo_cuda

    turbo_cuda.LAUNCHES = turbo_cuda.LAUNCHES_DYN = 0


def read_launches() -> tuple[int, int]:
    """(static-mode launches, dynamic-K launches) since `reset_launches`."""
    from srsran_tpu_torch.phy.fec import turbo_cuda

    torch.cuda.synchronize()
    return turbo_cuda.LAUNCHES - turbo_cuda.LAUNCHES_DYN, turbo_cuda.LAUNCHES_DYN


def render_2x2(cell, sf_idx: int, grid: np.ndarray) -> np.ndarray:
    """The noise-free (2, sf_len) received subframe of a 2-port grid (CRS put
    in) behind H_2X2."""
    from srsran_tpu_torch.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu_torch.phy.ofdm import OfdmConfig, ofdm_tx_sf

    tx = ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True),
                    torch.from_numpy(put_crs_np(grid, cell, sf_idx))).numpy()
    return np.einsum("rp,pt->rt", H_2X2, tx).astype(np.complex64)


def load_mimo(dev, qam256: bool = False):
    """The 2x2 two-codeword decode at full width: the fixture's cell and
    grant (100 PRB, 2 x MCS 26, pmi 1) or the QAM256 row (2 x MCS 27),
    `ue_dl_subframe_mimo` for them, and B_MIMO subframes on `dev`: the sent
    TBs rendered by the port's host transmitter behind H_2X2 with seeded
    noise, the first two replaced by the stored ones (MCS 26 row).
    Returns (fx, cell, grant, fn, samples, (tb1, tb2))."""
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant2, pdsch_encode2_np
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu_torch.pipeline import ue_dl_subframe_mimo

    fx = np.load(FIXTURE_MIMO)
    nof_prb, sf_idx, cfi = int(fx["nof_prb"]), int(fx["sf_idx"]), int(fx["cfi"])
    cell = Cell(nof_prb=nof_prb, nof_ports=2, id=int(fx["cell_id"]))
    mcs, amp = (27, 0.016) if qam256 else (int(fx["mcs"]), float(fx["noise_amp"]))
    mod, tbs = dl_mcs_to_mod(mcs, qam256), dl_tbs(mcs, nof_prb, qam256)
    grant = DlGrant2(prb=tuple(range(nof_prb)), mod1=mod, tbs1=tbs, mod2=mod, tbs2=tbs,
                     pmi=int(fx["pmi"]))
    rng = np.random.default_rng(int(fx["seed"]) + 2 + qam256)
    if qam256:
        tbs_sent = tuple(rng.integers(0, 2, tbs).astype(np.uint8) for _ in range(2))
    else:
        tbs_sent = tuple(np.unpackbits(fx[k], count=tbs) for k in ("tb1_packed", "tb2_packed"))
    clean = render_2x2(cell, sf_idx, pdsch_encode2_np(cell, sf_idx, cfi, grant, *tbs_sent))
    rx = awgn(rng, np.tile(clean[None], (B_MIMO, 1, 1)), amp)
    if not qam256:
        rx[:2] = fx["rx"]
    fn = ue_dl_subframe_mimo(cell, sf_idx, cfi, grant, int(fx["max_iterations"]), device=dev)
    return fx, cell, grant, fn, torch.from_numpy(rx).to(dev), tbs_sent


def load_ul(dev):
    """The eNB UL decode at full width: the fixture's cell and grant (PRB
    1..96 of 100, MCS 20), `enb_ul_subframe` for them, and B subframes on
    `dev`: the two stored ones, then the sent TB rendered by the port's
    `ue_ul_encode` with seeded noise.  Returns (fx, cell, grant, fn, samples, tb)."""
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.ue.ue_ul import ue_ul_encode
    from srsran_tpu_torch.pipeline import enb_ul_subframe

    fx = np.load(FIXTURE_UL)
    cell = Cell(nof_prb=int(fx["nof_prb"]), nof_ports=1, id=int(fx["cell_id"]))
    grant = ul_grant(int(fx["mcs"]), int(fx["prb_start"]), int(fx["nof_prb_alloc"]), int(fx["rnti"]))
    tb = np.unpackbits(fx["tb_packed"], count=grant.tbs)
    tx = ue_ul_encode(cell, int(fx["sf_idx"]), pusch=(grant, tb), device=dev).cpu().numpy()
    rng = np.random.default_rng(int(fx["seed"]) + 2)
    rx = awgn(rng, np.tile(tx[None, None, :], (B, 1, 1)), float(fx["noise_amp"]))
    rx[:2] = fx["rx"]
    fn = enb_ul_subframe(cell, int(fx["sf_idx"]), grant, int(fx["max_iterations"]), device=dev)
    return fx, cell, grant, fn, torch.from_numpy(rx).to(dev), tb


def ul_grant(mcs: int, prb_start: int, nof_prb: int, rnti: int, rv: int = 0):
    from srsran_tpu_torch.phy.phch.pusch import UlGrant
    from srsran_tpu_torch.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod

    return UlGrant(prb_start=prb_start, nof_prb=nof_prb, mod=ul_mcs_to_mod(mcs),
                   tbs=tbs_lookup(ul_mcs_to_itbs(mcs), nof_prb), rv=rv, rnti=rnti)


def check_decoded(tag: str, tb, ok, sent: np.ndarray, min_ok: int):
    """A decoded batch: shapes and dtypes, every CRC-passing TB is the sent
    one, at least `min_ok` pass.  Returns the number that pass."""
    nb, tbs = tb.shape
    check(tbs == sent.size and tb.dtype == torch.uint8, f"{tag}: TB shape/dtype")
    check(tuple(ok.shape) == (nb,) and ok.dtype == torch.bool, f"{tag}: crc_ok shape/dtype")
    sent_d = torch.from_numpy(sent).to(tb.device)
    check(bool((tb[ok] == sent_d).all()), f"{tag}: a CRC-passing TB differs from the sent one")
    n_ok = int(ok.sum())
    check(n_ok >= min_ok, f"{tag}: only {n_ok}/{nb} TBs pass CRC")
    return n_ok


def check_stored(tag: str, tb, ok, snr_db, ref_tb_packed, ref_ok, ref_snr_db):
    """The first subframes of a batch against the stored reference results:
    the same crc_ok, the same bits where the CRC passes, snr_db within
    SNR_ATOL_DB."""
    n = len(ref_ok)
    got_ok = ok[:n].cpu().numpy()
    check(got_ok.tolist() == ref_ok.tolist(), f"{tag}: crc_ok {got_ok.tolist()} differs from "
          f"the reference's {ref_ok.tolist()}")
    ref_tb = np.unpackbits(ref_tb_packed, axis=-1, count=tb.shape[1])
    same = (tb[:n].cpu().numpy() == ref_tb).all(axis=1)
    check(bool(same[got_ok].all()), f"{tag}: TB bits differ from the reference")
    snr_err = float(np.abs(snr_db[:n].cpu().numpy() - ref_snr_db).max())
    check(snr_err <= SNR_ATOL_DB, f"{tag}: snr_db differs from the reference by {snr_err} dB")


def phase_mimo(dev) -> tuple[int, int]:
    """Phase 8.  Returns the (static, dynamic-K) launches of the two calls."""
    fx, cell, grant, fn, samples, (tb1, tb2) = load_mimo(dev)
    reset_launches()
    (g_tb1, ok1), (g_tb2, ok2), snr_db = fn(samples)
    launches = read_launches()
    check(bool(torch.isfinite(snr_db).all()), "mimo: non-finite snr_db")
    n_ok = (check_decoded("mimo cw 0", g_tb1, ok1, tb1, B_MIMO // 2)
            + check_decoded("mimo cw 1", g_tb2, ok2, tb2, B_MIMO // 2))
    for q, (tb, ok) in enumerate(((g_tb1, ok1), (g_tb2, ok2))):
        check_stored(f"mimo cw {q}", tb, ok, snr_db, fx[f"ref_tb{q + 1}_packed"],
                     fx["ref_crc_ok"][:, q], fx["ref_snr_db"])
    check(launches[0] > 0 and launches[1] == 0, f"mimo: map launches {launches}")
    ms = batch_ms(lambda: fn(samples))
    print(f"mimo: 100 PRB 2x2 2 x MCS 26 (2 x tbs {grant.tbs1}) B={B_MIMO}: codewords ok "
          f"{n_ok}/{2 * B_MIMO}, stored subframes as the reference (crc_ok "
          f"{fx['ref_crc_ok'].tolist()}), map launches {launches[0]}, {ms:.3f} ms per batch, "
          f"{n_ok * grant.tbs1 / (ms * 1e-3) / 1e6:.1f} Mbps of CRC-passing TBs")
    del fn, samples
    _, _, grant, fn, samples, (tb1, tb2) = load_mimo(dev, qam256=True)
    reset_launches()
    (g_tb1, ok1), (g_tb2, ok2), snr_db = fn(samples)
    launches_q = read_launches()
    n_ok = (check_decoded("mimo q256 cw 0", g_tb1, ok1, tb1, B_MIMO // 2)
            + check_decoded("mimo q256 cw 1", g_tb2, ok2, tb2, B_MIMO // 2))
    check(launches_q[0] > 0 and launches_q[1] == 0, f"mimo q256: map launches {launches_q}")
    print(f"mimo: QAM256 row, 2 x MCS 27 (2 x tbs {grant.tbs1}) B={B_MIMO}: codewords ok "
          f"{n_ok}/{2 * B_MIMO}, map launches {launches_q[0]}")
    return launches[0] + launches_q[0], 0


def phase_encode(dev) -> tuple[int, int]:
    """Phase 9.  Returns the (static, dynamic-K) launches of the loopback."""
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.modem import Mod, demod_soft
    from srsran_tpu_torch.phy.ofdm import OfdmConfig, ofdm_rx_sf
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant, pdsch_cinit, pdsch_re_indices
    from srsran_tpu_torch.phy.phch.ra import dl_tbs
    from srsran_tpu_torch.phy.phch.sch import TbCoding, dlsch_encode_np
    from srsran_tpu_torch.phy.sequence import gold_sequence
    from srsran_tpu_torch.pipeline import enb_dl_subframe_encode, ue_dl_subframe

    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    sf_idx, cfi, tbs = 2, 1, dl_tbs(26, 100)
    grant = DlGrant(prb=tuple(range(100)), mod=Mod.QAM64, tbs=tbs)
    rng = np.random.default_rng(9)
    tbs_all = rng.integers(0, 2, (B_ENCODE, tbs)).astype(np.uint8)
    tbs_dev = torch.from_numpy(tbs_all).to(dev)
    enc = enb_dl_subframe_encode(cell, sf_idx, cfi, grant)
    reset_launches()
    tx = enc(tbs_dev)
    check(read_launches() == (0, 0), "encode: the encoder launched the MAP kernel")
    check(tuple(tx.shape) == (B_ENCODE, 1, cell.sf_len) and tx.dtype == torch.complex64,
          "encode: samples shape/dtype")
    check(tx.device == dev and bool(torch.isfinite(tx.real).all() and torch.isfinite(tx.imag).all()),
          "encode: samples device/finite")
    # the coded bits behind the samples: hard decisions of the noise-free
    # subframe, descrambled, against the host encoder
    idx = pdsch_re_indices(cell, sf_idx, cfi, grant.prb)
    coding = TbCoding(tbs=tbs, g=len(idx) * grant.qm, qm=grant.qm)
    seq = gold_sequence(pdsch_cinit(grant.rnti, sf_idx, cell.id), coding.g)
    grid = ofdm_rx_sf(OfdmConfig.from_cell(cell, normalize=True), tx[:2, 0])
    sym = grid.reshape(2, -1)[:, torch.from_numpy(idx.astype(np.int64)).to(dev)]
    hard = (demod_soft(grant.mod, sym) > 0).cpu().numpy().astype(np.uint8) ^ seq
    for i in range(2):
        check(bool((hard[i] == dlsch_encode_np(tbs_all[i], coding)).all()),
              f"encode: coded bits of TB {i} differ from dlsch_encode_np")
    ms = batch_ms(lambda: enc(tbs_dev))
    print(f"encode: 100 PRB MCS 26 B={B_ENCODE}: coded bits of 2 TBs equal dlsch_encode_np "
          f"({coding.g} bits each), {ms:.3f} ms per batch, "
          f"{B_ENCODE * tbs / (ms * 1e-3) / 1e6:.1f} Mbps")
    # loopback through the UE decode
    gen = torch.Generator(device=dev).manual_seed(10)
    noise = torch.randn(tx.shape + (2,), generator=gen, device=dev)
    dec = ue_dl_subframe(cell, sf_idx, cfi, grant, 6)
    reset_launches()
    tb, ok, _snr = dec(tx + 0.09 * torch.view_as_complex(noise))
    launches = read_launches()
    check(tuple(tb.shape) == (B_ENCODE, tbs), "loopback: TB shape")
    check(bool((tb[ok] == tbs_dev[ok]).all()), "loopback: a CRC-passing TB differs from the sent one")
    n_ok = int(ok.sum())
    check(n_ok >= B_ENCODE - 2, f"loopback: only {n_ok}/{B_ENCODE} TBs come back")
    check(launches[0] > 0 and launches[1] == 0, f"loopback: map launches {launches}")
    print(f"encode: loopback through ue_dl_subframe at noise 0.09: {n_ok}/{B_ENCODE} TBs come "
          f"back, map launches {launches[0]}")
    return launches


def phase_ul(dev) -> tuple[int, int]:
    """Phase 10.  Returns the (static, dynamic-K) launches of the call."""
    fx, _cell, grant, fn, samples, tb_sent = load_ul(dev)
    reset_launches()
    tb, ok, snr_db = fn(samples)
    launches = read_launches()
    check(bool(torch.isfinite(snr_db).all()), "ul: non-finite snr_db")
    n_ok = check_decoded("ul", tb, ok, tb_sent, B // 2)
    check_stored("ul", tb, ok, snr_db, fx["ref_tb_packed"], fx["ref_crc_ok"], fx["ref_snr_db"])
    check(launches[0] > 0 and launches[1] == 0, f"ul: map launches {launches}")
    ms = batch_ms(lambda: fn(samples))
    print(f"ul: PUSCH PRB {grant.prb_start}+{grant.nof_prb} of 100, MCS 20 (tbs {grant.tbs}) "
          f"B={B}: crc_ok {n_ok}/{B}, stored subframes as the reference (crc_ok "
          f"{fx['ref_crc_ok'].tolist()}), map launches {launches[0]}, {ms:.3f} ms per batch, "
          f"{n_ok * grant.tbs / (ms * 1e-3) / 1e6:.1f} Mbps of CRC-passing TBs")
    return launches


def phase_dynamic_ul(dev) -> tuple[int, int]:
    """Phase 11.  Returns the (static, dynamic-K) launches of its paths."""
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.dft_precoding import valid_nof_prb
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant, pdsch_encode_np
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu_torch.phy.ue.ue_ul import ue_ul_encode
    from srsran_tpu_torch.pipeline_dynamic import DynamicEnbUl, DynamicUeDl

    fd = np.load(FIXTURE_UL_DYN)
    nof_prb = int(fd["nof_prb"])
    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=int(fd["cell_id"]))
    enb = DynamicEnbUl(cell, max_iterations=int(fd["max_iterations"]))
    check(enb.device == dev, "DynamicEnbUl did not take the card by default")
    reset_launches()

    def decode_and_check(tag, dec, sf_idx, grant, tb_sent, rx, soft=None, want_ok=True):
        tb_hat, ok_, soft_, n_it = dec.decode(rx, sf_idx, grant, soft)
        check(tb_hat.shape == (grant.tbs,) and tb_hat.dtype == np.uint8, f"{tag}: TB shape/dtype")
        check(soft_.device == dev and bool(torch.isfinite(soft_).all()), f"{tag}: softbuffer")
        check(ok_ == want_ok, f"{tag}: crc_ok {ok_}, expected {want_ok}")
        if want_ok:
            check(bool((tb_hat == tb_sent).all()), f"{tag}: TB differs from the sent one")
        return soft_, n_it

    # (a) a scheduler-style PUSCH grant mix
    rng = np.random.default_rng(4)
    ls = [l for l in range(1, nof_prb - 1) if valid_nof_prb(l)]
    built_at = []
    for i in range(30):
        sf_idx, mcs, l = int(rng.integers(0, 10)), int(rng.integers(0, 24)), int(rng.choice(ls))
        g = ul_grant(mcs, int(rng.integers(1, nof_prb - l)), l, 0x46)
        tb_sent = rng.integers(0, 2, g.tbs).astype(np.uint8)
        rx = awgn(rng, ue_ul_encode(cell, sf_idx, pusch=(g, tb_sent), device=dev).cpu().numpy()[None],
                  0.04)
        decode_and_check(f"ul mix {i} (sf {sf_idx}, MCS {mcs}, PRB {g.prb_start}+{l}, tbs {g.tbs})",
                         enb, sf_idx, g, tb_sent, rx)
        built_at.append(enb.total_compiles)
    print(f"dynamic ul: grant mix {len(built_at)}/{len(built_at)} TBs ok; stage keys built "
          f"{enb.stats}")
    check(enb.stats["compiles_a"] == 1 and enb.stats["compiles_b"] <= 12
          and enb.stats["compiles_c"] <= 14, "ul stage keys exceed the bucket grid")
    check(built_at[-1] - built_at[-len(built_at) // 4] <= 2,
          f"the last quarter of the ul mix still builds stages: {built_at}")

    # (b) HARQ: rv 0 alone fails at low SNR, rv 2 combines and decodes
    g0, g2 = ul_grant(19, 1, 80, 0x46), ul_grant(19, 1, 80, 0x46, rv=2)
    tb_harq = rng.integers(0, 2, g0.tbs).astype(np.uint8)
    soft, _ = decode_and_check(
        "ul HARQ rv 0", enb, 2, g0, tb_harq,
        awgn(rng, ue_ul_encode(cell, 2, pusch=(g0, tb_harq), device=dev).cpu().numpy()[None], 0.33),
        want_ok=False)
    decode_and_check("ul HARQ rv 2", enb, 3, g2, tb_harq,
                     awgn(rng, ue_ul_encode(cell, 3, pusch=(g2, tb_harq), device=dev).cpu().numpy()[None],
                          0.33), soft=soft)
    print("dynamic ul: HARQ rv 0 fails alone, rv 2 combines and decodes")

    # (c) stored grants with the reference's results
    enb_fx = DynamicEnbUl(cell, max_iterations=int(fd["max_iterations"]))
    for i in range(len(fd["mcs"])):
        g = ul_grant(int(fd["mcs"][i]), int(fd["prb_start"][i]), int(fd["prb_len"][i]),
                     int(fd["rnti"]))
        tb_hat, ok_, _, n_it = enb_fx.decode(fd["rx"][i], int(fd["sf_idx"][i]), g)
        check(ok_ == bool(fd["ref_crc_ok"][i]) and n_it == int(fd["ref_n_it"][i]),
              f"stored ul grant {i}: crc_ok {ok_}, {n_it} iterations; reference "
              f"{bool(fd['ref_crc_ok'][i])}, {int(fd['ref_n_it'][i])}")
        check(not ok_ or bool((tb_hat == np.unpackbits(fd["ref_tb_packed"][i], count=g.tbs)).all()),
              f"stored ul grant {i}: TB bits differ from the reference")
    print(f"dynamic ul: {len(fd['mcs'])} stored grants give the reference's crc_ok "
          f"{fd['ref_crc_ok'].tolist()}, iterations {fd['ref_n_it'].tolist()} and TB bits")
    launches_ul = read_launches()
    check(launches_ul[1] > 0 and launches_ul[0] == 0, f"dynamic ul: map launches {launches_ul}")

    # (d) ms per TTI of the headline grant (PRB 1..96, MCS 20)
    gh = ul_grant(20, 1, 96, 0x46)
    tb_h = rng.integers(0, 2, gh.tbs).astype(np.uint8)
    rx_h = torch.from_numpy(awgn(rng, ue_ul_encode(cell, 2, pusch=(gh, tb_h), device=dev).cpu().numpy()[None],
                                 0.09)).to(dev)
    _, n_it_h = decode_and_check("ul headline grant", enb, 2, gh, tb_h, rx_h)
    dev_ms = cuda_ms(lambda: enb.decode(rx_h, 2, gh), 10)
    host_ms = wall_ms(lambda: enb.decode(rx_h, 2, gh), 10)
    print(f"dynamic ul: MCS 20 PRB 1+96 (tbs {gh.tbs}, {n_it_h} iterations): {dev_ms:.3f} ms per "
          f"TTI by CUDA events, {host_ms:.3f} ms host wall; {enb.stats['ttis'] + enb_fx.stats['ttis']}"
          f" TTIs, dynamic-K map launches {launches_ul[1]} before the timing")

    # (e) transmit-diversity and spatial-multiplexing grants through DynamicUeDl
    cell2 = Cell(nof_prb=nof_prb, nof_ports=2, id=int(fd["cell_id"]))
    ue = DynamicUeDl(cell2, cfi=1, max_iterations=6)
    reset_launches()
    for tx_scheme, nof_layers, mcs, s0, l, sf_idx in (
            ("diversity", 1, 9, 10, 30, 1), ("diversity", 1, 24, 0, 100, 5),
            ("spatialmux", 1, 16, 50, 50, 2), ("spatialmux", 2, 20, 0, 50, 7)):
        g = DlGrant(prb=tuple(range(s0, s0 + l)), mod=dl_mcs_to_mod(mcs),
                    tbs=dl_tbs(mcs, l * nof_layers), rnti=0x46, tx_scheme=tx_scheme,
                    nof_layers=nof_layers, pmi=1)
        tb_sent = rng.integers(0, 2, g.tbs).astype(np.uint8)
        rx = awgn(rng, render_2x2(cell2, sf_idx, pdsch_encode_np(cell2, sf_idx, 1, g, tb_sent)), 0.02)
        _, n_it = decode_and_check(f"{tx_scheme} x{nof_layers} MCS {mcs}", ue, sf_idx, g, tb_sent, rx)
        print(f"dynamic: {tx_scheme} grant, {nof_layers} layer(s), MCS {mcs}, PRB {s0}+{l}, tbs "
              f"{g.tbs}: ok, {n_it} iterations")
    launches_dl = read_launches()
    check(launches_dl[1] > 0 and launches_dl[0] == 0, f"dynamic 2-port: map launches {launches_dl}")
    return 0, launches_ul[1] + launches_dl[1]


# --- the windowed engines ---------------------------------------------------------


def stored_window(kind: str):
    """The stored reference window `kind` ("ue_dl", "ue_dl_mimo", "enb_ul")
    with the port's classes: (fx, cell, subframe indices, grants, samples
    (W, nrx, sf_len) complex64 — what the int8 pairs dequantise to)."""
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant, DlGrant2
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs

    fx = np.load(TESTDATA / f"window_{kind}_20mhz.npz")
    rnti = int(fx["rnti"])
    cell = Cell(nof_prb=int(fx["nof_prb"]), nof_ports=2 if kind == "ue_dl_mimo" else 1,
                id=int(fx["cell_id"]))
    sfs, grants = [], []
    for row in fx["grant_rows"]:
        if kind == "ue_dl_mimo":
            mcs1, mcs2, s0, l, sf_idx, pmi = (int(v) for v in row[:6])
            grants.append(DlGrant2(
                prb=tuple(range(s0, s0 + l)), mod1=dl_mcs_to_mod(mcs1), tbs1=dl_tbs(mcs1, l),
                mod2=dl_mcs_to_mod(mcs2), tbs2=dl_tbs(mcs2, l), pmi=pmi % 3, rnti=rnti,
                tx_scheme="cdd" if pmi == 3 else "spatialmux"))
        else:
            mcs, s0, l, sf_idx = (int(v) for v in row[:4])
            grants.append(ul_grant(mcs, s0, l, rnti) if kind == "enb_ul" else DlGrant(
                prb=tuple(range(s0, s0 + l)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, l), rnti=rnti))
        sfs.append(sf_idx)
    ri = fx["q"].astype(np.float32) * fx["scale"][:, None, None, None]
    return fx, cell, sfs, grants, (ri[..., 0] + 1j * ri[..., 1]).astype(np.complex64)


GEN_KINDS = ("enb_dl", "ue_ul", "enb_dl_mimo")
SAMPLE_ATOL = 2e-6


def stored_gen_window(kind: str):
    """The stored reference generate window `kind` ("enb_dl", "ue_ul",
    "enb_dl_mimo") with the port's classes: (fx, cell, subframe indices,
    grants, payloads (pairs for the MIMO window), dispatch keywords)."""
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant, DlGrant2
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs

    fx = np.load(TESTDATA / f"window_gen_{kind}.npz")
    rnti = int(fx["rnti"])
    cell = Cell(nof_prb=int(fx["nof_prb"]), nof_ports=2 if kind == "enb_dl_mimo" else 1,
                id=int(fx["cell_id"]))
    sfs, grants = [], []
    for row in fx["grant_rows"].tolist():
        if kind == "enb_dl_mimo":
            mcs1, mcs2, s0, l, sf_idx, pmi = row
            grants.append(DlGrant2(
                prb=tuple(range(s0, s0 + l)), mod1=dl_mcs_to_mod(mcs1), tbs1=dl_tbs(mcs1, l),
                mod2=dl_mcs_to_mod(mcs2), tbs2=dl_tbs(mcs2, l), pmi=pmi % 3, rnti=rnti,
                tx_scheme="cdd" if pmi == 3 else "spatialmux"))
        else:
            mcs, s0, l, sf_idx = row
            grants.append(ul_grant(mcs, s0, l, rnti) if kind == "ue_ul" else DlGrant(
                prb=tuple(range(s0, s0 + l)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, l), rnti=rnti))
        sfs.append(sf_idx)
    payloads = [np.unpackbits(fx["tb_packed"][i], count=int(t)) for i, t in enumerate(fx["tbs"])]
    kw = {}
    if kind == "enb_dl_mimo":
        payloads = list(zip(payloads[0::2], payloads[1::2]))
    elif kind == "enb_dl":
        kw = dict(overlay=(fx["ov_idx"], fx["ov_vals"]))
    else:
        kw = dict(pucch=(fx["pucch_prb"], fx["pucch_grids"], fx["pucch_live"]))
    return fx, cell, sfs, grants, payloads, kw


def gen_engine(kind: str, cell, w: int, **kw):
    """The generate engine of `kind`; the stored "enb_dl" window is
    rendered with template "full"."""
    import srsran_tpu_torch.pipeline_window as pw

    if kind == "ue_ul":
        return pw.WindowedUeUl(cell, w=w, **kw)
    if kind == "enb_dl_mimo":
        return pw.WindowedEnbDlMimo(cell, cfi=1, w=w, **kw)
    return pw.WindowedEnbDl(cell, cfi=1, w=w, template="full", **kw)


def stored_gen_errors(eng, fx, sfs, grants, payloads, kw) -> tuple[int, float]:
    """The port's generate window on a stored one: (codeword bits that
    differ from the reference's, max_abs_err of the samples)."""
    stages, _pack = eng._plan(payloads, sfs, grants, **kw)
    cw = stages[0][1](None)
    out = stages[1][1](cw)
    ref_cw = np.unpackbits(fx["ref_cw_packed"], axis=-1)
    got = out.cpu().numpy()
    check(got.shape == fx["ref_samples"].shape and got.dtype == np.complex64,
          f"stored generate window: samples {got.shape} {got.dtype}")
    return (int((cw.cpu().numpy() != ref_cw).sum()),
            float(np.abs(got - fx["ref_samples"]).max()))


# dense-slot bucket N -> {per-slot K_i of a window that reached it: the tags
# of the windows that gave those K_i}: the dynamic-K kernel's launch shapes
WINDOW_SHAPES: dict = {}


def note_shape(tag: str, pack):
    """Record the launch shape stage C gave the kernel for this window: its
    bucket N and its per-slot K_i."""
    n = pack.key[1]
    tags = WINDOW_SHAPES.setdefault(n, {}).setdefault(tuple(pack.params[2 * n:3 * n].tolist()), [])
    if tag not in tags:
        tags.append(tag)


def window_engine(kind: str, cell, w: int, max_iterations: int, **kw):
    import srsran_tpu_torch.pipeline_window as pw

    if kind == "enb_ul":
        return pw.WindowedEnbUl(cell, w=w, max_iterations=max_iterations, **kw)
    cls = pw.WindowedUeDlMimo if kind == "ue_dl_mimo" else pw.WindowedUeDl
    return cls(cell, cfi=1, w=w, max_iterations=max_iterations, **kw)


def window_rows(kind: str, res):
    """The results of a window as [(tb bits, ok)] per stage C row (two rows
    per TTI for the two-codeword engine) and the iteration count per TTI."""
    if kind == "ue_dl_mimo":
        return [r for cw1, cw2, _n in res for r in (cw1, cw2)], [n for _a, _b, n in res]
    return [(tb, ok) for tb, ok, _n in res], [n for _tb, _ok, n in res]


def check_window(tag: str, kind: str, res, sent, min_ok: int) -> int:
    """Every CRC-passing TB of a window is the sent one, and at least
    `min_ok` pass.  sent: per row.  Returns the number that pass."""
    rows, _n_it = window_rows(kind, res)
    check(len(rows) == len(sent), f"{tag}: {len(rows)} rows for {len(sent)} TBs")
    n_ok = 0
    for i, ((tb, ok), tb_sent) in enumerate(zip(rows, sent)):
        check(tb.shape == tb_sent.shape and tb.dtype == np.uint8, f"{tag}: row {i} TB shape/dtype")
        if ok:
            check(bool((tb == tb_sent).all()), f"{tag}: row {i} passes CRC but is not the sent TB")
            n_ok += 1
    check(n_ok >= min_ok, f"{tag}: only {n_ok}/{len(rows)} TBs pass CRC")
    return n_ok


def dl_window_mix(cell, rng, n: int, tx_scheme: str = "port0"):
    """n one-codeword grants (MCS 0-26 x 4-100 PRB x subframes 0-9), each
    with its TB and noise-free received subframe (nrx, sf_len): port 0 over
    an ideal channel, transmit diversity behind H_2X2."""
    from srsran_tpu_torch.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu_torch.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant, pdsch_encode_np
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs

    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    mix = []
    while len(mix) < n:
        sf_idx, mcs = int(rng.integers(0, 10)), int(rng.integers(0, 27))
        l = int(rng.integers(4, 101))
        st = int(rng.integers(0, 101 - l))
        if dl_tbs(mcs, l) == 0:
            continue
        g = DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, l),
                    rnti=0x46, tx_scheme=tx_scheme)
        tb = rng.integers(0, 2, g.tbs).astype(np.uint8)
        grid = pdsch_encode_np(cell, sf_idx, 1, g, tb)
        clean = (render_2x2(cell, sf_idx, grid) if cell.nof_ports == 2 else
                 ofdm_tx_sf(ofdm, torch.from_numpy(put_crs_np(grid, cell, sf_idx))).numpy())
        mix.append((clean, sf_idx, g, tb))
    return mix


def mimo_window_mix(cell, rng, n: int):
    """n two-codeword grants (2 x MCS 4-24 on 20-100 PRB, PMI 0-2, the last
    one large-delay CDD) behind H_2X2; the TB of a grant is the pair."""
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant2, pdsch_encode2_np
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs

    mix = []
    while len(mix) < n:
        sf_idx = int(rng.integers(0, 10))
        mcs1, mcs2 = int(rng.integers(4, 25)), int(rng.integers(4, 25))
        l = int(rng.integers(20, 101))
        st = int(rng.integers(0, 101 - l))
        g = DlGrant2(prb=tuple(range(st, st + l)), mod1=dl_mcs_to_mod(mcs1), tbs1=dl_tbs(mcs1, l),
                     mod2=dl_mcs_to_mod(mcs2), tbs2=dl_tbs(mcs2, l), pmi=int(rng.integers(0, 3)),
                     rnti=0x46, tx_scheme="cdd" if len(mix) == n - 1 else "spatialmux")
        tbs = tuple(rng.integers(0, 2, t).astype(np.uint8) for t in (g.tbs1, g.tbs2))
        grid = np.zeros((2, cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
        grid += pdsch_encode2_np(cell, sf_idx, 1, g, *tbs)
        mix.append((render_2x2(cell, sf_idx, grid), sf_idx, g, tbs))
    return mix


def ul_window_mix(cell, rng, n: int):
    """n PUSCH grants (widths 9/25/50/96 PRB x MCS 0-23 x subframes 0-9)."""
    from srsran_tpu_torch.phy.ue.ue_ul import ue_ul_encode

    mix = []
    while len(mix) < n:
        sf_idx, mcs = int(rng.integers(0, 10)), int(rng.integers(0, 24))
        nprb = int((9, 25, 50, 96)[rng.integers(0, 4)])
        g = ul_grant(mcs, int(rng.integers(0, 101 - nprb)), nprb, 0x46)
        if g.tbs == 0:
            continue
        tb = rng.integers(0, 2, g.tbs).astype(np.uint8)
        mix.append((ue_ul_encode(cell, sf_idx, pusch=(g, tb)).cpu().numpy()[None, :], sf_idx, g, tb))
    return mix


def window_of(mix, w: int, rng, amp: float):
    """The mix repeated to W TTIs, each TTI with noise of its own: (samples
    (W, nrx, sf_len), subframe indices, grants, sent TBs per TTI)."""
    mm = (mix * (-(-w // len(mix))))[:w]
    samples = awgn(rng, np.stack([m[0] for m in mm]), amp)
    return samples, [m[1] for m in mm], [m[2] for m in mm], [m[3] for m in mm]


def time_window(tag: str, one, w: int) -> dict:
    """Times and counts of one warm window, `one()` ending in a host read or
    leaving its work queued: two warm calls, then medians of 5 runs of 2
    windows by CUDA events and on the host clock (synchronised), the
    dynamic-K MAP launches per window, and one profiled pair of windows
    (kernels per window, device busy time, the kernels that take most)."""
    from srsran_tpu_torch.phy.fec import turbo_cuda

    for _ in range(2):
        one()
    before = turbo_cuda.LAUNCHES_DYN
    dev, host = [], []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        one()
        one()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3 / 2)
        dev.append(start.elapsed_time(end) / 2)
    map_per_window = (turbo_cuda.LAUNCHES_DYN - before) / 10
    dev_ms, host_ms = sorted(dev)[2], sorted(host)[2]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_ms = wall_ms(one, 2)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    n_kernels = sum(e.count for e in kernels) / 2
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / 2
    check(n_kernels > 0 and busy_ms > 0, f"{tag}: the profiler saw no kernel on the card")
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:5]
    return {"w": w, "ms_per_window_cuda_events": dev_ms, "ms_per_window_host_wall": host_ms,
            "ms_per_tti": host_ms / w, "real_time_factor": w / host_ms,
            "kernels_per_window": n_kernels, "device_busy_ms_per_window": busy_ms,
            "device_busy_share_of_host_wall": busy_ms / host_ms, "ms_per_window_under_profiler": prof_ms,
            "map_launches_per_window": map_per_window,
            "top_kernels": [{"name": e.key[:60], "count_per_window": e.count / 2,
                             "device_ms_per_window": e.device_time_total / 1e3 / 2,
                             "share_of_device_time": e.device_time_total / 1e3 / 2 / busy_ms}
                            for e in top]}


def print_times(tag: str, t: dict):
    w = t["w"]
    print(f"{tag}: W={w}: {t['ms_per_window_cuda_events']:.3f} ms per window by CUDA events, "
          f"{t['ms_per_window_host_wall']:.3f} ms host wall ({t['ms_per_window_cuda_events'] / w:.4f} / "
          f"{t['ms_per_tti']:.4f} ms per TTI), real-time factor {t['real_time_factor']:.2f}x; "
          f"{t['kernels_per_window']:.0f} kernels per window, device busy "
          f"{t['device_busy_ms_per_window']:.3f} ms ({100 * t['device_busy_share_of_host_wall']:.1f}% "
          f"of the host wall; {t['ms_per_window_under_profiler']:.3f} ms per window under the "
          f"profiler); {t['map_launches_per_window']:g} dynamic-K map launches per window")


def window_times(tag: str, kind: str, eng, samples, sfs, grants) -> dict:
    """`time_window` of one decode window through `eng`, with the CRC-passing
    Mbps, the host's ingest quantisation alone, the stages' times and the
    window's dense slots, printed and returned."""
    import srsran_tpu_torch.pipeline_window as pw

    def one():
        return eng.results(eng.dispatch_window(samples, sfs, grants))

    rows, _n_it = window_rows(kind, one())
    ok_bits = sum(tb.size for tb, ok in rows if ok)
    out = time_window(tag, one, eng.w)
    quant = []
    for _ in range(5):
        t0 = time.perf_counter()
        pw._quantize_ingest(samples, eng.ingest)
        quant.append((time.perf_counter() - t0) * 1e3)
    quant_ms = sorted(quant)[2]
    stages = {k: v * 1e3 for k, v in eng.stage_times(samples, sfs, grants, n=3).items()}
    pack = eng.dispatch_window(samples, sfs, grants).pack
    note_shape(f"{tag}, timed", pack)
    host_ms = out["ms_per_window_host_wall"]
    out.update(crc_ok_mbps=ok_bits / host_ms / 1e3, quantize_ingest_ms=quant_ms, stage_ms=stages,
               real_time_factor_of_stage_times=eng.w / sum(stages.values()),
               slots_real=sum(pack.row_ncb), slots_bucketed=pack.key[1], stage_c_key=list(pack.key))
    print_times(tag, out)
    print(f"{tag}: {ok_bits / host_ms / 1e3:.1f} Mbps of CRC-passing TBs; of the host wall "
          f"{quant_ms:.3f} ms is the {eng.ingest} ingest quantisation on the host; stage_times A "
          f"{stages['A']:.3f} B {stages['B']:.3f} C {stages['C']:.3f} ms "
          f"({eng.w / sum(stages.values()):.1f}x real time without the host's plan); slots "
          f"{out['slots_real']} real / {out['slots_bucketed']} bucketed, stage C key {pack.key}")
    return out


def phase_window_kernel(dev):
    """Phase 12, after the windows.  Returns (max_abs_err, [dict per shape])."""
    from srsran_tpu_torch.phy.fec import turbo_cuda
    from srsran_tpu_torch.phy.fec.cbsegm import CB_SIZES
    from srsran_tpu_torch.phy.fec.turbo import map_pass_plain, pass_layout

    nw, lw, T = layout = pass_layout(6144)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    check(len(WINDOW_SHAPES) > 0, "no window recorded a launch shape")
    # every bucket N with every set of K_i a window gave it; then N = 384 and
    # 768 with K_i drawn over the 188 sizes
    cases = [(n, list(k_sets.items())) for n, k_sets in sorted(WINDOW_SHAPES.items())]
    for n in (384, 768):
        ks = np.random.default_rng(n).choice(CB_SIZES, n).tolist()
        check(len(set(ks)) > 100, "the windowed kernel check draws too few sizes")
        cases.append((n, [(tuple(ks), [])]))
    max_err, shapes = 0.0, []
    for n, k_sets in cases:
        errs = []
        for ks, tags in k_sets:
            lx, lz, beta_k, k_vec, below_k = dyn_map_inputs(6144, ks, seed=n, device=dev)
            got = turbo_cuda.map_pass(lx, lz, beta_k, *layout, k_vec=k_vec)
            ref = map_pass_plain(lx, lz, beta_k, 6144, k_vec)
            torch.cuda.synchronize()
            err = float((got - ref)[below_k].abs().max())
            same_bits = bool(torch.equal((got > 0)[below_k], (ref > 0)[below_k]))
            check(bool(torch.isfinite(got[below_k]).all()), f"non-finite posteriors at N={n}")
            check(err <= MAP_ATOL and same_bits, f"dyn kernel disagrees with plain at N={n}, K_i of {tags}")
            errs.append(err)
            k_of = (f"K_i of the windows {tags}" if tags else
                    "K_i drawn over the sizes" + ("" if n in WINDOW_SHAPES else "; no window of this run"))
            print(f"map dyn N={n} x K_max 6144, {len(set(ks))} sizes of K ({k_of}): max_abs_err below "
                  f"K {err:.3g}, hard bits identical {same_bits}")
        # timed on the first set of K_i
        lx, lz, beta_k, k_vec, _ = dyn_map_inputs(6144, k_sets[0][0], seed=n, device=dev)
        cpb, smem = turbo_cuda.launch_plan(n, nw, lw, n_sm)
        ms = queued_ms(lambda: turbo_cuda.map_pass(lx, lz, beta_k, *layout, k_vec=k_vec), 50)
        plain_ms = cuda_ms(lambda: map_pass_plain(lx, lz, beta_k, 6144, k_vec), 2)
        bound_ms, bound_by = map_bound(lx, lz, beta_k, layout, k_vec)
        print(f"map dyn N={n} x K_max 6144 ({cpb} codeblock and {smem} B of shared memory a block, "
              f"{n / (3 * n_sm):.2f} waves of {3 * n_sm}): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / ms:.1f}% of it)")
        max_err = max([max_err] + errs)
        shapes.append(dict(shape=[n, 6144], windows=sorted({t for _ks, tags in k_sets for t in tags}),
                           k_sets_checked=len(k_sets), max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by))
    return max_err, shapes


def phase_window_dl(dev):
    """Phase 13.  Returns ((static, dynamic-K) launches, times dict)."""
    import srsran_tpu_torch.pipeline_window as pw
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.ofdm import OfdmConfig
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs

    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    rng = np.random.default_rng(13)
    ue = window_engine("ue_dl", cell, W_DL, 6)
    check(ue.device == dev, "WindowedUeDl did not take the card by default")
    samples, sfs, grants, sent = window_of(dl_window_mix(cell, rng, 16), W_DL, rng, 0.09)
    reset_launches()
    p = ue.dispatch_window(samples, sfs, grants)
    res = ue.results(p)
    launches_first = read_launches()
    note_shape("window dl", p.pack)
    check(p.packed.device == dev and p.softbuffer.device == dev, "window results are not on the card")
    check(bool(torch.isfinite(p.softbuffer).all()), "window softbuffer is not finite")
    n_ok = check_window("window dl", "ue_dl", res, sent, 124)
    check(launches_first[1] > 0 and launches_first[0] == 0, f"window dl: map launches {launches_first}")
    print(f"window dl: 100 PRB W={W_DL}, 16-grant mix at noise 0.09: crc_ok {n_ok}/{W_DL}, "
          f"{sum(p.pack.row_ncb)} codeblocks in {p.pack.key[1]} slots, {launches_first[1]} dynamic-K "
          f"map launches, iterations up to {max(r[2] for r in res)}")

    # a second window, a fresh mix: the same stage A and B functions
    a_fn, b_fns = ue._a, dict(ue._b_cache)
    c_before = pw._build_win_c.cache_info().currsize
    samples2, sfs2, grants2, sent2 = window_of(dl_window_mix(cell, rng, 16), W_DL, rng, 0.09)
    p2 = ue.dispatch_window(samples2, sfs2, grants2)
    n_ok2 = check_window("window dl, second mix", "ue_dl", ue.results(p2), sent2, 124)
    note_shape("window dl, second mix", p2.pack)
    check(ue._a is a_fn and all(ue._b_cache[k] is v for k, v in b_fns.items())
          and len(ue._b_cache) <= len(b_fns) + 1, "the second window rebuilt stage A or B")
    c_grown = pw._build_win_c.cache_info().currsize - c_before
    check(c_grown <= 1, f"the second window built {c_grown} stage C functions")
    print(f"window dl: second mix crc_ok {n_ok2}/{W_DL} through the same stage A and B functions, "
          f"{c_grown} new stage C key ({p2.pack.key})")

    # HARQ across windows: rv 0 fails at row 5 of one window; its softbuffer
    # block goes to row 77 of the next, where rv 2 combines and passes
    tbs_h = dl_tbs(16, 15)
    tb_h = rng.integers(0, 2, tbs_h).astype(np.uint8)
    g0, g2 = (DlGrant(prb=tuple(range(15)), mod=dl_mcs_to_mod(16), tbs=tbs_h, rnti=0x46, rv=rv)
              for rv in (0, 2))
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    samples[5], sfs[5], grants[5], sent[5] = render(cell, ofdm, 2, g0, tb_h, rng, 0.42), 2, g0, tb_h
    p_a = ue.dispatch_window(samples, sfs, grants)
    res_a = ue.results(p_a)
    note_shape("window dl, HARQ rv 0", p_a.pack)
    check(not res_a[5][1], "window HARQ: rv 0 decoded alone")
    carry = pw.extract_softbuffer(p_a, 5)
    check(carry.device == dev, "window HARQ: the carry left the card")
    check(res_a[5][2] == 6, f"window HARQ: the failing TB stopped after {res_a[5][2]} iterations")
    before = read_launches()[1]
    ms_failing = wall_ms(lambda: ue.results(ue.dispatch_window(samples, sfs, grants)), 3)
    launches_failing = (read_launches()[1] - before) / 3
    samples2[77], sfs2[77], grants2[77], sent2[77] = (
        render(cell, ofdm, 5, g2, tb_h, rng, 0.42), 5, g2, tb_h)
    soft = pw.make_softbuffer([carry if i == 77 else None for i in range(W_DL)])
    p_b = ue.dispatch_window(samples2, sfs2, grants2, softbuffer=soft)
    res_b = ue.results(p_b)
    note_shape("window dl, HARQ rv 2", p_b.pack)
    check(res_b[77][1] and bool((res_b[77][0] == tb_h).all()), "window HARQ: rv 0 + rv 2 did not decode")
    check_window("window dl, HARQ window", "ue_dl", res_b, sent2, 124)
    print("window dl: HARQ rv 0 fails at row 5, its block moves to row 77 of the next window, "
          f"rv 2 combines and decodes; the window with the failing TB runs all 6 iterations: "
          f"{ms_failing:.3f} ms per window on the host clock, {launches_failing:g} dynamic-K map launches")
    launches = read_launches()
    check(launches[0] == 0, f"window dl: static map launches {launches[0]}")

    samples, sfs, grants, sent = window_of(dl_window_mix(cell, rng, 16), W_DL, rng, 0.09)
    times = window_times("window dl", "ue_dl", ue, samples, sfs, grants)
    times.update(crc_ok=n_ok, ms_per_window_with_a_failing_tb=ms_failing,
                 map_launches_per_window_with_a_failing_tb=launches_failing)
    del ue

    # transmit diversity at 2 ports
    cell2 = Cell(nof_prb=100, nof_ports=2, id=301)
    ue2 = window_engine("ue_dl", cell2, W_DIV, 6, scheme="diversity")
    samples, sfs, grants, sent = window_of(dl_window_mix(cell2, rng, 16, "diversity"), W_DIV, rng, 0.045)
    reset_launches()
    p_div = ue2.dispatch_window(samples, sfs, grants)
    res = ue2.results(p_div)
    launches_div = read_launches()
    note_shape("window diversity", p_div.pack)
    n_ok_div = check_window("window diversity", "ue_dl", res, sent, W_DIV - 2)
    check(launches_div[1] > 0 and launches_div[0] == 0, f"window diversity: map launches {launches_div}")
    print(f"window dl: transmit diversity, 2 ports, W={W_DIV} behind the 2x2 channel at noise 0.045: "
          f"crc_ok {n_ok_div}/{W_DIV}, {launches_div[1]} dynamic-K map launches")
    return (0, launches[1] + launches_div[1]), times


def phase_window_other(dev, kind: str):
    """Phases 14 (`kind` "ue_dl_mimo") and 15 ("enb_ul").  Returns ((static,
    dynamic-K) launches, times dict)."""
    from srsran_tpu_torch.phy.common import Cell

    mimo = kind == "ue_dl_mimo"
    cell = Cell(nof_prb=100, nof_ports=2 if mimo else 1, id=301)
    w, amp = (W_MIMO, 0.045) if mimo else (W_UL, 0.05)
    tag = "window mimo" if mimo else "window ul"
    rng = np.random.default_rng(14 + (not mimo))
    eng = window_engine(kind, cell, w, 6)
    check(eng.device == dev, f"{tag}: the engine did not take the card by default")
    mix = mimo_window_mix(cell, rng, 16) if mimo else ul_window_mix(cell, rng, 16)
    samples, sfs, grants, sent = window_of(mix, w, rng, amp)
    if mimo:
        sent = [tb for pair in sent for tb in pair]
    reset_launches()
    p = eng.dispatch_window(samples, sfs, grants)
    res = eng.results(p)
    launches = read_launches()
    note_shape(tag, p.pack)
    n_ok = check_window(tag, kind, res, sent, len(sent) - len(sent) // 16)
    check(launches[1] > 0 and launches[0] == 0, f"{tag}: map launches {launches}")
    what = ("2 ports behind the 2x2 channel, 2 x MCS 4-24 on 20-100 PRB, PMI 0-2 and one CDD grant"
            if mimo else "PUSCH widths 9/25/50/96 PRB, MCS 0-23")
    print(f"{tag}: 100 PRB W={w}, {what}, noise {amp}: crc_ok {n_ok}/{len(sent)}, "
          f"{sum(p.pack.row_ncb)} codeblocks in {p.pack.key[1]} slots, {launches[1]} dynamic-K map "
          f"launches, iterations up to {max(r[2] for r in res)}")
    times = window_times(tag, kind, eng, samples, sfs, grants)
    times["crc_ok"] = n_ok
    return launches, times


def phase_stored_windows(dev) -> tuple[int, int]:
    """Phase 16.  Returns the (static, dynamic-K) launches."""
    reset_launches()
    for kind in ("ue_dl", "ue_dl_mimo", "enb_ul"):
        fx, cell, sfs, grants, samples = stored_window(kind)
        eng = window_engine(kind, cell, int(fx["w"]), int(fx["max_iterations"]))
        p = eng.dispatch_window(samples, sfs, grants)
        rows, n_it = window_rows(kind, eng.results(p))
        note_shape(f"stored window {kind}", p.pack)
        ok = [r[1] for r in rows]
        check(list(p.pack.key) == fx["ref_key"].tolist(),
              f"stored window {kind}: stage C key {p.pack.key}, reference {fx['ref_key'].tolist()}")
        check(ok == fx["ref_crc_ok"].tolist() and n_it == fx["ref_n_it"].tolist(),
              f"stored window {kind}: crc_ok {ok}, iterations {n_it}; reference "
              f"{fx['ref_crc_ok'].tolist()}, {fx['ref_n_it'].tolist()}")
        for i, ((tb, ok_i), tbs) in enumerate(zip(rows, fx["tbs"])):
            check(not ok_i or bool((tb == np.unpackbits(fx["ref_tb_packed"][i], count=int(tbs))).all()),
                  f"stored window {kind}: TB bits of row {i} differ from the reference")
        print(f"stored window {kind}: W={int(fx['w'])}, stage C key, crc_ok {ok}, iterations {n_it} "
              f"and, where the CRC passes, TB bits as the reference")
    launches = read_launches()
    check(launches[1] > 0 and launches[0] == 0, f"stored windows: map launches {launches}")
    return launches


# --- the generate windows and the loopbacks ----------------------------------------


W_GEN, W_LOOP, W_LOOP_MIMO = 64, 128, 64
# (channel, noise amplitude) of the loopbacks: `bench.py` `bench_window_loopback_rtf`
# and `bench_window_ul_loopback_rtf`; the 2x2 one behind the bench's MIMO channel
LOOP_CHANNELS = {"enb_dl": (np.array([[0.95 - 0.2j]], np.complex64), 0.02),
                 "ue_ul": (np.array([[0.9 + 0.25j]], np.complex64), 0.02),
                 "enb_dl_mimo": (H_2X2, 0.02)}
LOOP_DECODERS = {"enb_dl": "ue_dl", "ue_ul": "enb_ul", "enb_dl_mimo": "ue_dl_mimo"}
GEN_NAMES = {"enb_dl": "WindowedEnbDl", "ue_ul": "WindowedUeUl", "enb_dl_mimo": "WindowedEnbDlMimo"}


def grant_mix(kind: str, rng, n: int):
    """n TTIs of the bench's generate mixes on the 100 PRB cell, payloads
    drawn from `rng`: (subframe indices, grants, payloads; a MIMO payload is
    the pair of its codewords' bits).  "enb_dl": MCS 0-26 on 4-100 PRB;
    "ue_ul": widths 9/25/50/96 PRB, MCS 0-23; "enb_dl_mimo": 2 x MCS 4-24 on
    20-100 PRB, PMI 0-2 and, last, one large-delay CDD grant."""
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant, DlGrant2
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs

    sfs, grants, payloads = [], [], []
    while len(grants) < n:
        sf_idx = int(rng.integers(0, 10))
        if kind == "ue_ul":
            mcs, nprb = int(rng.integers(0, 24)), int((9, 25, 50, 96)[rng.integers(0, 4)])
            g = ul_grant(mcs, int(rng.integers(0, 101 - nprb)), nprb, 0x46)
            tbs = (g.tbs,)
        elif kind == "enb_dl":
            mcs, l = int(rng.integers(0, 27)), int(rng.integers(4, 101))
            st = int(rng.integers(0, 101 - l))
            g = DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, l),
                        rnti=0x46)
            tbs = (g.tbs,)
        else:
            mcs1, mcs2 = int(rng.integers(4, 25)), int(rng.integers(4, 25))
            l = int(rng.integers(20, 101))
            st = int(rng.integers(0, 101 - l))
            g = DlGrant2(prb=tuple(range(st, st + l)), mod1=dl_mcs_to_mod(mcs1), tbs1=dl_tbs(mcs1, l),
                         mod2=dl_mcs_to_mod(mcs2), tbs2=dl_tbs(mcs2, l), pmi=int(rng.integers(0, 3)),
                         rnti=0x46, tx_scheme="cdd" if len(grants) == n - 1 else "spatialmux")
            tbs = (g.tbs1, g.tbs2)
        if min(tbs) == 0:
            continue
        bits = tuple(rng.integers(0, 2, t).astype(np.uint8) for t in tbs)
        sfs.append(sf_idx)
        grants.append(g)
        payloads.append(bits if kind == "enb_dl_mimo" else bits[0])
    return sfs, grants, payloads


def phase_generate(dev, kind: str) -> dict:
    """Phase 17: one generate engine at full width, W = 64 TTIs of the
    bench's 16-grant mix repeated.  Returns the times dict."""
    import srsran_tpu_torch.pipeline_window as pw
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.phch.sch import TbCoding, dlsch_encode_np

    tag = f"generate {kind}"
    cell = Cell(nof_prb=100, nof_ports=2 if kind == "enb_dl_mimo" else 1, id=301)
    rng = np.random.default_rng(17 + GEN_KINDS.index(kind))
    eng = (pw.WindowedUeUl(cell, w=W_GEN) if kind == "ue_ul" else
           pw.WindowedEnbDlMimo(cell, cfi=1, w=W_GEN) if kind == "enb_dl_mimo" else
           pw.WindowedEnbDl(cell, cfi=1, w=W_GEN))
    check(eng.device == dev, f"{tag}: the engine did not take the card by default")
    sfs, grants, payloads = (list(v * (W_GEN // 16)) for v in grant_mix(kind, rng, 16))
    reset_launches()
    stages, pack = eng._plan(payloads, sfs, grants)
    cw = stages[0][1](None)
    out = stages[1][1](cw)
    check(read_launches() == (0, 0), f"{tag}: the generator launched the MAP kernel")
    shape = (W_GEN, 2, cell.sf_len) if kind == "enb_dl_mimo" else (W_GEN, cell.sf_len)
    check(tuple(out.shape) == shape and out.dtype == torch.complex64 and out.device == dev,
          f"{tag}: samples {tuple(out.shape)} {out.dtype} on {out.device}")
    check(bool(torch.isfinite(torch.view_as_real(out)).all()), f"{tag}: non-finite samples")
    check(torch.equal(out, eng.dispatch_window(payloads, sfs, grants)),
          f"{tag}: two dispatches of one window differ")
    # the codewords of four rows against the host DL-SCH encoder
    e = pack.params[pack.key[1]:2 * pack.key[1]]
    qms = [q for g in grants for q in (g.qm1, g.qm2)] if kind == "enb_dl_mimo" else [g.qm for g in grants]
    flat = [p for pair in payloads for p in pair] if kind == "enb_dl_mimo" else payloads
    cw_h = cw.cpu().numpy()
    for r in range(4):
        g = int(e[pack.row_start[r]:pack.row_start[r] + pack.row_ncb[r]].sum())
        want = dlsch_encode_np(flat[r], TbCoding(tbs=pack.tbs[r], g=g, qm=qms[r]))
        check(bool((cw_h[r, :g] == want).all()) and not cw_h[r, g:].any(),
              f"{tag}: codeword of row {r} differs from dlsch_encode_np")
    # the stored reference window of this generator
    fx, cell4, sfs4, grants4, payloads4, kw4 = stored_gen_window(kind)
    n_diff, err = stored_gen_errors(gen_engine(kind, cell4, int(fx["w"])), fx, sfs4, grants4,
                                    payloads4, kw4)
    check(n_diff == 0 and err <= SAMPLE_ATOL,
          f"{tag}: stored window: {n_diff} codeword bits differ, samples max_abs_err {err}")
    times = time_window(tag, lambda: eng.dispatch_window(payloads, sfs, grants), W_GEN)
    stage_ms = {k: v * 1e3 for k, v in eng.stage_times(payloads, sfs, grants, n=3).items()}
    bits = sum(pack.tbs)
    times.update(stage_ms=stage_ms, stored_window_max_abs_err=err, codeword_rows=len(pack.tbs),
                 slots_real=sum(pack.row_ncb), slots_bucketed=pack.key[1],
                 generated_mbps=bits / times["ms_per_window_host_wall"] / 1e3)
    print(f"{tag}: 100 PRB W={W_GEN}, {len(pack.tbs)} codeword rows, {sum(pack.row_ncb)} "
          f"codeblocks in {pack.key[1]} slots; codewords of rows 0-3 "
          f"equal dlsch_encode_np; the stored W={int(fx['w'])} window: codewords identical, samples "
          f"max_abs_err {err:.3g}; stage_times codewords {stage_ms['codewords']:.3f} samples "
          f"{stage_ms['samples']:.3f} ms; {times['generated_mbps']:.1f} Mbps generated")
    print_times(tag, times)
    return times


def loopback_engines(kind: str):
    """(generator, decode engine) of the loopback `kind` on the 100 PRB cell:
    W = 128 (64 for the 2x2 one), 6 iterations."""
    import srsran_tpu_torch.pipeline_window as pw
    from srsran_tpu_torch.phy.common import Cell

    mimo = kind == "enb_dl_mimo"
    w = W_LOOP_MIMO if mimo else W_LOOP
    cell = Cell(nof_prb=100, nof_ports=2 if mimo else 1, id=301)
    gen = (pw.WindowedUeUl(cell, w=w) if kind == "ue_ul" else
           pw.WindowedEnbDlMimo(cell, cfi=1, w=w) if mimo else pw.WindowedEnbDl(cell, cfi=1, w=w))
    return gen, window_engine(LOOP_DECODERS[kind], cell, w, 6)


def phase_loopback(dev, kind: str) -> tuple[tuple[int, int], dict]:
    """Phase 18: generator → `window_channel` → decode engine at full width,
    the baseband never leaving the card: W fresh grants of the bench's mix,
    6 iterations.  Returns ((static, dynamic-K) launches, times dict)."""
    import srsran_tpu_torch.pipeline_window as pw

    tag = f"loopback {kind}"
    gen, dec = loopback_engines(kind)
    check(gen.device == dev and dec.device == dev, f"{tag}: the engines did not take the card by default")
    rng = np.random.default_rng(41 + GEN_KINDS.index(kind))
    w, mimo = gen.w, kind == "enb_dl_mimo"
    h, amp = LOOP_CHANNELS[kind]
    sfs, grants, payloads = grant_mix(kind, rng, w)
    sent = [p for pair in payloads for p in pair] if mimo else payloads

    def one(seed: int = 0):
        rx = pw.window_channel(gen.dispatch_window(payloads, sfs, grants), h, amp, seed=seed)
        return dec.dispatch_window(rx, sfs, grants)

    reset_launches()
    p = one()
    res = dec.results(p)
    launches = read_launches()
    note_shape(tag, p.pack)
    kind_dec = LOOP_DECODERS[kind]
    n_ok = check_window(tag, kind_dec, res, sent, len(sent))
    check(launches[1] > 0 and launches[0] == 0, f"{tag}: map launches {launches}")
    _rows, n_it = window_rows(kind_dec, res)
    times = time_window(tag, lambda: dec.results(one()), w)
    bits = sum(t.size for t in sent)
    times.update(crc_ok=n_ok, crc_ok_mbps=bits / times["ms_per_window_host_wall"] / 1e3,
                 slots_real=sum(p.pack.row_ncb), slots_bucketed=p.pack.key[1],
                 stage_c_key=list(p.pack.key), iterations_max=max(n_it))
    print(f"{tag}: 100 PRB W={w} through {type(gen).__name__} -> window_channel (noise {amp}) -> "
          f"{type(dec).__name__}: every TB ({n_ok}/{len(sent)}) decodes and equals the sent one, "
          f"{sum(p.pack.row_ncb)} codeblocks in {p.pack.key[1]} slots, iterations up to {max(n_it)}, "
          f"{launches[1]} dynamic-K map launches; {times['crc_ok_mbps']:.1f} Mbps of CRC-passing TBs")
    print_times(tag, times)
    return launches, times


# --- the control plane: DL and UL control loopbacks, the stored control windows -----

# four C-RNTIs; CFI 2 and W = 64 (`bench.py` `bench_stack_window_rtf`'s window)
CTRL_RNTIS = (0x46, 0x47, 0x1234, 0x4601)
CTRL_CFI, W_CTRL, CTRL_EDGE_PRBS = 2, 64, 4
# PUCCH format-1 resources of the UL loopback: (n_pucch, ACK bits carried)
CTRL_PUCCH = ((2, 1), (40, 2))
CTRL_KINDS = ("ue_dl", "enb_ul")
FIXTURE_CTRL = {kind: TESTDATA / f"window_ctrl_{kind}.npz" for kind in CTRL_KINDS}
PUCCH_METRIC_ATOL = 1e-3
CTRL_RTOL = 2e-5


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(steps, device, state=None, fence: bool = True):
    """Run ordered (span, fn(state)) steps over one state dict.  With `fence`
    each step is fenced by a synchronize before and after and timed on the
    host clock.  Returns (state, {span: ms})."""
    state = {} if state is None else state
    spans = {}
    for name, fn in steps:
        if fence:
            sync(device)
        t0 = time.perf_counter()
        fn(state)
        if fence:
            sync(device)
        spans[name] = (time.perf_counter() - t0) * 1e3
    return state, spans


def median_spans(steps, device, state, n: int = 3) -> dict:
    """Median ms of each span over n fenced runs of the steps."""
    runs = [run_steps(steps, device, dict(state))[1] for _ in range(n)]
    return {k: sorted(r[k] for r in runs)[n // 2] for k in runs[0]}


def ctrl_dl_window(cell, cfi: int, w: int, rng) -> dict:
    """The DL control window on `cell`: TTI t in subframe t mod 10 carries a
    `Dci1A` DL grant for CTRL_RNTIS[t mod 4] at aggregation 4 with its PDSCH
    TB (MCS 0-26 on 4..nof_prb PRB), a `Dci0` for the next RNTI at
    aggregation 2 (each at a start of its RNTI's UE-specific search space,
    the two apart), one PHICH (group 0, n_seq 1, ACK t & 1) and, on
    subframe 0, the MIB of frame t // 10, all rendered by `enb_ctrl_overlay`
    into (idx (W, n_ov), vals (W, n_ov))."""
    from srsran_tpu_torch.phy.enb.enb_dl import DlSched
    from srsran_tpu_torch.phy.phch.dci import Dci0, Dci1A
    from srsran_tpu_torch.phy.phch.pbch import Mib
    from srsran_tpu_torch.phy.phch.pdcch import nof_cce, search_space_candidates
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs, riv_encode
    from srsran_tpu_torch.pipeline_ctrl import enb_ctrl_overlay

    n_prb = cell.nof_prb
    n_cce = nof_cce(cell, 0, cfi)
    mib = Mib(nof_prb=n_prb, phich_length=cell.phich_length, phich_resources=cell.phich_resources)
    win = dict(cfi=cfi, mib=mib, dci_len=Dci1A.nof_bits(n_prb), sfs=[], grants=[], payloads=[],
               sent=[], acks=[], idx=[], vals=[])
    for t in range(w):
        sf = t % 10
        r_dl, r_ul = CTRL_RNTIS[t % 4], CTRL_RNTIS[(t + 1) % 4]
        while True:
            mcs, l = int(rng.integers(0, 27)), int(rng.integers(4, n_prb + 1))
            if dl_tbs(mcs, l):
                break
        st = int(rng.integers(0, n_prb - l + 1))
        g = DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, l), rnti=r_dl)
        l0 = int(rng.integers(1, n_prb + 1))
        d1a = Dci1A(riv=riv_encode(n_prb, st, l), mcs=mcs, harq_pid=t % 8, ndi=(t // 8) & 1, tpc=1)
        d0 = Dci0(riv=riv_encode(n_prb, int(rng.integers(0, n_prb - l0 + 1)), l0),
                  mcs=int(rng.integers(0, 29)), ndi=t & 1, tpc=2)
        c4 = search_space_candidates(r_dl, sf, n_cce)[4][0]
        c2 = next(c for c in search_space_candidates(r_ul, sf, n_cce)[2] if c + 2 <= c4 or c >= c4 + 4)
        sent = [(r_dl, d1a.pack(n_prb)), (r_ul, d0.pack(n_prb))]
        sched = DlSched(cfi=cfi, dcis=[(sent[0][1], r_dl, 4, c4), (sent[1][1], r_ul, 2, c2)],
                        phich=[(0, 1, t & 1)])
        idx, vals = enb_ctrl_overlay(cell, cfi, sf, sched, mib=mib, sfn=t // 10)
        for key, v in (("sfs", sf), ("grants", g), ("payloads", rng.integers(0, 2, g.tbs).astype(np.uint8)),
                       ("sent", sent), ("acks", t & 1), ("idx", idx), ("vals", vals)):
            win[key].append(v)
    win["overlay"] = (np.stack(win.pop("idx")), np.stack(win.pop("vals")))
    win["searches"] = [[(r, "1A", win["dci_len"], True) for r in CTRL_RNTIS]] * w
    return win


def dl_grants_of(found, cell, sent):
    """The UE's view of its grants: per TTI the `DlGrant` unpacked from the
    found `Dci1A` that carries the sent DL assignment (its RNTI and bits);
    None where it was not found."""
    from srsran_tpu_torch.phy.phch.dci import Dci1A
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs, riv_decode

    grants = []
    for hits, (r_dl, bits_dl) in zip(found, (s[0] for s in sent)):
        hit = next((b for r, _f, b, _l, _c in hits if r == r_dl and np.array_equal(b, bits_dl)), None)
        if hit is None:
            grants.append(None)
            continue
        d = Dci1A.unpack(hit, cell.nof_prb)
        st, l = riv_decode(cell.nof_prb, d.riv)
        grants.append(DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(d.mcs),
                              tbs=dl_tbs(d.mcs, l), rv=d.rv, rnti=r_dl))
    return grants


def ctrl_dl_steps(cell, win, gen, fe, h, amp, seed: int = 0):
    """One DL control loopback window as ordered (span, fn(state)) steps:
    the generator with the control overlay and `window_channel`; the UE
    front end (stage A and the control equalize, one read); the blind
    search's host part; its Viterbi, one per DCI length on the card; the
    collect (one read per length, CRC-RNTI check, dedup) and the grants
    unpacked from the found DCIs; the data pass from the stored front end;
    the result read."""
    from srsran_tpu_torch.pipeline_ctrl import _blind_hypotheses, _viterbi_batch, blind_search_collect
    from srsran_tpu_torch.pipeline_window import window_channel

    sfs = win["sfs"]

    def generate(s):
        tx = gen.dispatch_window(win["payloads"], sfs, win["grants"], overlay=win["overlay"])
        s["rx"] = window_channel(tx, h, amp, seed=seed, device=fe.device)

    def front_end(s):
        s["pf"] = fe.dispatch(s["rx"], sfs)
        s["ctrl"], s["rsrp"], s["noise"] = fe.realize(s["pf"])

    def blind_host(s):
        s["hyps"] = _blind_hypotheses(s["ctrl"], fe.layout, cell, sfs, win["searches"])

    def viterbi(s):
        s["pend"] = (len(sfs), [(d, e, _viterbi_batch(d, e, fe.device)) for d, e in s["hyps"].items()])

    def collect(s):
        s["found"] = blind_search_collect(s["pend"])
        s["dl_grants"] = dl_grants_of(s["found"], cell, win["sent"])

    def data(s):
        grants = s["dl_grants"]
        check(all(g is not None for g in grants), "a DL assignment was not found")
        s["p"] = fe.dispatch_data(s["pf"], grants)

    def results(s):
        s["res"] = fe.results(s["p"])

    return [("generate", generate), ("front end", front_end), ("blind search host", blind_host),
            ("viterbi", viterbi), ("collect", collect), ("data", data), ("results", results)]


def check_ctrl_dl(tag: str, cell, win, fe, s) -> dict:
    """Every sent DCI is found with its bits (found DCIs that were not sent
    are counted), the PCFICH gives the CFI, every PHICH ACK is right, the
    MIB decodes on subframe 0, every TB comes back."""
    from srsran_tpu_torch.phy.phch.pbch import Mib, pbch_decode, pbch_re_indices
    from srsran_tpu_torch.phy.phch.pcfich import pcfich_decode
    from srsran_tpu_torch.pipeline_ctrl import phich_decode_np

    lay, sfs, dev = fe.layout, win["sfs"], fe.device
    ctrl = s["ctrl"]
    check(ctrl.shape == (len(sfs), lay.idx.size) and ctrl.dtype == np.complex64
          and bool(np.isfinite(ctrl.view(np.float32)).all()), f"{tag}: control REs {ctrl.shape} {ctrl.dtype}")
    n_extra = 0
    for t, (hits, sent) in enumerate(zip(s["found"], win["sent"])):
        got = {(r, b.tobytes()) for r, _f, b, _l, _c in hits}
        want = {(r, b.tobytes()) for r, b in sent}
        check(want <= got, f"{tag}: TTI {t}: sent DCIs not found: {want - got}")
        n_extra += len(got - want)
    ctrl_d = torch.from_numpy(ctrl).to(dev)
    cfis = [int(pcfich_decode(ctrl_d[t, lay.pcfich], cell, sf)[0]) for t, sf in enumerate(sfs)]
    check(cfis == [win["cfi"]] * len(sfs), f"{tag}: PCFICH gives {set(cfis)}")
    acks = [phich_decode_np(ctrl[t, lay.phich[0]], cell, sf, 1)[0] for t, sf in enumerate(sfs)]
    check(acks == [bool(a) for a in win["acks"]], f"{tag}: PHICH ACKs {acks}")
    grid, ce, _noise = s["pf"].abc
    pbch = torch.from_numpy(pbch_re_indices(cell).astype(np.int64)).to(dev)
    n_mib = 0
    for t in (t for t, sf in enumerate(sfs) if sf == 0):
        y = grid[t].reshape(grid.shape[1], -1)[:, pbch]
        hh = ce[t, :, 0].reshape(grid.shape[1], -1)[:, pbch]
        x = torch.sum(hh.conj() * y, dim=0) / torch.sum(hh.abs() ** 2, dim=0)
        bits, ports, off, ok = pbch_decode(x, cell)
        mib = Mib.unpack(bits)
        check(ok and ports == 1 and mib.nof_prb == cell.nof_prb and mib.sfn + off == t // 10,
              f"{tag}: TTI {t}: MIB {mib}, ports {ports}, offset {off}, ok {ok}")
        n_mib += 1
    for t, ((tb, ok, _n), sent) in enumerate(zip(s["res"], win["payloads"])):
        check(ok and np.array_equal(tb, sent), f"{tag}: TTI {t}: the TB did not come back")
    return dict(extra_dcis=n_extra, mibs=n_mib)


def ctrl_ul_window(cell, w: int, rng, edge_prbs: int = CTRL_EDGE_PRBS) -> dict:
    """The UL control window on `cell`: TTI t in subframe t mod 10 carries a
    PUSCH grant (widths 9/25/50/90 PRB inside the band edges, MCS 0-23) for
    CTRL_RNTIS[t mod 4] and a PUCCH format-1 ACK on the resource
    CTRL_PUCCH[t mod 2] (1 or 2 bits) from `pucch_format1_encode_np`."""
    from srsran_tpu_torch.phy.phch.pucch import (PucchConfig, _f1_covers, pucch_f1_prb,
                                                 pucch_format1_encode_np)

    n_prb = cell.nof_prb
    room = n_prb - 2 * edge_prbs
    widths = [n for n in (9, 25, 50, 90) if n <= room]
    win = dict(sfs=[], grants=[], payloads=[], res=[], acks=[], prb=[], grids=[])
    for t in range(w):
        sf = t % 10
        while True:
            mcs, nprb = int(rng.integers(0, 24)), int(widths[rng.integers(0, len(widths))])
            g = ul_grant(mcs, edge_prbs + int(rng.integers(0, room - nprb + 1)), nprb, CTRL_RNTIS[t % 4])
            if g.tbs:
                break
        n_pucch, nbits = CTRL_PUCCH[t % 2]
        ack = rng.integers(0, 2, nbits).astype(np.uint8)
        cfg = PucchConfig(n_pucch=n_pucch)
        prbs = [pucch_f1_prb(n_pucch, 2 * sf + slot, n_prb, cfg.delta_shift, covers=_f1_covers(cell))
                for slot in range(2)]
        for key, v in (("sfs", sf), ("grants", g), ("payloads", rng.integers(0, 2, g.tbs).astype(np.uint8)),
                       ("res", n_pucch), ("acks", ack), ("prb", prbs),
                       ("grids", pucch_format1_encode_np(cell, cfg, sf, ack))):
            win[key].append(v)
    win["pucch"] = (np.asarray(win["prb"], np.int64), np.stack(win["grids"]), np.ones(w, bool))
    return win


def ctrl_ul_steps(cell, win, gen, fe, h, amp, seed: int = 0):
    """One UL control loopback window as ordered (span, fn(state)) steps: the
    generator with the PUCCH blocks and `window_channel`; the eNB front end
    (SC-FDMA demod, band edges and per-PRB power, one read); the PUCCH
    format-1 decodes, one batch per resource; the data pass from the stored
    grids; the result read."""
    from srsran_tpu_torch.pipeline_ctrl import pucch_format1_decode_batch
    from srsran_tpu_torch.pipeline_window import window_channel

    sfs = win["sfs"]

    def generate(s):
        tx = gen.dispatch_window(win["payloads"], sfs, win["grants"], pucch=win["pucch"])
        s["rx"] = window_channel(tx, h, amp, seed=seed, device=fe.device)

    def front_end(s):
        s["pf"] = fe.dispatch(s["rx"], sfs)
        s["edge"], s["prb_pow"] = fe.realize_pucch(s["pf"])

    def pucch(s):
        s["pucch_bits"], s["pucch_metric"] = [None] * len(sfs), np.zeros(len(sfs))
        for n_pucch, nbits in CTRL_PUCCH:
            ts = [t for t, r in enumerate(win["res"]) if r == n_pucch]
            grids = np.stack([fe.pucch_prb_grid(s["edge"], t, win["prb"][t]) for t in ts])
            bits, metric = pucch_format1_decode_batch(grids, cell, n_pucch, [sfs[t] for t in ts], nbits)
            for t, b, m in zip(ts, bits, metric):
                s["pucch_bits"][t], s["pucch_metric"][t] = b, m

    def data(s):
        s["p"] = fe.dispatch_data(s["pf"], win["grants"])

    def results(s):
        s["res"] = fe.results(s["p"])

    return [("generate", generate), ("front end", front_end), ("pucch", pucch), ("data", data),
            ("results", results)]


def check_ctrl_ul(tag: str, cell, win, s, edge_prbs: int = CTRL_EDGE_PRBS) -> dict:
    """Every ACK is right with metric > 0.25, each PUSCH PRB receives more
    power than every empty PRB, every TB comes back."""
    w = len(win["sfs"])
    check(s["edge"].shape == (w, cell.nsymb_per_sf, 24 * edge_prbs) and s["edge"].dtype == np.complex64,
          f"{tag}: band edges {s['edge'].shape}")
    for t in range(w):
        check(np.array_equal(s["pucch_bits"][t], win["acks"][t]) and s["pucch_metric"][t] > 0.25,
              f"{tag}: TTI {t}: ACK {s['pucch_bits'][t]} (sent {win['acks'][t]}), metric "
              f"{s['pucch_metric'][t]:.3f}")
    margin = np.inf
    for t, g in enumerate(win["grants"]):
        used = np.zeros(cell.nof_prb, bool)
        used[g.prb_start:g.prb_start + g.nof_prb] = True
        empty = ~used
        empty[list(win["prb"][t])] = False
        margin = min(margin, s["prb_pow"][t][used].min() / s["prb_pow"][t][empty].max())
    check(margin > 1, f"{tag}: a PUSCH PRB receives no more power than an empty one ({margin:.3g})")
    for t, ((tb, ok, _n), sent) in enumerate(zip(s["res"], win["payloads"])):
        check(ok and np.array_equal(tb, sent), f"{tag}: TTI {t}: the TB did not come back")
    return dict(min_ack_metric=float(s["pucch_metric"].min()), pusch_to_empty_power=float(margin))


def profile_kernels(fn) -> tuple[int, float]:
    """(CUDA kernels, device ms) of one fn() under `torch.profiler`."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.count for e in kernels), sum(e.device_time_total for e in kernels) / 1e3


def ctrl_engines(kind: str, cell, w: int, device=None, **kw):
    """(generator, front end) of a control loopback on `cell`."""
    import srsran_tpu_torch.pipeline_ctrl as pc
    import srsran_tpu_torch.pipeline_window as pw

    if kind == "dl":
        return (pw.WindowedEnbDl(cell, cfi=CTRL_CFI, w=w, template="full", device=device),
                pc.WindowedUeFrontEnd(cell, cfi=CTRL_CFI, w=w, max_iterations=6, device=device, **kw))
    return (pw.WindowedUeUl(cell, w=w, device=device),
            pc.WindowedEnbUlFrontEnd(cell, w=w, edge_prbs=CTRL_EDGE_PRBS, max_iterations=6, device=device,
                                     **kw))


def phase_ctrl_dl(dev) -> tuple[tuple[int, int], dict]:
    """Phase 19: the DL control loopback at full width.  Returns ((static,
    dynamic-K) launches, times dict)."""
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.pipeline_ctrl import _viterbi_batch, window_blind_search

    tag = "ctrl loopback dl"
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    gen, fe = ctrl_engines("dl", cell, W_CTRL)
    check(gen.device == dev and fe.device == dev, f"{tag}: the engines did not take the card by default")
    win = ctrl_dl_window(cell, CTRL_CFI, W_CTRL, np.random.default_rng(19))
    h, amp = LOOP_CHANNELS["enb_dl"]
    steps = ctrl_dl_steps(cell, win, gen, fe, h, amp)
    reset_launches()
    s, _ = run_steps(steps, dev)
    launches = read_launches()
    note_shape(tag, s["p"].pack)
    info = check_ctrl_dl(tag, cell, win, fe, s)
    check(launches[1] > 0 and launches[0] == 0, f"{tag}: map launches {launches}")
    found_pub = window_blind_search(s["ctrl"], fe.layout, cell, win["sfs"], win["searches"])
    check(all(len(a) == len(b) and all(x[:2] == y[:2] and np.array_equal(x[2], y[2]) and x[3:] == y[3:]
                                       for x, y in zip(a, b)) for a, b in zip(found_pub, s["found"])),
          f"{tag}: window_blind_search differs from its dispatch and collect")
    # the card's Viterbi against the same function on the CPU, the whole batch
    n_hyp = {d: len(e) for d, e in s["hyps"].items()}
    n_cand = sum(n_hyp.values()) / (W_CTRL * len(CTRL_RNTIS))
    for d, entries in s["hyps"].items():
        on_card = _viterbi_batch(d, entries, dev).cpu()
        check(torch.equal(on_card, _viterbi_batch(d, entries, "cpu")),
              f"{tag}: the Viterbi's bits on the card differ from the CPU's at d={d}")
    print(f"{tag}: 100 PRB CFI {CTRL_CFI} W={W_CTRL}: {fe.layout.n_cce} CCEs, {fe.layout.idx.size} control "
          f"REs, DCI 1A {win['dci_len']} bits, {n_cand:.2f} candidates per RNTI per TTI, {len(CTRL_RNTIS)} "
          f"RNTIs: {n_hyp} hypotheses per Viterbi length (bucket "
          f"{[s['pend'][1][i][2].shape[0] for i in range(len(n_hyp))]}); every sent DCI found "
          f"({info['extra_dcis']} found that were not sent), CFI {CTRL_CFI} in every TTI, every PHICH "
          f"ACK right, {info['mibs']} MIBs, every TB back, {launches[1]} dynamic-K map launches; the "
          f"Viterbi's bits on the card equal the CPU's")
    rx, recv = s["rx"], steps[1:]
    times = time_window(tag, lambda: run_steps(recv, dev, {"rx": rx}, fence=False), W_CTRL)
    spans = median_spans(recv, dev, {"rx": rx})
    st = run_steps(recv[:2], dev, {"rx": rx})[0]
    vit_kernels, vit_ms = profile_kernels(lambda: recv[2][1](st))
    times.update(spans_ms=spans, viterbi_calls_per_window=len(n_hyp), hypotheses=n_hyp,
                 viterbi_kernels_per_window=vit_kernels, viterbi_device_ms_per_window=vit_ms,
                 extra_dcis=info["extra_dcis"], slots_real=sum(s["p"].pack.row_ncb),
                 slots_bucketed=s["p"].pack.key[1])
    print(f"{tag}: spans (fenced, ms): " + ", ".join(f"{k} {v:.3f}" for k, v in spans.items())
          + f"; Viterbi: {len(n_hyp)} call(s) per window, {vit_kernels} kernels, {vit_ms:.3f} ms of "
          f"device time")
    print_times(tag, times)
    return launches, times


def phase_ctrl_ul(dev) -> tuple[tuple[int, int], dict]:
    """Phase 20: the UL control loopback at full width.  Returns ((static,
    dynamic-K) launches, times dict)."""
    from srsran_tpu_torch.phy.common import Cell

    tag = "ctrl loopback ul"
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    gen, fe = ctrl_engines("ul", cell, W_CTRL)
    check(gen.device == dev and fe.device == dev, f"{tag}: the engines did not take the card by default")
    win = ctrl_ul_window(cell, W_CTRL, np.random.default_rng(20))
    h, amp = LOOP_CHANNELS["ue_ul"]
    steps = ctrl_ul_steps(cell, win, gen, fe, h, amp)
    reset_launches()
    s, _ = run_steps(steps, dev)
    launches = read_launches()
    note_shape(tag, s["p"].pack)
    info = check_ctrl_ul(tag, cell, win, s)
    check(launches[1] > 0 and launches[0] == 0, f"{tag}: map launches {launches}")
    # the stored grids are the ones the engine itself computes from the samples
    direct = fe.inner.results(fe.inner.dispatch_window(s["rx"], win["sfs"], win["grants"]))
    check(all(np.array_equal(a[0], b[0]) and a[1:] == b[1:] for a, b in zip(direct, s["res"])),
          f"{tag}: dispatch_data differs from dispatch_window on the same samples")
    print(f"{tag}: 100 PRB W={W_CTRL}: PUSCH grants and format-1 ACKs on n_pucch "
          f"{[r for r, _ in CTRL_PUCCH]}: every ACK right (metric >= {info['min_ack_metric']:.3f}), PUSCH "
          f"PRBs at least {info['pusch_to_empty_power']:.1f}x the power of empty PRBs, every TB back "
          f"(and equal to dispatch_window's), {launches[1]} dynamic-K map launches")
    rx, recv = s["rx"], steps[1:]
    times = time_window(tag, lambda: run_steps(recv, dev, {"rx": rx}, fence=False), W_CTRL)
    spans = median_spans(recv, dev, {"rx": rx})
    times.update(spans_ms=spans, slots_real=sum(s["p"].pack.row_ncb), slots_bucketed=s["p"].pack.key[1], **info)
    print(f"{tag}: spans (fenced, ms): " + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
    print_times(tag, times)
    return launches, times


def stored_ctrl(kind: str):
    """The stored reference control window `kind` ("ue_dl", "enb_ul") with
    the port's classes: (fx, cell, subframe indices, samples (W, 1, sf_len)
    complex64 — what the int8 pairs dequantise to)."""
    from srsran_tpu_torch.phy.common import Cell

    fx = np.load(FIXTURE_CTRL[kind])
    cell = Cell(nof_prb=int(fx["nof_prb"]), nof_ports=1, id=int(fx["cell_id"]))
    ri = fx["q"].astype(np.float32) * fx["scale"][:, None, None, None]
    return fx, cell, fx["sfs"].tolist(), (ri[..., 0] + 1j * ri[..., 1]).astype(np.complex64)


def stored_ctrl_decode(kind: str, device) -> dict:
    """The port's decode of a stored control window, on `device`, float32
    ingest.  ue_dl: the control REs, the found DCIs, the PHICH decisions and
    the TBs of the found DL assignments; enb_ul: the band edges, the PRB
    powers, the PUCCH format-1 and format-2 decodes and the TBs."""
    import srsran_tpu_torch.pipeline_ctrl as pc
    from srsran_tpu_torch.phy.phch.pucch import PucchConfig

    fx, cell, sfs, samples = stored_ctrl(kind)
    w = len(sfs)
    if kind == "ue_dl":
        fe = pc.WindowedUeFrontEnd(cell, cfi=int(fx["cfi"]), w=w, ingest="float32",
                                   max_iterations=int(fx["max_iterations"]), device=device)
        pf = fe.dispatch(samples, sfs)
        ctrl, rsrp, noise = fe.realize(pf)
        searches = [[(int(r), "1A", int(fx["dci_len"]), True) for r in fx["rntis"]]] * w
        found = pc.window_blind_search(ctrl, fe.layout, cell, sfs, searches, device=device)
        phich = [pc.phich_decode_np(ctrl[t, fe.layout.phich[0]], cell, sf, 1) for t, sf in enumerate(sfs)]
        sent = [[(int(fx["sent_rnti"][t, 0]), fx["sent_bits"][t, 0])] for t in range(w)]
        p = fe.dispatch_data(pf, dl_grants_of(found, cell, sent))
        return dict(ctrl=ctrl, rsrp=rsrp, noise=noise, found=found, phich=phich, res=fe.results(p), pack=p.pack)
    fe = pc.WindowedEnbUlFrontEnd(cell, w=w, edge_prbs=int(fx["edge_prbs"]),
                                  max_iterations=int(fx["max_iterations"]), device=device)
    pf = fe.dispatch(samples, sfs)
    edge, prb_pow = fe.realize_pucch(pf)
    grids1 = np.stack([fe.pucch_prb_grid(edge, t, tuple(fx["f1_prb"][t])) for t in range(w)])
    f1 = pc.pucch_format1_decode_batch(grids1, cell, int(fx["f1_n_pucch"]), sfs, int(fx["f1_nbits"]))
    cfg2 = PucchConfig(n_pucch=int(fx["f2_n_pucch"]))
    f2 = [pc.pucch_format2_decode_np(fe.pucch_prb_grid(edge, t, tuple(fx["f2_prb"][t])), cell, cfg2, sf,
                                     int(fx["f2_nbits"])) for t, sf in enumerate(sfs)]
    p = fe.dispatch_data(pf, [ul_grant(*(int(v) for v in row[:3]), int(fx["rnti"])) for row in fx["grant_rows"]])
    return dict(edge=edge, prb_pow=prb_pow, f1=f1, f2=f2, res=fe.results(p), pack=p.pack)


def check_stored_ctrl(kind: str, fx, out) -> str:
    """The port's decode of a stored control window against the reference's:
    control REs or band edges and PRB powers within 2e-5 of the largest
    magnitude, the found DCIs (RNTI, bits, level, CCE), the PHICH and PUCCH
    decisions identical, PUCCH metrics within 1e-3, CRC flags, iteration
    counts and, where the CRC passes, TB bits identical.  Returns a line."""
    def close(got, ref, what):
        err = float(np.abs(got - ref).max())
        check(got.shape == ref.shape and err <= CTRL_RTOL * float(np.abs(ref).max()),
              f"stored ctrl {kind}: {what} differ by {err:.3g}")
        return err

    if kind == "ue_dl":
        err = close(out["ctrl"], fx["ref_ctrl"], "control REs")
        found = [(t, r, b, l, c) for t, hits in enumerate(out["found"]) for r, _f, b, l, c in hits]
        check(len(found) == len(fx["found_t"]), f"stored ctrl ue_dl: {len(found)} DCIs found, "
              f"the reference found {len(fx['found_t'])}")
        for i, (t, r, b, l, c) in enumerate(found):
            check((t, r, l, c) == tuple(int(fx[k][i]) for k in ("found_t", "found_rnti", "found_lvl", "found_cce"))
                  and np.array_equal(b, fx["found_bits"][i]), f"stored ctrl ue_dl: found DCI {i} differs")
        phich = [bool(a) for a, _m in out["phich"]]
        check(phich == fx["ref_phich"].astype(bool).tolist(), f"stored ctrl ue_dl: PHICH {phich}")
        extra = f"{len(found)} DCIs, PHICH {phich}"
    else:
        err = max(close(out["edge"], fx["ref_edge"], "band edges"),
                  close(out["prb_pow"], fx["ref_prb_pow"], "PRB powers"))
        bits1, metric1 = out["f1"]
        check(np.array_equal(bits1, fx["ref_f1_bits"]) and np.abs(metric1 - fx["ref_f1_metric"]).max()
              <= PUCCH_METRIC_ATOL, "stored ctrl enb_ul: PUCCH format 1 differs")
        bits2 = np.stack([b for b, _m in out["f2"]])
        metric2 = np.array([m for _b, m in out["f2"]])
        check(np.array_equal(bits2, fx["ref_f2_bits"]) and np.abs(metric2 - fx["ref_f2_metric"]).max()
              <= PUCCH_METRIC_ATOL, "stored ctrl enb_ul: PUCCH format 2 differs")
        extra = f"PUCCH format 1 {bits1.tolist()}, format 2 identical"
    for i, (tb, ok, n_it) in enumerate(out["res"]):
        check(ok == bool(fx["ref_crc_ok"][i]) and n_it == int(fx["ref_n_it"][i]),
              f"stored ctrl {kind}: TTI {i}: crc_ok {ok}, {n_it} iterations")
        check(not ok or np.array_equal(tb, np.unpackbits(fx["ref_tb_packed"][i], count=tb.size)),
              f"stored ctrl {kind}: TTI {i}: TB bits differ from the reference")
    return (f"stored ctrl {kind}: W={len(out['res'])}, max_abs_err {err:.3g}, {extra}, crc_ok "
            f"{fx['ref_crc_ok'].tolist()} as the reference")


def phase_stored_ctrl(dev) -> tuple[int, int]:
    """Phase 21: the stored control windows.  Returns the (static,
    dynamic-K) launches."""
    reset_launches()
    for kind in CTRL_KINDS:
        fx = stored_ctrl(kind)[0]
        out = stored_ctrl_decode(kind, dev)
        note_shape(f"stored ctrl {kind}", out["pack"])
        print(check_stored_ctrl(kind, fx, out))
    launches = read_launches()
    check(launches[1] > 0 and launches[0] == 0, f"stored ctrl windows: map launches {launches}")
    return launches


# --- phases 22-25: the DL receive chain from air samples -----------------------

VECTORS = Path(__file__).resolve().parent / "tests" / "vectors"
FIXTURE_FRAME = TESTDATA / "ue_dl_frame_100prb.npz"
SI_RNTI = 0xFFFF
# the MIB payload of signal.1.92M.dat (the reference's pbch_file_test.c:235)
GOLDEN_MIB = np.array([0, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                      np.uint8)
# phase 24's 20 MHz link: the eNB app at MCS 26 and CFI 2, full buffer of
# 1400-byte SDUs; the channel h, CFO (subcarriers), timing offset (samples
# at 2048 points, scaled to the cell's FFT) and AWGN amplitude
LINK = dict(cell_id=301, mcs=26, cfi=2, h=0.9 * np.exp(0.3j), cfo=0.12, offset_2048=12345,
            amp=0.01, sdu_bytes=1400, seed=24)
FRAME_CFO_ATOL = FRAME_PSR_RTOL = 1e-4


def golden_checks(device) -> dict:
    """Phase 22: the four decodes of `tests/test_golden_vectors.py` through
    the port on `device`: the MIB of signal.1.92M.dat (2 ports, SFN offset 0,
    sfn 28, 50 PRB, the payload), then on signal.1.92M.amar.dat the cell
    search (PCI 1, sf 0, psr > 10), CFI 3 in all ten subframes with the
    correlation margin, and the SI-RNTI SIBs of subframes 5 (144 bits,
    604004...) and 2 (256 bits, 00800c...)."""
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.ue.ue_dl import UeDlResult, equalizer, front_end
    from srsran_tpu_torch.phy.phch.pcfich import pcfich_decode, pcfich_re_indices
    from srsran_tpu_torch.phy.ue.ue_dl import ue_dl_decode_subframe
    from srsran_tpu_torch.phy.ue.ue_sync import cell_search, mib_search

    load = lambda name: np.fromfile(VECTORS / name, np.complex64)  # noqa: E731
    mib, nports, sfn_off = mib_search(load("signal.1.92M.dat"), Cell(nof_prb=6, id=150), 0,
                                      device=device)
    check((nports, sfn_off, mib.nof_prb, mib.sfn) == (2, 0, 50, 28)
          and np.array_equal(mib.pack(), GOLDEN_MIB), f"golden MIB {mib} ports {nports} off {sfn_off}")
    x = torch.from_numpy(load("signal.1.92M.amar.dat")).to(device)
    cs = cell_search(x, 6, device=device)
    check(cs is not None and (cs.cell_id, cs.sf_idx) == (1, 0) and cs.psr > 10, f"golden cell search {cs}")
    cell = Cell(nof_prb=6, nof_ports=1, id=1)
    idx = torch.from_numpy(pcfich_re_indices(cell).astype(np.int64)).to(device)
    margins, sibs = [], {}
    for sf in range(10):
        sf_x = x[sf * 1920 : (sf + 1) * 1920][None]
        grid, ce, noise = front_end(cell, sf_x, sf, UeDlResult())
        cfi, corr = pcfich_decode(equalizer(grid, ce, noise, 1)(idx), cell, sf)
        c = corr.cpu().numpy()
        check(int(cfi) == 3 and c[2] > 2 * abs(c[0]) and c[2] > 2 * abs(c[1]), f"golden CFI sf {sf}: {c}")
        margins.append(float(c[2] / max(abs(c[0]), abs(c[1]))))
        for tb, ok in ue_dl_decode_subframe(cell, sf_x, sf, SI_RNTI, known_cfi=3, device=device).tbs:
            if ok:
                sibs[sf] = np.packbits(tb).tobytes()
    check(sorted(sibs) == [2, 5] and len(sibs[5]) * 8 == 144 and sibs[5].hex().startswith("604004")
          and len(sibs[2]) * 8 == 256 and sibs[2].hex().startswith("00800c"),
          f"golden SIBs {({k: v.hex()[:6] for k, v in sibs.items()})}")
    return dict(psr=cs.psr, cfo=cs.cfo, min_cfi_margin=min(margins), sib5=sibs[5].hex()[:12],
                sib2=sibs[2].hex()[:12])


def frame_samples(q: np.ndarray, scale) -> np.ndarray:
    """complex64 samples of stored int8 I/Q pairs (n, 2) and their scale."""
    ri = q.astype(np.float32) * np.float32(scale)
    return (ri[:, 0] + 1j * ri[:, 1]).astype(np.complex64)


def check_ue_dl_frame(fx, device) -> dict:
    """Phase 23's checks of a received frame (`tools/make_torch_fixture.py`
    `ue_dl_frame_stimulus`) on `device`: `cell_search` over the first 7
    subframes (cell, offset, subframe, frame type identical; cfo within 1e-4,
    psr within 1e-4 relative), `mib_search` (the MIB, port count and frame
    offset), then a `UeSync` fed one subframe a push and every popped
    subframe through `ue_dl_decode_subframe`: indices, CFI, found DCIs, TB
    bits and CRC identical, snr_db within 1e-3 dB."""
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.ue.ue_dl import ue_dl_decode_subframe
    from srsran_tpu_torch.phy.ue.ue_sync import UeSync, cell_search, mib_search

    nof_prb, rnti = int(fx["nof_prb"]), int(fx["rnti"])
    sf_len = Cell(nof_prb=nof_prb).sf_len
    x = torch.from_numpy(frame_samples(fx["q"], fx["scale"])).to(device)
    cs = cell_search(x[: 7 * sf_len], nof_prb, device=device)
    check(cs is not None and [cs.cell_id, cs.peak_offset, cs.sf_idx, cs.frame_type == "tdd"]
          == fx["ref_cs"].tolist(), f"frame: cell search {cs}, reference {fx['ref_cs'].tolist()}")
    check(abs(cs.cfo - float(fx["ref_cfo"])) <= FRAME_CFO_ATOL
          and abs(cs.psr - float(fx["ref_psr"])) <= FRAME_PSR_RTOL * float(fx["ref_psr"]),
          f"frame: cfo {cs.cfo} psr {cs.psr}, reference {float(fx['ref_cfo'])} {float(fx['ref_psr'])}")
    m, nports, frame_off = mib_search(x, Cell(nof_prb=nof_prb, nof_ports=1, id=cs.cell_id),
                                      int(fx["ref_sf0"]), cs.cfo, device=device)
    check([m.nof_prb, m.phich_length, m.phich_resources, m.sfn, nports, frame_off]
          == fx["ref_mib"].tolist(), f"frame: MIB {m} ports {nports} offset {frame_off}")
    sync = UeSync(nof_prb=nof_prb, device=device)
    got_sf, max_snr_err, k, i = [], 0.0, 0, 0
    tbs = int(fx["tbs"])
    for p in range(0, x.shape[0], sf_len):
        sync.push(x[p : p + sf_len])
        while (out := sync.pop_subframe()) is not None:
            sf, idx = out
            res = ue_dl_decode_subframe(sync.cell, sf[None], idx, rnti,
                                        max_iterations=int(fx["max_iterations"]), device=device)
            check(i < len(fx["ref_sf"]) and idx == int(fx["ref_sf"][i]), f"frame: popped sf {idx} at {i}")
            check(res.cfi == int(fx["ref_cfi"][i]), f"frame: sf {idx}: CFI {res.cfi}")
            n = int(fx["ref_n_dci"][i])
            want = [(fx["ref_dci_bits"][k + j].tolist(), int(fx["ref_dci_agg"][k + j]),
                     int(fx["ref_dci_cce"][k + j])) for j in range(n)]
            check([(b.tolist(), a, c) for b, a, c in res.dcis] == want, f"frame: sf {idx}: DCIs differ")
            k += n
            tb, ok = res.tbs[0]
            check(ok == bool(fx["ref_crc_ok"][i]) and np.array_equal(
                tb, np.unpackbits(fx["ref_tb_packed"][i], count=tbs)), f"frame: sf {idx}: TB differs")
            max_snr_err = max(max_snr_err, abs(res.snr_db - float(fx["ref_snr_db"][i])))
            check(max_snr_err <= SNR_ATOL_DB, f"frame: sf {idx}: snr_db {res.snr_db}")
            got_sf.append(idx)
            i += 1
    check(i == len(fx["ref_sf"]) and sync.state == UeSync.TRACK, f"frame: {i} subframes, {sync.state}")
    return dict(cell=cs.cell_id, cfo=cs.cfo, psr=cs.psr, subframes=got_sf, max_snr_err_db=max_snr_err)


def link_channel(x: torch.Tensor, n0: int, sz: int, gen: torch.Generator) -> torch.Tensor:
    """h·x rotated by LINK's CFO from absolute sample n0, plus AWGN (float64
    phase, complex64 out)."""
    n = torch.arange(n0, n0 + x.shape[0], device=x.device, dtype=torch.float64)
    rot = torch.polar(torch.ones_like(n), (2 * np.pi * LINK["cfo"] / sz) * n)
    noise = torch.randn(2, x.shape[0], generator=gen, device=x.device) * LINK["amp"]
    y = x.to(torch.complex128) * rot * complex(LINK["h"])
    return (y + torch.complex(noise[0], noise[1]).to(torch.complex128)).to(torch.complex64)


def link_run(device, nof_prb: int = 100, n_frames: int = 5, on_track_pop=None) -> dict:
    """Phase 24's link: `EnbApp` (cell 301, MCS 26, CFI 2) with a full buffer
    of seeded 1400-byte SDUs → `link_channel` → `UeApp` (CFI from the
    PCFICH), one subframe of samples a push, 10·n_frames + 1 TTIs.  Checks:
    every TB the UE decodes passes its CRC; the SDUs read out are an unbroken
    run of the sent ones, in order, covering every TTI from the first
    complete frame after the UE reached TRACK to the last but one; UeSync
    never leaves TRACK.  `on_track_pop(push, sf, sf_idx)`, when given, sees
    each subframe UeSync pops in TRACK.  Returns the run's record: per push
    the host ms (synchronised) and CUDA-event ms of `UeApp.process`, per TTI
    the ms of `EnbApp.run_tti`, the TTI of the switch to TRACK."""
    from srsran_tpu_torch.apps.enb import EnbApp
    from srsran_tpu_torch.apps.ue import UeApp
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.phch.ra import dl_tbs
    from srsran_tpu_torch.phy.ue.ue_sync import UeSync

    cuda = torch.device(device).type == "cuda"
    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=LINK["cell_id"])
    enb = EnbApp(cell, mcs=LINK["mcs"], cfi=LINK["cfi"], device=device)
    ue = UeApp(nof_prb=nof_prb, cfi=None, device=device)
    if on_track_pop is not None:
        pop = ue.sync.pop_subframe

        def recorded():
            out = pop()
            if out is not None and ue.sync.state == UeSync.TRACK:
                on_track_pop(len(rec["ue_ms"]), *out)
            return out

        ue.sync.pop_subframe = recorded
    rng = np.random.default_rng(LINK["seed"])
    gen = torch.Generator(device=device).manual_seed(LINK["seed"])
    fill = dl_tbs(LINK["mcs"], nof_prb) // 8 // (LINK["sdu_bytes"] + 3) + 1
    sz, sf_len = cell.symbol_sz, cell.sf_len
    offset = LINK["offset_2048"] * sz // 2048
    sent, sdu_tti = [], []
    carry = torch.zeros(0, dtype=torch.complex64, device=device)
    rec = dict(ue_ms=[], ue_event_ms=[], enb_ms=[], state=[], push_tti=[], track_tti=None,
               left_track=False, first_chunks=[])
    for tti in range(10 * n_frames + 1):
        while len(enb.tx_queue) < fill:
            sdu = rng.integers(0, 256, LINK["sdu_bytes"], dtype=np.uint8).tobytes()
            enb.write_sdu(sdu)
            sent.append(sdu)
            sdu_tti.append(None)
        queued = len(enb.tx_queue)
        sync(device)
        t0 = time.perf_counter()
        x = enb.run_tti()
        sync(device)
        rec["enb_ms"].append((time.perf_counter() - t0) * 1e3)
        first = len(sent) - queued
        for j in range(first, len(sent) - len(enb.tx_queue)):
            sdu_tti[j] = tti
        carry = torch.cat([carry, link_channel(x, tti * sf_len, sz, gen)])
        if tti == 0:
            carry = carry[offset:]
        while carry.shape[0] >= sf_len:
            chunk, carry = carry[:sf_len], carry[sf_len:]
            if len(rec["first_chunks"]) < 7:
                rec["first_chunks"].append(chunk)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
            sync(device)
            t0 = time.perf_counter()
            if ev:
                ev[0].record()
            ue.push_samples(chunk)
            ue.process()
            if ev:
                ev[1].record()
            sync(device)
            rec["ue_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["ue_event_ms"].append(ev[0].elapsed_time(ev[1]) if ev else None)
            rec["push_tti"].append(tti)
            rec["state"].append(ue.sync.state)
            if ue.sync.state == UeSync.TRACK and rec["track_tti"] is None:
                rec["track_tti"] = tti
            rec["left_track"] |= rec["track_tti"] is not None and ue.sync.state != UeSync.TRACK
    got = []
    while (s := ue.read_sdu()) is not None:
        got.append(s)
    m = ue.get_metrics()
    check(rec["track_tti"] is not None and not rec["left_track"], f"link: UeSync states {rec['state']}")
    check(m["rx_tbs"] > 0 and m["rx_tbs_ok"] == m["rx_tbs"], f"link: UE metrics {m}")
    check(bool(got) and got[0] in sent, "link: no SDU came through")
    k = sent.index(got[0])
    check(got == sent[k : k + len(got)], "link: the SDUs read out are not an unbroken run of the sent ones")
    first_frame = (rec["track_tti"] // 10 + 1) * 10
    covered = {sdu_tti[j] for j in range(k, k + len(got))}
    need = set(range(first_frame, 10 * n_frames - 1))
    check(need <= covered, f"link: TTIs {sorted(need - covered)} not delivered")
    bits = 8 * sum(len(s) for s in got)
    rec.update(cell=cell, ue=ue, enb=enb, sdus=len(got), sdu_bits=bits, tbs_ok=m["rx_tbs_ok"],
               first_frame=first_frame, ttis=sorted(covered))
    return rec


def ue_dl_steps(cell, rnti: int, device):
    """One TRACK subframe's receive chain as ordered (span, fn(state)) steps,
    the stages `ue_dl_decode_subframe` composes: OFDM + channel estimate +
    measurements (one read), the PCFICH, the blind search's host part (the
    PDCCH REs' LLRs read back, de-rate-matched per candidate, each DCI
    length), its Viterbi (one call per length on the device, bits read), the
    collect (CRC-RNTI check, format order), the PDSCH (grant, decode).  The
    state holds "sf" (1, sf_len) and "sf_idx"."""
    from srsran_tpu_torch.phy.fec.conv import viterbi_decode
    from srsran_tpu_torch.phy.phch.pdcch import blind_collect, blind_hypotheses
    from srsran_tpu_torch.phy.ue import ue_dl

    def ofdm_chest(s):
        s["res"] = ue_dl.UeDlResult()
        s["grid"], s["ce"], s["noise"] = ue_dl.front_end(cell, s["sf"], s["sf_idx"], s["res"])
        s["eq"] = ue_dl.equalizer(s["grid"], s["ce"], s["noise"], 1)

    def pcfich(s):
        s["res"].cfi = ue_dl.decode_cfi(cell, s["sf_idx"], s["eq"], device)

    def blind_host(s):
        sym = ue_dl.pdcch_symbols(cell, s["sf_idx"], s["res"].cfi, s["eq"], device)
        s["hyps"] = [(fmt, n, *blind_hypotheses(sym, cell, s["sf_idx"], s["res"].cfi, rnti, n))
                     for fmt, n in ue_dl.dci_searches(cell, rnti, 2)]

    def viterbi(s):
        s["bits"] = [viterbi_decode(torch.from_numpy(b).to(device), n + 16).cpu().numpy()
                     for _f, n, _c, b in s["hyps"]]

    def collect(s):
        s["found"] = ue_dl.sort_found([(f, *hit) for (f, n, c, _b), bits in zip(s["hyps"], s["bits"])
                                       for hit in blind_collect(c, bits, rnti, n)])
        s["res"].dcis = [(b, a, c) for _f, b, a, c in s["found"]]

    def pdsch(s):
        for fmt, bits, _agg, cce in s["found"]:
            if ue_dl._decode_grant(s["res"], fmt, bits, cce, s["grid"], s["ce"], s["noise"], cell,
                                   s["sf_idx"], s["res"].cfi, rnti, 1, 5, None, s["eq"], None, s["sf"]):
                break

    return [("ofdm+chest", ofdm_chest), ("pcfich", pcfich), ("blind search host", blind_host),
            ("viterbi", viterbi), ("collect", collect), ("pdsch", pdsch)]


def event_spans(steps, device, state, n: int = 3) -> tuple[dict, dict]:
    """Median fenced host ms and CUDA-event ms of each step over n runs."""
    host, event = {k: [] for k, _ in steps}, {k: [] for k, _ in steps}
    for _ in range(n):
        s = dict(state)
        for name, fn in steps:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            sync(device)
            t0 = time.perf_counter()
            ev[0].record()
            fn(s)
            ev[1].record()
            sync(device)
            host[name].append((time.perf_counter() - t0) * 1e3)
            event[name].append(ev[0].elapsed_time(ev[1]))
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    return {k: med(v) for k, v in host.items()}, {k: med(v) for k, v in event.items()}


def phase_golden(dev) -> tuple[int, int]:
    """Phase 22.  Returns the (static, dynamic-K) launches."""
    reset_launches()
    info = golden_checks(dev)
    launches = read_launches()
    check(launches[0] > 0 and launches[1] == 0, f"golden vectors: map launches {launches}")
    print(f"golden vectors: MIB 2 ports sfn 28 50 PRB; cell search PCI 1 sf 0 psr {info['psr']:.3f} "
          f"cfo {info['cfo']:.5f}; CFI 3 in all ten subframes (margin >= {info['min_cfi_margin']:.2f}x); "
          f"SIBs sf 5 {info['sib5']}... sf 2 {info['sib2']}...; {launches[0]} map launches")
    return launches


def phase_stored_frame(dev) -> tuple[int, int]:
    """Phase 23.  Returns the (static, dynamic-K) launches."""
    fx = np.load(FIXTURE_FRAME)
    reset_launches()
    info = check_ue_dl_frame(fx, dev)
    launches = read_launches()
    check(launches[0] > 0 and launches[1] == 0, f"stored frame: map launches {launches}")
    print(f"stored frame: {int(fx['nof_prb'])} PRB, cell {info['cell']} cfo {info['cfo']:.5f} psr "
          f"{info['psr']:.3f}, MIB {fx['ref_mib'].tolist()}, subframes {info['subframes']}: the "
          f"reference's cell search, MIB, indices, CFIs, DCIs, TBs and CRCs, snr_db within "
          f"{info['max_snr_err_db']:.2g} dB; {launches[0]} map launches")
    return launches


def phase_link(dev, n_frames: int = 5) -> tuple[tuple[int, int], dict, Counter]:
    """Phase 24: the 20 MHz link, timed.  Returns ((static, dynamic-K)
    launches, times dict, the link's launches by kernel shape)."""
    from srsran_tpu_torch.phy.fec import turbo_cuda
    from srsran_tpu_torch.phy.ue.ue_dl import ue_dl_decode_subframe
    from srsran_tpu_torch.phy.ue.ue_sync import UeSync, cell_search

    kept = {}

    def on_pop(push, sf, sf_idx):
        kept["sf"], kept["sf_idx"] = sf.clone(), sf_idx
        if sf_idx in (0, 5):
            kept["pss"], kept["pss_idx"] = sf.clone(), sf_idx

    reset_launches()
    before = Counter(turbo_cuda.SHAPES)
    rec = link_run(dev, 100, n_frames, on_track_pop=on_pop)
    launches = read_launches()
    shapes = Counter(turbo_cuda.SHAPES)
    shapes.subtract(before)
    check(launches[0] > 0, f"link: map launches {launches}")
    mark("phase 24: the link ran; its spans, kernels and times")
    cell, ue = rec["cell"], rec["ue"]
    # warm pushes: TRACK, after two frames of it
    warm = [i for i, t in enumerate(rec["push_tti"]) if t >= rec["track_tti"] + 20]
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    ue_ms, ue_ev = med([rec["ue_ms"][i] for i in warm]), med([rec["ue_event_ms"][i] for i in warm])
    enb_ms = med(rec["enb_ms"][2:])
    # FIND: the cell search over the UE's first 7 subframes of samples
    find_in = torch.cat(rec["first_chunks"])
    find_ms = wall_ms(lambda: cell_search(find_in, 100, device=dev), 1)
    # the sync step alone: a UeSync in TRACK popping a PSS subframe

    def sync_step():
        us = UeSync(nof_prb=100, device=dev)
        us.state, us.cell, us.sf_idx, us.cfo = UeSync.TRACK, cell, kept["pss_idx"], ue.sync.cfo
        us.buf = kept["pss"]
        us.pop_subframe()

    sync_step()
    host_sync = med([wall_ms(sync_step, 1) for _ in range(5)])
    ev_sync = med([cuda_ms(sync_step, 1) for _ in range(5)])
    state = {"sf": kept["sf"][None], "sf_idx": kept["sf_idx"]}
    steps = ue_dl_steps(cell, ue.rnti, dev)
    s, _ = run_steps(steps, dev, dict(state))
    ref = ue_dl_decode_subframe(cell, state["sf"], state["sf_idx"], ue.rnti, device=dev)
    check(s["res"].cfi == ref.cfi and len(s["res"].dcis) == len(ref.dcis)
          and all(np.array_equal(a[0], b[0]) and a[1:] == b[1:] for a, b in zip(s["res"].dcis, ref.dcis))
          and [ok for _, ok in s["res"].tbs] == [ok for _, ok in ref.tbs] == [True]
          and np.array_equal(s["res"].tbs[0][0], ref.tbs[0][0]),
          "link: the steps do not give ue_dl_decode_subframe's result")
    host_spans, ev_spans = event_spans(steps, dev, state)
    one = lambda: ue_dl_decode_subframe(cell, state["sf"], state["sf_idx"], ue.rnti, device=dev)  # noqa: E731
    one()
    before = turbo_cuda.LAUNCHES
    one()
    map_per_sf = turbo_cuda.LAUNCHES - before
    kernels, dev_ms = profile_kernels(one)
    st = run_steps(steps[:3], dev, dict(state))[0]
    vit_kernels, vit_ms = profile_kernels(lambda: steps[3][1](st))
    sf_host = med([wall_ms(one, 1) for _ in range(5)])
    n_hyp = [len(c) for _f, _n, c, _b in st["hyps"]]
    rtf = 1.0 / ue_ms
    mbps = rec["sdu_bits"] / (len(rec["ttis"]) * 1e-3) / 1e6
    times = dict(find_ms=find_ms, ue_ms_per_sf=ue_ms, ue_event_ms_per_sf=ue_ev, rtf=rtf,
                 enb_run_tti_ms=enb_ms, sync_step_ms=host_sync, sync_step_event_ms=ev_sync,
                 spans_host_ms=host_spans, spans_event_ms=ev_spans, decode_host_ms=sf_host,
                 kernels_per_sf=kernels, device_ms_per_sf=dev_ms, busy=dev_ms / sf_host,
                 viterbi_calls_per_sf=len(n_hyp), hypotheses=n_hyp, viterbi_kernels_per_sf=vit_kernels,
                 viterbi_device_ms_per_sf=vit_ms, map_launches_per_sf=map_per_sf,
                 sdus=rec["sdus"], tbs_ok=rec["tbs_ok"], link_mbps=mbps, track_tti=rec["track_tti"],
                 warm_pushes=len(warm))
    print(f"link: 100 PRB MCS 26 CFI 2, h 0.9e^0.3j, CFO {LINK['cfo']}, offset {LINK['offset_2048']}, "
          f"noise {LINK['amp']}, {n_frames} frames: TRACK from TTI {rec['track_tti']}, {rec['tbs_ok']} "
          f"TBs all CRC-clean, {rec['sdus']} SDUs in order covering TTIs {rec['ttis'][0]}-"
          f"{rec['ttis'][-1]} ({mbps:.1f} Mbps of SDUs), UeSync stayed in TRACK; {launches[0]} map "
          f"launches")
    print(f"link: FIND {find_ms:.2f} ms; per TRACK subframe (median of {len(warm)} warm pushes) "
          f"{ue_ms:.2f} ms host, {ue_ev:.2f} ms CUDA events, real-time factor {rtf:.4f}x; "
          f"EnbApp.run_tti {enb_ms:.2f} ms")
    print(f"link: sync step {host_sync:.3f} ms host / {ev_sync:.3f} ms events; spans (fenced, host / "
          f"events, ms): " + ", ".join(f"{k} {host_spans[k]:.3f} / {ev_spans[k]:.3f}" for k in host_spans))
    print(f"link: one decode {sf_host:.2f} ms host, {kernels} kernels, {dev_ms:.3f} ms of device "
          f"time (busy {dev_ms / sf_host:.1%}); Viterbi {len(n_hyp)} calls ({n_hyp} hypotheses), "
          f"{vit_kernels} kernels, {vit_ms:.3f} ms of device time; {map_per_sf} map launches")
    return launches, times, +shapes


# --- phases 26-27: the eNB UL receive chain -------------------------------------

FIXTURE_ENB_UL = TESTDATA / "enb_ul_100prb.npz"
UL_METRIC_RTOL = 1e-4  # PUCCH, PRACH and SRS-SNR metrics, relative
SRS_CE_ATOL = 2e-5  # of the SRS estimate's largest magnitude
RS_DB_ATOL = 1e-3  # refsignal rsrp and rssi [dB]
RS_CFO_ATOL_HZ = 1.0
RS_PSR_RTOL = 1e-4
# phase 27's 20 MHz UL link: UE A's PUSCH (MCS 20, PRB 2..97; PRB 8..97 in
# the PRACH subframe) with UCI every TTI and the SRS on subframe 3; UE B's
# format-1a ACK (its SR resource on subframe 7), UE C's format-2 CQI every
# `cqi_period` TTIs, UE D's format-3 ACKs, UE E's preamble on subframe 1.
# Each UE: EPA at 5 Hz from its own seed, its gain and its delay (samples at
# 2048 points, scaled to the cell's FFT), which all but E pre-compensate by
# timing advance.  Formats 1, 2 and 3 sit in PRB pairs m = 0, 1 and 2.
UL_LINK = dict(cell_id=301, mcs=20, prb_start=2, prach_prb_start=8, rntis=(0x46, 0x47, 0x48, 0x49),
               n_ack=2, n_sr=15, n_cqi=20, n_f3=36, f3_bits=4, cqi_period=5, srs_sf=3, sr_sf=7,
               prach_sf=1, preamble=17, prach_freq_offset=2, gains=(1.0, 0.8, 0.7, 0.9, 1.0),
               delays_2048=(30, 12, 57, 21, 48), doppler_hz=5.0, amp=0.01, seed=27)
UL_UES = ("A", "B", "C", "D", "E")
PUCCH_DTX = 0.25  # format-1 detection threshold of the reference's eNB


def host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def sync_samples(fx) -> np.ndarray:
    """The stored received frame with the CFO its cell search measured taken
    out (float64 phase), as `tools/make_torch_fixture.py` gives it to the
    reference."""
    from srsran_tpu_torch.phy.common import symbol_sz

    x = frame_samples(fx["q"], fx["scale"])
    n = np.arange(len(x))
    return (x * np.exp(-2j * np.pi * float(fx["ref_cfo"]) * n / symbol_sz(int(fx["nof_prb"])))
            ).astype(np.complex64)


def check_enb_ul(fx, device) -> dict:
    """Phase 26's checks of the stored UL subframes on `device`: the plain
    and the SRS subframe's PUSCH (TB bits, CRC, UCI identical, snr_db within
    1e-3 dB), the SRS estimate (ce within 2e-5 of its largest magnitude, snr
    within 1e-4 relative), the three PUCCH formats (bits identical, metrics
    within 1e-4 relative), PRACH (detections and delays identical, metrics
    within 1e-4 relative), and `refsignal_dl_sync_run` on the stored
    received frame under its PCI and a wrong one (found, false_alarm and
    peak_index identical, rsrp and rssi within 1e-3 dB, cfo within 1 Hz,
    psr within 1e-4 relative)."""
    from srsran_tpu_torch.phy.chest.srs import srs_estimate
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.enb.enb_ul import enb_ul_decode_pucch, enb_ul_decode_pusch, enb_ul_fft
    from srsran_tpu_torch.phy.phch.prach import PrachConfig, prach_cp_len, prach_detect, prach_nfft
    from srsran_tpu_torch.phy.phch.pucch import PucchConfig
    from srsran_tpu_torch.phy.phch.pusch import UciCfg
    from srsran_tpu_torch.phy.sync.refsignal_dl_sync import refsignal_dl_sync_run

    cell = Cell(nof_prb=int(fx["nof_prb"]), nof_ports=1, id=int(fx["cell_id"]))
    x = [torch.from_numpy(frame_samples(fx["q"][i], fx["scale"][i])).to(device) for i in range(4)]
    grids = [enb_ul_fft(cell, s[None], device=device) for s in x]
    w, mi = int(fx["w"]), int(fx["max_iterations"])
    grant = ul_grant(int(fx["mcs"]), int(fx["prb_start"]), w, int(fx["rnti"]))
    check(grant.tbs == int(fx["tbs"]), f"stored UL: tbs {grant.tbs}")
    uci_exp = UciCfg(cqi_bits=(0,) * len(fx["sent_cqi"]), ack=(0,), ri=(0,))
    outs = [enb_ul_decode_pusch(cell, int(fx["sf_plain"]), grids[0], grant, mi, device=device),
            enb_ul_decode_pusch(cell, int(fx["sf_srs"]), grids[1], grant, mi, uci=uci_exp,
                                shortened=True, device=device)]
    snr_err = 0.0
    for i, out in enumerate(outs):
        tb, ok, _sb, snr_db = out[:4]
        check(ok == bool(fx["ref_crc_ok"][i]) and np.array_equal(
            tb, np.unpackbits(fx["ref_tb_packed"][i], count=grant.tbs)), f"stored UL: PUSCH {i} differs")
        snr_err = max(snr_err, abs(snr_db - float(fx["ref_snr_db"][i])))
    check(snr_err <= SNR_ATOL_DB, f"stored UL: snr_db off by {snr_err} dB")
    ref_uci = dict(cqi_bits=tuple(fx["ref_uci_cqi"].tolist()), ack=tuple(fx["ref_uci_ack"].tolist()),
                   ri=tuple(fx["ref_uci_ri"].tolist()))
    check(outs[1][4] == ref_uci and ref_uci["cqi_bits"] == tuple(fx["sent_cqi"].tolist()),
          f"stored UL: UCI {outs[1][4]}, reference {ref_uci}")
    ce, snr = (host(v) for v in srs_estimate(grids[1], cell, int(fx["prb_start"]), w, device=device))
    ce_err = float(np.abs(ce - fx["ref_srs_ce"]).max() / np.abs(fx["ref_srs_ce"]).max())
    check(ce_err <= SRS_CE_ATOL and np.allclose(snr, fx["ref_srs_snr"], rtol=UL_METRIC_RTOL, atol=0),
          f"stored UL: SRS ce off by {ce_err}, snr {snr} vs {fx['ref_srs_snr']}")
    metrics = []
    for i, (n, fmt, nb) in enumerate(zip(fx["n_pucch"].tolist(), "123", fx["pucch_bits"].tolist())):
        bits, m = enb_ul_decode_pucch(cell, int(fx["sf_pucch"]), grids[2], PucchConfig(n_pucch=n), fmt,
                                      nb, rnti=int(fx["rnti_f3"]) if fmt == "3" else 0, device=device)
        m = float(host(m))
        check(np.array_equal(host(bits), np.unpackbits(fx["ref_pucch_packed"][i], count=nb))
              and abs(m - fx["ref_pucch_metric"][i]) <= UL_METRIC_RTOL * abs(fx["ref_pucch_metric"][i]),
              f"stored UL: PUCCH format {fmt}: bits {host(bits)}, metric {m}")
        metrics.append(m)
    cp, nfft = prach_cp_len(cell), prach_nfft(cell)
    pm, pd, pdet = (host(v) for v in prach_detect(
        cell, PrachConfig(freq_offset=int(fx["prach_freq_offset"])), x[3][cp : cp + nfft], device=device))
    check(np.array_equal(pdet, fx["ref_prach_det"]) and np.array_equal(pd, fx["ref_prach_delay"])
          and np.allclose(pm, fx["ref_prach_metric"], rtol=UL_METRIC_RTOL, atol=0),
          f"stored UL: PRACH differs ({np.nonzero(pdet)[0].tolist()})")
    frame = np.load(FIXTURE_FRAME)
    xs = torch.from_numpy(sync_samples(frame)).to(device)
    rs = []
    for pci, ref in zip((int(frame["cell_id"]), int(fx["wrong_pci"])), fx["ref_rs"]):
        r = refsignal_dl_sync_run(xs, Cell(nof_prb=int(frame["nof_prb"]), nof_ports=1, id=pci),
                                  device=device)
        check([r.found, r.false_alarm, r.peak_index] == [bool(ref[0]), bool(ref[1]), int(ref[2])],
              f"stored UL: refsignal PCI {pci}: {r}")
        check(abs(r.psr - ref[6]) <= RS_PSR_RTOL * ref[6] and abs(r.rsrp_dbfs - ref[3]) <= RS_DB_ATOL
              and abs(r.rssi_dbfs - ref[4]) <= RS_DB_ATOL and abs(r.cfo_hz - ref[5]) <= RS_CFO_ATOL_HZ,
              f"stored UL: refsignal PCI {pci}: {r}, reference {ref.tolist()}")
        rs.append(r)
    return dict(snr_db=[o[3] for o in outs], max_snr_err_db=snr_err, uci=outs[1][4], srs_ce_err=ce_err,
                srs_snr=float(snr[0]), pucch_metrics=metrics,
                prach=(np.nonzero(pdet)[0].tolist(), int(pd[int(fx["preamble"])])), refsignal=rs)


def ul_link_widths(nof_prb: int) -> tuple[int, int]:
    """UE A's PUSCH widths: from PRB 2, and from PRB 8 in the PRACH subframe,
    each the widest that leaves the two band-edge PUCCH PRBs of each side
    free and factors into 2, 3 and 5."""
    from srsran_tpu_torch.phy.dft_precoding import valid_nof_prb

    return tuple(max(n for n in range(1, nof_prb - 1 - s) if valid_nof_prb(n))
                 for s in (UL_LINK["prb_start"], UL_LINK["prach_prb_start"]))


def ul_tti_plan(cell, tti: int, rng, grants) -> dict:
    """What each UE sends in one TTI.  UE A: its TB and UCI on PUSCH — an ACK
    of 1 or 2 bits (two bits are bundled: the UCI-on-PUSCH encoder carries
    the first one, repeated), RI every 4th TTI, the 4-bit wideband CQI on
    even TTIs and the higher-layer subband report (4 + 2N bits, conv-coded)
    on odd ones; the SRS on `srs_sf`.  UE B: an ACK bit on its format-1
    resource, on the SR resource in `sr_sf`.  UE C: 4 CQI bits every
    `cqi_period` TTIs.  UE D: `f3_bits` ACK bits.  UE E: the preamble on
    `prach_sf`."""
    from srsran_tpu_torch.phy.phch.pusch import UciCfg
    from srsran_tpu_torch.phy.phch.uci import cqi_hl_nof_subbands, cqi_hl_subband_pack

    L, sf = UL_LINK, tti % 10
    grant = grants[int(sf == L["prach_sf"])]
    ack = int(rng.integers(0, 2))
    if tti % 2 == 0:
        cqi = tuple(int(b) for b in rng.integers(0, 2, 4))
    else:
        nsub = cqi_hl_nof_subbands(cell.nof_prb)
        cqi = tuple(int(b) for b in cqi_hl_subband_pack(int(rng.integers(0, 16)),
                                                          rng.integers(0, 4, nsub)))
    uci = UciCfg(cqi_bits=cqi, ack=(ack,) * (1 + tti % 2),
                 ri=(int(rng.integers(0, 2)),) if tti % 4 == 0 else ())
    return dict(
        tti=tti, sf=sf, grant=grant, tb=rng.integers(0, 2, grant.tbs).astype(np.uint8), uci=uci,
        srs=(grants[0].prb_start, grants[0].nof_prb) if sf == L["srs_sf"] else None,
        ack_b=int(rng.integers(0, 2)), n_b=L["n_sr"] if sf == L["sr_sf"] else L["n_ack"],
        cqi_c=rng.integers(0, 2, 4).astype(np.uint8) if tti % L["cqi_period"] == 0 else None,
        f3=rng.integers(0, 2, L["f3_bits"]).astype(np.uint8), prach=sf == L["prach_sf"])


def ul_link_delays(cell) -> list[int]:
    return [d * cell.symbol_sz // 2048 for d in UL_LINK["delays_2048"]]


def prach_subframe(cell, p: torch.Tensor) -> torch.Tensor:
    """A preamble (CP + sequence) at the start of an otherwise empty subframe."""
    return torch.cat([p, p.new_zeros(cell.sf_len - p.shape[0])])


def ue_ul_tx(cell, plan: dict, device) -> tuple[list, dict]:
    """Each UE's (sf_len,) transmission of one TTI, rendered by the port on
    `device` (None where a UE is silent), and the ms each took."""
    from srsran_tpu_torch.phy.phch.prach import PrachConfig
    from srsran_tpu_torch.phy.phch.pucch import PucchConfig
    from srsran_tpu_torch.phy.ue.ue_ul import ue_prach_send, ue_ul_encode

    L, sf = UL_LINK, plan["sf"]
    d = ul_link_delays(cell)
    calls = {
        "A": lambda: ue_ul_encode(cell, sf, pusch=(plan["grant"], plan["tb"]), uci=plan["uci"],
                                  srs=plan["srs"], ta_samples=d[0], device=device),
        "B": lambda: ue_ul_encode(cell, sf, pucch1=(PucchConfig(n_pucch=plan["n_b"]), [plan["ack_b"]]),
                                  ta_samples=d[1], device=device),
        "C": (None if plan["cqi_c"] is None else lambda: ue_ul_encode(
            cell, sf, pucch2=(PucchConfig(n_pucch=L["n_cqi"]), plan["cqi_c"]), ta_samples=d[2],
            device=device)),
        "D": lambda: ue_ul_encode(cell, sf, pucch3=(PucchConfig(n_pucch=L["n_f3"]), plan["f3"],
                                                    L["rntis"][3]), ta_samples=d[3], device=device),
        "E": (None if not plan["prach"] else lambda: prach_subframe(
            cell, ue_prach_send(cell, PrachConfig(freq_offset=L["prach_freq_offset"]), L["preamble"],
                                device=device))),
    }
    out, ms = [], {}
    for ue in UL_UES:
        if calls[ue] is None:
            out.append(None)
            continue
        sync(device)
        t0 = time.perf_counter()
        out.append(calls[ue]())
        sync(device)
        ms[ue] = (time.perf_counter() - t0) * 1e3
    return out, ms


class UlAir:
    """The UL air on `device`: each UE through its own `Channel` (EPA at
    `doppler_hz`, seeded per UE), its propagation delay as a stream (the
    delayed tail runs into the next subframe) and its gain; the sum plus
    seeded AWGN of amplitude `amp`."""

    def __init__(self, cell, device):
        from srsran_tpu_torch.phy.channel.channel import Channel, ChannelConfig
        from srsran_tpu_torch.phy.channel.fading import FadingConfig

        L = UL_LINK
        self.cell, self.device = cell, device
        self.chans = [Channel(ChannelConfig(
            fading=FadingConfig("epa", L["doppler_hz"], cell.srate, L["seed"] + i), srate=cell.srate,
            seed=L["seed"] + i), device=device) for i in range(len(UL_UES))]
        self.tails = [torch.zeros(d, dtype=torch.complex64, device=device) for d in ul_link_delays(cell)]
        self.gen = torch.Generator(device=device).manual_seed(L["seed"])

    def __call__(self, txs) -> torch.Tensor:
        n = self.cell.sf_len
        y = torch.zeros(n, dtype=torch.complex64, device=self.device)
        for i, x in enumerate(txs):
            if x is None:
                x = torch.zeros(n, dtype=torch.complex64, device=self.device)
            buf = torch.cat([self.tails[i], self.chans[i].run(x)])
            self.tails[i] = buf[n:]
            y = y + UL_LINK["gains"][i] * buf[:n]
        noise = torch.randn(2, n, generator=self.gen, device=self.device) * UL_LINK["amp"]
        return y + torch.complex(noise[0], noise[1])


def ul_expected_uci(plan: dict):
    """The UCI sizes the eNB expects in this TTI (its values are not known)."""
    from srsran_tpu_torch.phy.phch.pusch import UciCfg

    u = plan["uci"]
    return UciCfg(cqi_bits=(0,) * len(u.cqi_bits), ack=(0,) * len(u.ack), ri=(0,) * len(u.ri))


def ul_pucch(cell, plan: dict, grid, device) -> dict:
    """The PUCCH decodes of one subframe, read to the host: {ue: (bits, metric)}."""
    from srsran_tpu_torch.phy.enb.enb_ul import enb_ul_decode_pucch
    from srsran_tpu_torch.phy.phch.pucch import PucchConfig

    L, sf = UL_LINK, plan["sf"]
    todo = [("B", plan["n_b"], "1", 1, 0), ("D", L["n_f3"], "3", L["f3_bits"], L["rntis"][3])]
    if plan["cqi_c"] is not None:
        todo.append(("C", L["n_cqi"], "2", 4, 0))
    out = {}
    for ue, n, fmt, nb, rnti in todo:
        bits, m = enb_ul_decode_pucch(cell, sf, grid, PucchConfig(n_pucch=n), fmt, nb, rnti=rnti,
                                      device=device)
        out[ue] = (host(bits).astype(np.uint8), float(host(m)))
    return out


def ul_prach(cell, rx, device):
    """(detected preambles, their delays in ZC samples, their metrics)."""
    from srsran_tpu_torch.phy.phch.prach import PrachConfig, prach_cp_len, prach_detect, prach_nfft

    cp = prach_cp_len(cell)
    metric, delay, det = prach_detect(cell, PrachConfig(freq_offset=UL_LINK["prach_freq_offset"]),
                                      rx[cp : cp + prach_nfft(cell)], device=device)
    idx = torch.nonzero(det).reshape(-1)
    return tuple(host(v).tolist() for v in (idx, delay[idx], metric[idx]))


def ul_srs_snr_db(cell, plan: dict, grid, device) -> float:
    from srsran_tpu_torch.phy.chest.srs import srs_estimate

    _ce, snr = srs_estimate(grid, cell, *plan["srs"], device=device)
    return float(10 * np.log10(float(host(snr)[0]) + 1e-12))


def enb_ul_receive(cell, plan: dict, rx, device) -> dict:
    """The eNB's UL subframe as `EnbStack._process_ul` runs it: `enb_ul_fft`,
    the PUCCH decodes, PRACH on its subframe, the SRS on its subframe, then
    `enb_ul_decode_pusch` with the expected UCI (shortened on the SRS
    subframe).  Results on the host."""
    from srsran_tpu_torch.phy.enb.enb_ul import enb_ul_decode_pusch, enb_ul_fft

    grid = enb_ul_fft(cell, rx[None], device=device)
    res = dict(pucch=ul_pucch(cell, plan, grid, device))
    if plan["prach"]:
        res["prach"] = ul_prach(cell, rx, device)
    if plan["srs"] is not None:
        res["srs_snr_db"] = ul_srs_snr_db(cell, plan, grid, device)
    res["tb"], res["ok"], _sb, res["snr_db"], res["uci"] = enb_ul_decode_pusch(
        cell, plan["sf"], grid, plan["grant"], uci=ul_expected_uci(plan),
        shortened=plan["srs"] is not None, device=device)
    return res


def enb_ul_steps(cell, plan: dict, device):
    """`enb_ul_receive` as ordered (span, fn(state)) steps, with
    `enb_ul_decode_pusch` split into its stages: the channel estimate, the
    PUSCH front end (`pusch_llr`), the UCI (`pusch_uci`: RI/ACK, and the RM
    or Viterbi CQI decode), `dlsch_decode`.  The state holds "rx"."""
    from srsran_tpu_torch.phy.chest.chest_ul import chest_ul
    from srsran_tpu_torch.phy.enb.enb_ul import enb_ul_fft
    from srsran_tpu_torch.phy.phch.pusch import pusch_llr, pusch_uci
    from srsran_tpu_torch.phy.phch.sch import dlsch_decode

    g, short = plan["grant"], plan["srs"] is not None

    def fft(s):
        s["grid"] = enb_ul_fft(cell, s["rx"][None], device=device)

    def pucch(s):
        s["pucch"] = ul_pucch(cell, plan, s["grid"], device)

    def prach(s):
        if plan["prach"]:
            s["prach"] = ul_prach(cell, s["rx"], device)

    def srs(s):
        if short:
            s["srs_snr_db"] = ul_srs_snr_db(cell, plan, s["grid"], device)

    def chest(s):
        s["ce"], noise = chest_ul(s["grid"], cell, g.prb_start, g.nof_prb)
        s["noise"] = torch.mean(noise)

    def front(s):
        s["llr"] = pusch_llr(s["grid"], s["ce"], s["noise"], cell, plan["sf"], g, short)

    def uci(s):
        s["data"], s["coding"], s["uci"] = pusch_uci(s["llr"], cell, g, ul_expected_uci(plan), short)

    def dlsch(s):
        s["tb"], s["ok"], _sb = dlsch_decode(s["data"], s["coding"])

    return [("fft", fft), ("pucch", pucch), ("prach", prach), ("srs", srs), ("chest_ul", chest),
            ("pusch front end", front), ("uci", uci), ("dlsch_decode", dlsch)]


def ul_link_run(device, nof_prb: int = 100, n_frames: int = 4, keep=()) -> dict:
    """Phase 27's link: per TTI the UEs render their subframe through the
    port (`ue_ul_encode`, `ue_prach_send`), `UlAir` sums them, the eNB runs
    `enb_ul_receive`.  Gates: every PUSCH TB CRC-clean and equal to the sent
    one (a lost TB is printed with its TTI; at most one in 40 may be lost);
    every ACK, RI and CQI equal to the sent ones (the subband report passes
    its CRC8); every PUCCH bit equal to the sent one (format 1 above the
    DTX threshold); on each PRACH occasion preamble 17, its delay within ±1
    of the sent one in ZC samples, and no other preamble but its sidelobe in
    the last sample of preamble 18's zone, at a tenth of its metric or less
    (printed and recorded); the SRS SNR above 10 dB.
    `keep`: the TTIs whose (plan, samples) the record keeps.  Returns the
    run's record: per TTI the eNB's host ms (synchronised) and CUDA-event
    ms, per UE the ms of its transmit calls."""
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.phch.prach import PrachConfig, prach_nfft

    L = UL_LINK
    cuda = torch.device(device).type == "cuda"
    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=L["cell_id"])
    w, w_prach = ul_link_widths(nof_prb)
    grants = (ul_grant(L["mcs"], L["prb_start"], w, L["rntis"][0]),
              ul_grant(L["mcs"], L["prach_prb_start"], w_prach, L["rntis"][0]))
    rng = np.random.default_rng(L["seed"])
    air = UlAir(cell, device)
    want_delay = ul_link_delays(cell)[4] * 839 / prach_nfft(cell)
    n_cs = PrachConfig(freq_offset=L["prach_freq_offset"]).n_cs
    rec = dict(cell=cell, grants=grants, enb_ms=[], enb_event_ms=[], enc_ms={u: [] for u in UL_UES},
               lost=[], tbs_ok=0, prach=[], prach_delay=[], prach_sidelobe=[], srs_snr_db=[],
               snr_db=[], kept={})
    for tti in range(10 * n_frames):
        plan = ul_tti_plan(cell, tti, rng, grants)
        txs, ms = ue_ul_tx(cell, plan, device)
        for ue, v in ms.items():
            rec["enc_ms"][ue].append(v)
        rx = air(txs)
        if tti in keep:
            rec["kept"][tti] = (plan, rx.clone())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
        sync(device)
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        res = enb_ul_receive(cell, plan, rx, device)
        if ev:
            ev[1].record()
        sync(device)
        rec["enb_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["enb_event_ms"].append(ev[0].elapsed_time(ev[1]) if ev else None)
        rec["snr_db"].append(res["snr_db"])
        if res["ok"] and np.array_equal(res["tb"], plan["tb"]):
            rec["tbs_ok"] += 1
        else:
            rec["lost"].append(tti)
            print(f"ul link: TTI {tti} (sf {plan['sf']}): PUSCH TB lost (crc_ok {res['ok']}, snr_db "
                  f"{res['snr_db']:.2f})")
        u = plan["uci"]
        want = dict(cqi_bits=u.cqi_bits, ack=u.ack, ri=u.ri)
        check(res["uci"] == want, f"ul link: TTI {tti}: UCI {res['uci']}, sent {want}")
        sent = {"B": [plan["ack_b"]], "D": plan["f3"].tolist()}
        if plan["cqi_c"] is not None:
            sent["C"] = plan["cqi_c"].tolist()
        check(sorted(res["pucch"]) == sorted(sent) and all(
            res["pucch"][ue][0].tolist() == bits for ue, bits in sent.items())
            and res["pucch"]["B"][1] > PUCCH_DTX,
            f"ul link: TTI {tti}: PUCCH {res['pucch']}, sent {sent}")
        if plan["prach"]:
            found, delays, metrics = res["prach"]
            got = dict(zip(found, zip(delays, metrics)))
            # the one other detection the detector can make of this preamble:
            # its sidelobe one ZC sample before its zone, which is the last
            # sample of the next preamble's zone (printed, not hidden)
            side = got.pop(L["preamble"] + 1, None)
            if side is not None:
                rec["prach_sidelobe"].append((tti, side))
                print(f"ul link: TTI {tti}: PRACH also detected preamble {L['preamble'] + 1} at the "
                      f"last sample of its zone (delay {side[0]}, metric {side[1]:.1f} beside "
                      f"{got.get(L['preamble'], (0, 0.0))[1]:.1f}): preamble {L['preamble']}'s "
                      f"sidelobe")
            ok = (list(got) == [L["preamble"]] and abs(got[L["preamble"]][0] - want_delay) <= 1
                  and (side is None or (side[0] == n_cs - 1 and side[1] < got[L["preamble"]][1] / 10)))
            rec["prach"].append(ok)
            rec["prach_delay"].append(delays)
            check(ok, f"ul link: TTI {tti}: PRACH found {found} delays {delays} metrics {metrics}, sent "
                      f"{L['preamble']} at {want_delay:.2f} ZC samples")
        if plan["srs"] is not None:
            rec["srs_snr_db"].append(res["srs_snr_db"])
            check(res["srs_snr_db"] > 10, f"ul link: TTI {tti}: SRS snr {res['srs_snr_db']:.2f} dB")
    n = 10 * n_frames
    check(len(rec["lost"]) <= max(1, n // 40), f"ul link: TBs lost in TTIs {rec['lost']}")
    return rec


def phase_stored_ul(dev) -> tuple[int, int]:
    """Phase 26.  Returns the (static, dynamic-K) launches."""
    fx = np.load(FIXTURE_ENB_UL)
    reset_launches()
    info = check_enb_ul(fx, dev)
    launches = read_launches()
    check(launches[0] > 0 and launches[1] == 0, f"stored UL: map launches {launches}")
    rs = info["refsignal"]
    print(f"stored UL: {int(fx['nof_prb'])} PRB cell {int(fx['cell_id'])}: PUSCH MCS {int(fx['mcs'])} on "
          f"{int(fx['w'])} PRB plain and shortened with UCI {info['uci']}: the reference's TBs, CRCs "
          f"and UCI, snr_db {[round(v, 3) for v in info['snr_db']]} within "
          f"{info['max_snr_err_db']:.2g} dB; SRS ce within {info['srs_ce_err']:.2g}, snr "
          f"{info['srs_snr']:.1f}; PUCCH 1a/2/3 bits, metrics {[round(m, 4) for m in info['pucch_metrics']]}; "
          f"PRACH {info['prach']}; refsignal found {rs[0].found} peak {rs[0].peak_index} cfo "
          f"{rs[0].cfo_hz:.2f} Hz psr {rs[0].psr:.2f}, wrong PCI found {rs[1].found} false alarm "
          f"{rs[1].false_alarm}; {launches[0]} map launches")
    return launches


def phase_ul_link(dev, n_frames: int = 4) -> tuple[tuple[int, int], dict, Counter]:
    """Phase 27: the 20 MHz UL link, timed.  Returns ((static, dynamic-K)
    launches, times dict, the link's launches by kernel shape)."""
    from srsran_tpu_torch.phy.fec import turbo_cuda

    # spans: the second frame's PRACH subframe, an even (RM CQI) TTI, the
    # SRS subframe and an odd (Viterbi CQI) one
    kinds = {11: "prach sf (viterbi cqi)", 12: "rm cqi", 13: "srs sf (viterbi cqi)", 15: "viterbi cqi"}
    reset_launches()
    before = Counter(turbo_cuda.SHAPES)
    rec = ul_link_run(dev, 100, n_frames, keep=tuple(kinds))
    launches = read_launches()
    shapes = Counter(turbo_cuda.SHAPES)
    shapes.subtract(before)
    check(launches[0] > 0, f"ul link: map launches {launches}")
    mark("phase 27: the UL link ran; its spans, kernels and times")
    cell = rec["cell"]
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    warm = range(10, len(rec["enb_ms"]))
    enb_ms, enb_ev = med([rec["enb_ms"][i] for i in warm]), med([rec["enb_event_ms"][i] for i in warm])
    enc = {ue: med(v[len(v) // 4:]) for ue, v in rec["enc_ms"].items()}
    per_kind = {}
    for tti, kind in kinds.items():
        plan, rx = rec["kept"][tti]
        state = {"rx": rx}
        steps = enb_ul_steps(cell, plan, dev)
        s, _ = run_steps(steps, dev, dict(state))
        ref = enb_ul_receive(cell, plan, rx, dev)
        check(s["ok"] == ref["ok"] and np.array_equal(s["tb"], ref["tb"]) and s["uci"] == ref["uci"]
              and all(s["pucch"][k][0].tolist() == ref["pucch"][k][0].tolist() for k in ref["pucch"]),
              f"ul link: the steps do not give enb_ul_receive's result in TTI {tti}")
        host_spans, ev_spans = event_spans(steps, dev, state)
        kern = {}
        st = dict(state)
        for name, fn in steps:
            kern[name] = profile_kernels(lambda: fn(st))
        one = lambda: enb_ul_receive(cell, plan, rx, dev)  # noqa: E731
        one()
        b0 = turbo_cuda.LAUNCHES
        one()
        n_map = turbo_cuda.LAUNCHES - b0
        kernels, dev_ms = profile_kernels(one)
        host_ms = med([wall_ms(one, 1) for _ in range(5)])
        per_kind[kind] = dict(host_ms=host_ms, kernels=kernels, device_ms=dev_ms, busy=dev_ms / host_ms,
                              map_launches=n_map, spans_host_ms=host_spans, spans_event_ms=ev_spans,
                              spans_kernels={k: v[0] for k, v in kern.items()},
                              spans_device_ms={k: v[1] for k, v in kern.items()})
        print(f"ul link: {kind} (TTI {tti}): {host_ms:.2f} ms host, {kernels} kernels, {dev_ms:.3f} ms "
              f"of device time (busy {dev_ms / host_ms:.1%}), {n_map} map launches; spans (fenced: host "
              f"/ events ms, kernels, device ms): " + ", ".join(
                  f"{k} {host_spans[k]:.3f} / {ev_spans[k]:.3f}, {kern[k][0]}, {kern[k][1]:.3f}"
                  for k in host_spans))
    spans = {"uci rm": per_kind["rm cqi"]["spans_host_ms"]["uci"],
             "uci viterbi": per_kind["viterbi cqi"]["spans_host_ms"]["uci"]}
    n = len(rec["enb_ms"])
    times = dict(enb_ms_per_sf=enb_ms, enb_event_ms_per_sf=enb_ev, rtf=1.0 / enb_ms,
                 enb_ms_max=max(rec["enb_ms"][i] for i in warm), ue_ul_encode_ms=enc, kinds=per_kind,
                 uci_spans_ms=spans, tbs_ok=rec["tbs_ok"], ttis=n, lost=rec["lost"],
                 prach_delay=rec["prach_delay"], srs_snr_db=rec["srs_snr_db"],
                 snr_db_range=[min(rec["snr_db"]), max(rec["snr_db"])], map_launches=launches[0],
                 widths=[g.nof_prb for g in rec["grants"]], tbs=[g.tbs for g in rec["grants"]])
    print(f"ul link: 100 PRB, UE A PUSCH MCS 20 on {times['widths']} PRB (tbs {times['tbs']}) with UCI "
          f"every TTI, SRS sf 3, UEs B/C/D on PUCCH 1a/2/3, UE E's preamble 17 on sf 1, EPA 5 Hz, noise "
          f"{UL_LINK['amp']}, {n} TTIs: {rec['tbs_ok']}/{n} TBs CRC-clean and equal (lost: {rec['lost']}), "
          f"every UCI and PUCCH bit right, PRACH delays {rec['prach_delay']}, SRS snr "
          f"{[round(v, 1) for v in rec['srs_snr_db']]} dB, PUSCH snr_db {times['snr_db_range'][0]:.1f}-"
          f"{times['snr_db_range'][1]:.1f}; {launches[0]} map launches")
    print(f"ul link: per UL subframe (median of {len(warm)} after the first frame) {enb_ms:.2f} ms host, "
          f"{enb_ev:.2f} ms CUDA events, real-time factor {1.0 / enb_ms:.4f}x, slowest "
          f"{times['enb_ms_max']:.2f} ms; ue_ul_encode ms per UE per TTI "
          + ", ".join(f"{ue} {v:.2f}" for ue, v in enc.items()))
    return launches, times, +shapes


# --- phases 28-30: the per-TTI LTE stack ------------------------------------------

FIXTURE_STACK = TESTDATA / "full_stack_attach_100prb.json"
# the subscribers of tests/test_full_stack.py (OPc = compute_opc(key, op))
STACK_UES = (("001010123456789", bytes.fromhex("00112233445566778899aabbccddeeff"),
              bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d")),
             ("001010999888777", bytes(range(16)), bytes(16)))
STACK = dict(cell_id=301, mcs=20, rand_state=0x5EED00C0FFEE, seed=28, settle=5, max_attach=200,
             max_traffic=150, dl=(4, 1400), ul=(3, 1000))
# phase 29: two UEs (preambles 11 and 29, the second 40 TTIs later) through
# EPA fading with AWGN, then 20 TTIs of DL and 20 of UL traffic
STACK_LINK = dict(preambles=(11, 29), attach_delays=(0, 40), doppler_hz=5.0, amp=0.01,
                  traffic_ttis=20, dl_bytes=1400, ul_bytes=1000, max_attach=300, max_drain=200)
# phases 35-36: frame structure 2.  The stored TDD attach: configuration 1,
# special subframe 4, with tests/test_tdd.py's traffic (3 DL packets of 48
# B, 3 UL of 40 B); the attached link: special subframe 4, configuration 2
# (M = 4 association sets: multiplexed ACKs) and configuration 1
FIXTURE_STACK_TDD = TESTDATA / "full_stack_attach_tdd_100prb.json"
STACK_TDD = dict(tdd=(1, 4), kw=dict(sr_enabled=True), dl=(3, 48), ul=(3, 40))
# phase 36's link: configuration 2, one UE, neither SRs nor SRS (blind UL
# grants); then in `runs` that link again and two more, two UEs each: (a)
# configuration 2 with SRs, (b) configuration 1 (subframe 3 is U: the UEs
# sound) with SRS and SRs
STACK_LINK_TDD = dict(tdd=(2, 4), n_ues=1, kw={})
STACK_LINK_TDD["runs"] = (dict(STACK_LINK_TDD, tag="1 UE"),
                          dict(tag="a", tdd=(2, 4), n_ues=2, kw=dict(sr_enabled=True)),
                          dict(tag="b", tdd=(1, 4), n_ues=2, kw=dict(srs_enabled=True, sr_enabled=True)))
# phase 30: the stored attach's script on the other data planes
STACK_PLANES = (("dynamic", dict(dynamic_phy=True)),
                ("windowed", dict(windowed_phy=True, phy_window=4)))


def port_stack_modules() -> SimpleNamespace:
    """The port's stack classes, as `StackRun` and `stack_pair` take them."""
    from srsran_tpu_torch.apps import full_stack
    from srsran_tpu_torch.epc import Hss, Mme, Spgw, Subscriber
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.tdd import TddConfig
    from srsran_tpu_torch.stack.nas_ue import Usim
    from srsran_tpu_torch.stack.security import compute_opc

    return SimpleNamespace(EnbStack=full_stack.EnbStack, UeStack=full_stack.UeStack, Cell=Cell,
                           Hss=Hss, Mme=Mme, Spgw=Spgw, Subscriber=Subscriber, Usim=Usim,
                           compute_opc=compute_opc, TddConfig=TddConfig)


def stack_pair(m, nof_prb: int, n_ues: int = 1, enb_kw=None, ue_kw=(), **dev_kw) -> SimpleNamespace:
    """An EPC (HSS with STACK's RAND state, SPGW, MME), an `EnbStack` and
    `n_ues` `UeStack`s of the classes in `m` on one cell (STACK's PCI, one
    port).  `ue_kw`: per-UE constructor arguments; `dev_kw`: `device=` for
    the port, nothing for the reference."""
    cell = m.Cell(nof_prb=nof_prb, nof_ports=1, id=STACK["cell_id"])
    hss = m.Hss()
    hss._rand_state = STACK["rand_state"]
    usims = []
    for i, (imsi, key, op) in enumerate(STACK_UES[:n_ues]):
        opc = m.compute_opc(key, op)
        hss.add_subscriber(m.Subscriber(f"ue{i + 1}", imsi, key, opc, amf=b"\x80\x00", sqn=0))
        usims.append(m.Usim(imsi, key, opc))
    spgw = m.Spgw()
    mme = m.Mme(hss, spgw)
    enb = m.EnbStack(cell, mme, spgw, **dict(dict(mcs=STACK["mcs"]), **(enb_kw or {})), **dev_kw)
    ues = []
    for i, usim in enumerate(usims):
        ue = m.UeStack(cell, usim, **dict(ue_kw[i] if i < len(ue_kw) else {}), **dev_kw)
        if i:
            ue.ue_identity = bytes([0x99 - i, 0x88, 0x77, 0x66, 0x55])
        ues.append(ue)
    return SimpleNamespace(cell=cell, hss=hss, spgw=spgw, mme=mme, enb=enb, ues=ues)


def stack_packets(seed: int, n: int, size: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes() for _ in range(n)]


def stack_registered(ue) -> bool:
    return ue.rrc_state == type(ue).RRC_ACTIVE and ue.nas.state == ue.nas.REGISTERED


class StackRun:
    """The stored attach over one `EnbStack`/`UeStack` pair, one TTI a
    `step`: the eNB's DL subframe to the UE, the UE's UL subframe to the eNB
    the next TTI (`link_dl`/`link_ul` carry them; identity by default).
    `settle` TTIs after the UE registers, STACK's DL packets are queued at
    the SGi and its UL packets at the UE.  Each TTI records both ends'
    stats, both RRC states and the UE's NAS state."""

    def __init__(self, enb, ue, mme, spgw, dl=STACK["dl"], ul=STACK["ul"],
                 link_dl=lambda x: x, link_ul=lambda x: x):
        self.enb, self.ue, self.mme, self.spgw = enb, ue, mme, spgw
        self.link_dl, self.link_ul = link_dl, link_ul
        self.dl_pkts = stack_packets(STACK["seed"], *dl)
        self.ul_pkts = stack_packets(STACK["seed"] + 1, *ul)
        self.ul = None
        self.tti = 0
        self.reg_tti = None
        self.records = []

    def step(self):
        """One TTI; returns (the eNB's DL subframe, the UE's UL subframe)."""
        dl = self.enb.run_tti(self.ul)
        ul = self.ue.run_tti(self.link_dl(dl))
        self.ul = None if ul is None else self.link_ul(ul)
        self.records.append(dict(enb=dict(self.enb.stats), ue=dict(self.ue.stats),
                                 enb_rrc=int(self.enb.rrc_state), ue_rrc=int(self.ue.rrc_state),
                                 nas=int(self.ue.nas.state)))
        if self.reg_tti is None and stack_registered(self.ue):
            self.reg_tti = self.tti
        if self.reg_tti is not None and self.tti == self.reg_tti + STACK["settle"]:
            for p in self.dl_pkts:
                self.spgw.sgi_tx(self.ue.ue_ip, p)
            for p in self.ul_pkts:
                self.ue.send_ip_packet(p)
        self.tti += 1
        return dl, ul

    def delivered(self) -> bool:
        return (len(self.ue.ip_rx) >= len(self.dl_pkts)
                and len(self.spgw.sgi_rx) >= len(self.ul_pkts))

    def run(self, n_ttis: int | None = None):
        """Run `n_ttis` TTIs, or until the packets are through (at most
        STACK's attach and traffic budgets)."""
        if n_ttis is not None:
            while self.tti < n_ttis:
                self.step()
            return self
        while self.reg_tti is None and self.tti < STACK["max_attach"]:
            self.step()
        check(self.reg_tti is not None, f"stack: no attach in {self.tti} TTIs: {self.records[-1]}")
        while not self.delivered() and self.tti < self.reg_tti + STACK["max_traffic"]:
            self.step()
        return self

    def result(self) -> dict:
        return dict(ip=self.ue.ue_ip, imsis=sorted(self.mme.attached_imsis),
                    ip_rx=[p.hex() for p in self.ue.ip_rx],
                    sgi_rx=[[ip, p.hex()] for ip, p in self.spgw.sgi_rx],
                    reg_tti=self.reg_tti, ttis=self.tti)

    def check_traffic(self, tag: str):
        """The gates of every stack phase: registered with AS security on,
        every packet through, in order and intact."""
        ue = self.ue
        check(stack_registered(ue) and ue.cipher_alg == ue.integ_alg == 2,
              f"{tag}: UE not registered with AS security: {self.records[-1]}")
        check(ue.ip_rx == self.dl_pkts, f"{tag}: DL packets {len(ue.ip_rx)}/{len(self.dl_pkts)} "
              f"or out of order")
        check([p for _ip, p in self.spgw.sgi_rx] == self.ul_pkts,
              f"{tag}: UL packets {len(self.spgw.sgi_rx)}/{len(self.ul_pkts)} or out of order")


def check_stack_fixture(fx: dict, run: StackRun) -> int:
    """The port's run of the stored attach against the reference's, TTI by
    TTI.  Returns the TTIs compared."""
    ref = fx["records"]
    check(len(run.records) == len(ref), f"stored attach: {len(run.records)} TTIs, stored {len(ref)}")
    for tti, (got, want) in enumerate(zip(run.records, ref)):
        check(got == want, f"stored attach: TTI {tti}: {got}, stored {want}")
    res = run.result()
    for k in ("ip", "imsis", "ip_rx", "sgi_rx", "reg_tti", "ttis"):
        check(res[k] == fx["result"][k], f"stored attach: {k} {res[k]}, stored {fx['result'][k]}")
    return len(ref)


class StackAir:
    """Phase 29's air on `device`: the DL through one EPA `Channel` (the
    common DL) and each UE's UL through its own; seeded AWGN of amplitude
    STACK_LINK's `amp` on every receiver, from one `torch.Generator`."""

    def __init__(self, cell, n_ues: int, device):
        from srsran_tpu_torch.phy.channel.channel import Channel, ChannelConfig
        from srsran_tpu_torch.phy.channel.fading import FadingConfig

        L = STACK_LINK

        def chan(seed):
            return Channel(ChannelConfig(fading=FadingConfig("epa", L["doppler_hz"], cell.srate, seed),
                                         srate=cell.srate, seed=seed), device=device)

        self.n, self.device = cell.sf_len, device
        self.dl_chan = chan(STACK["seed"])
        self.ul_chans = [chan(STACK["seed"] + 1 + i) for i in range(n_ues)]
        self.gen = torch.Generator(device=device).manual_seed(STACK["seed"])

    def noise(self) -> torch.Tensor:
        v = torch.randn(2, self.n, generator=self.gen, device=self.device) * STACK_LINK["amp"]
        return torch.complex(v[0], v[1])

    def dl(self, x: torch.Tensor, n_ues: int) -> list[torch.Tensor]:
        y = self.dl_chan.run(x)
        return [y + self.noise() for _ in range(n_ues)]

    def ul(self, txs) -> torch.Tensor:
        y = self.noise()
        for chan, x in zip(self.ul_chans, txs):
            y = y + chan.run(torch.zeros(self.n, dtype=torch.complex64, device=self.device)
                             if x is None else x)
        return y


class Timed:
    """Wraps methods of objects so that each call is timed on the host clock
    between two synchronizes; `ms[name]` lists the calls' milliseconds."""

    def __init__(self, device):
        self.device = device
        self.ms: dict = {}
        self.on = True

    def wrap(self, obj, method: str, name: str):
        fn = getattr(obj, method)
        self.ms[name] = []

        def timed(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            sync(self.device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(self.device)
            self.ms[name].append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(obj, method, timed)


class PucchWatch:
    """What each UE sent on PUCCH format 1 and what the eNB read there, for
    `stack_link_run`'s gates.  While it is entered, the port's
    `full_stack.ue_ul_encode` and `full_stack._pucch1_decodes` are
    wrapped: a UE's subframe, sent inside `ue(i)`, is held against the
    eNB's decodes of it in its next TTI.  `counts` per UE: `ack_dtx`, an ACK
    sent, every resource of its ACK read as DTX; `sr_miss`, an SR sent and
    read as DTX; `false_alarm`, an ACK read where the UE sent no ACK, or an
    SR where it sent no PUCCH (an ACK a UE sends on its own SR resource,
    which the dynamic resources reach on wide cells, reads as its SR too:
    the eNB grants a UE that is sending)."""

    DTX = 0.25  # the eNB's DTX threshold of a format-1 metric

    def __init__(self, ues):
        self.ues = ues
        self.counts = [dict(ack_dtx=0, sr_miss=0, false_alarm=0) for _ in ues]
        self.sent = [None] * len(ues)  # (n_pucch, nof_bits) of each UE's last subframe
        self.cur = None

    def __enter__(self):
        from srsran_tpu_torch.apps import full_stack as fs

        self.fs, self.orig = fs, (fs.ue_ul_encode, fs._pucch1_decodes)
        encode, decodes = self.orig

        def ue_ul_encode(*a, pucch1=None, **k):
            if self.cur is not None and pucch1 is not None:
                self.sent[self.cur] = (pucch1[0].n_pucch, len(pucch1[1]))
            return encode(*a, pucch1=pucch1, **k)

        def pucch1_decodes(*a, **k):
            out = decodes(*a, **k)
            self.judge(out)
            return out

        fs.ue_ul_encode, fs._pucch1_decodes = ue_ul_encode, pucch1_decodes
        return self

    def __exit__(self, *exc):
        self.fs.ue_ul_encode, self.fs._pucch1_decodes = self.orig

    @contextlib.contextmanager
    def ue(self, i: int):
        self.cur, self.sent[i] = i, None
        try:
            yield
        finally:
            self.cur = None

    def judge(self, out: dict):
        """`_pucch1_decodes`'s {(rnti, n_pucch, nof_bits): (bits, metric)}
        against what the UEs sent."""
        for i, ue in enumerate(self.ues):
            read = [(b > 0, m > self.DTX) for (r, _n, b), (_bits, m) in out.items() if r == ue.crnti]
            if not read:
                continue
            sent = self.sent[i]
            c = self.counts[i]
            for is_ack in (True, False):
                was_sent = sent is not None and (sent[1] > 0) == is_ack
                hits = [d for a, d in read if a == is_ack]
                if any(hits) and not (was_sent if is_ack else sent is not None):
                    c["false_alarm"] += 1
                elif hits and was_sent and not any(hits):
                    c["ack_dtx" if is_ack else "sr_miss"] += 1


def stack_link_run(device, nof_prb: int = 100, traffic_ttis: int = STACK_LINK["traffic_ttis"],
                   on_step=None, tdd=None, n_ues: int = 2, kw=None) -> dict:
    """Phase 29's link: an `EnbStack` (STACK's cell and MCS) and two
    `UeStack`s (preambles 11 and 29, the second 40 TTIs later) through
    `StackAir`.  After both register (and 10 TTIs for the second's Attach
    Complete), `traffic_ttis` TTIs of full-buffer DL — a `dl_bytes` packet a
    UE a TTI at the SGi — then `traffic_ttis` TTIs of UL — a `ul_bytes`
    packet a UE a TTI — then until everything is through (packet sizes
    scaled by nof_prb / 100).  Gates: both UEs
    registered with AS security on, distinct C-RNTIs and IPs, two PRACH
    detections, every packet delivered in order and intact, and no PUCCH
    format 1 read where its UE sent none: no ACK where the UE sent no ACK,
    no SR where it sent no PUCCH (read by `PucchWatch`).  `on_step(tti,
    phase)` runs after each TTI ("attach", "dl", "ul", "drain").  `n_ues`:
    the first 1 or 2 of those UEs.  `kw`: the stack keywords of both ends
    (`sr_enabled=`, `srs_enabled=`).  With SRs on, no blind UL grant
    reaches a UE with nothing to send, and the eNB releases a UE it has not
    heard for `ul_inactivity_timeout` TTIs: so while the second UE
    attaches, each registered UE sends a 20 B UL packet (through an SR)
    every half of that, and these packets are gated as the others.  `tdd`:
    (UL/DL configuration, special-subframe configuration) of frame
    structure 2 on every end, with its gates too: each PRACH detected on
    subframe 2, no UE energy outside U subframes, no eNB energy in a U
    subframe or past a DwPTS, DL HARQ ACKs received from each UE (counted
    at the eNB's scheduler), and no ACK that a UE sent on PUCCH read as
    DTX.  Returns the run's record: per TTI the host ms (synchronised) and
    CUDA-event ms of `EnbStack.run_tti` and of each `UeStack.run_tti`, the
    subframe index, the split of each end into its DL and UL halves, and
    per UE the ACKs received and the PUCCH format-1 counts of
    `PucchWatch`."""
    from srsran_tpu_torch.phy import tdd as tdd_mod
    from srsran_tpu_torch.phy.ofdm import OfdmConfig

    L = STACK_LINK
    # the packets scale with the cell, so that a narrower cell of the CPU
    # tests carries the same load for its width
    dl_bytes, ul_bytes = (max(1, L[k] * nof_prb // 100) for k in ("dl_bytes", "ul_bytes"))
    cuda = torch.device(device).type == "cuda"
    m = port_stack_modules()
    cfg = None if tdd is None else m.TddConfig(*tdd)
    tdd_kw = dict(kw or {}, **({} if cfg is None else dict(tdd_cfg=cfg)))
    s = stack_pair(m, nof_prb, n_ues=n_ues, enb_kw=tdd_kw,
                   ue_kw=[dict(preamble=p, attach_delay=d, **tdd_kw)
                          for p, d in zip(L["preambles"], L["attach_delays"])], device=device)
    enb, ues, spgw = s.enb, s.ues, s.spgw
    air = StackAir(s.cell, len(ues), device)
    timed = Timed(device)
    timed.wrap(enb, "_process_ul", "enb ul receive")
    timed.wrap(enb, "_build_dl", "enb dl render")
    for i, ue in enumerate(ues):
        timed.wrap(ue, "_process_dl", f"ue{i} dl decode")
        timed.wrap(ue, "_build_ul", f"ue{i} ul encode")
    acks = Counter()  # DL HARQ ACKs the eNB's scheduler received, by C-RNTI
    ack_info = enb.sched.ack_info

    def counted(rnti, pid, ack, *a, **k):
        acks[rnti] += bool(ack)
        return ack_info(rnti, pid, ack, *a, **k)

    enb.sched.ack_info = counted
    watch = PucchWatch(ues)
    rec = dict(enb_ms=[], enb_event_ms=[], ue_ms=[[] for _ in ues], ue_event_ms=[[] for _ in ues],
               phase=[], sf=[], prach_sf=[], cell=s.cell, stack=s, timed=timed, pucch=watch.counts)
    dl_sent = [[] for _ in ues]
    ul_sent = {}
    ul = [None] * len(ues)
    if cfg is not None:
        ofdm = OfdmConfig.from_cell(s.cell, normalize=True)
        dwpts_end = ofdm.symbol_starts()[tdd_mod.nof_dw(cfg) - 1] + ofdm.symbol_sz

    def tdd_gates(tti: int, x, ul):
        """Frame structure 2's gates on the subframes of eNB TTI `tti`."""
        kind = tdd_mod.sf_type(cfg, tti % 10)
        quiet = {tdd_mod.SfType.U: 0, tdd_mod.SfType.S: dwpts_end}.get(kind)
        if quiet is not None:
            check(float(x[..., quiet:].abs().max()) == 0,
                  f"stack link: eNB energy in TTI {tti} ({kind.name}) after sample {quiet}")
        for i, u in enumerate(ul):
            if u is not None and float(u.abs().max()) > 0:
                check(kind == tdd_mod.SfType.U, f"stack link: UE {i} sent in TTI {tti} ({kind.name})")

    def one_tti(phase: str):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None

        def clocked(fn, arg, host, event):
            sync(device)
            t0 = time.perf_counter()
            if ev:
                ev[0].record()
            out = fn(arg)
            if ev:
                ev[1].record()
            sync(device)
            host.append((time.perf_counter() - t0) * 1e3)
            event.append(ev[0].elapsed_time(ev[1]) if ev else None)
            return out

        tti, prach = enb.tti, enb.stats["prach_detected"]
        x = clocked(enb.run_tti, air.ul(ul) if any(u is not None for u in ul) else None,
                    rec["enb_ms"], rec["enb_event_ms"])
        if enb.stats["prach_detected"] > prach:  # in the UEs' subframe of TTI tti - 1
            rec["prach_sf"].append((tti - 1) % 10)
        for i, (ue, y) in enumerate(zip(ues, air.dl(x, len(ues)))):
            with watch.ue(i):
                ul[i] = clocked(ue.run_tti, y, rec["ue_ms"][i], rec["ue_event_ms"][i])
        if cfg is not None:
            tdd_gates(tti, x, ul)
        rec["phase"].append(phase)
        rec["sf"].append(tti % 10)
        if on_step is not None:
            on_step(len(rec["phase"]) - 1, phase)

    keep_alive = enb.ul_inactivity_timeout // 2 if (kw or {}).get("sr_enabled") else 0
    alive_at = [None] * len(ues)

    def attach_tti():
        for i, ue in enumerate(ues):
            if keep_alive and stack_registered(ue) and (
                    alive_at[i] is None or len(rec["phase"]) - alive_at[i] >= keep_alive):
                p = bytes([0xA0 + i]) * 20
                ue.send_ip_packet(p)
                ul_sent.setdefault(ue.ue_ip, []).append(p)
                alive_at[i] = len(rec["phase"])
        one_tti("attach")

    def through():
        got_ul = {}
        for ip, p in spgw.sgi_rx:
            got_ul.setdefault(ip, []).append(p)
        return (all(len(u.ip_rx) >= len(d) for u, d in zip(ues, dl_sent))
                and all(len(got_ul.get(ip, ())) >= len(v) for ip, v in ul_sent.items()), got_ul)

    with watch:
        while not all(stack_registered(u) for u in ues) and len(rec["phase"]) < L["max_attach"]:
            attach_tti()
        check(all(stack_registered(u) for u in ues),
              f"stack link: UEs not registered after {len(rec['phase'])} TTIs: "
              f"{[(u.rrc_state, u.nas.state) for u in ues]}")
        for _ in range(10):  # the second UE's Attach Complete reaches the MME
            attach_tti()
        rec["attached_tti"] = len(rec["phase"])
        rng = np.random.default_rng(STACK["seed"] + 29)
        for _ in range(traffic_ttis):
            for i, ue in enumerate(ues):
                p = rng.integers(0, 256, dl_bytes, dtype=np.uint8).tobytes()
                spgw.sgi_tx(ue.ue_ip, p)
                dl_sent[i].append(p)
            one_tti("dl")
        for _ in range(traffic_ttis):
            for i, ue in enumerate(ues):
                p = rng.integers(0, 256, ul_bytes, dtype=np.uint8).tobytes()
                ue.send_ip_packet(p)
                ul_sent.setdefault(ue.ue_ip, []).append(p)
            one_tti("ul")
        while not through()[0] and len(rec["phase"]) < rec["attached_tti"] + 2 * traffic_ttis + L["max_drain"]:
            one_tti("drain")
    got_ul = through()[1]
    for i, ue in enumerate(ues):
        check(ue.cipher_alg == ue.integ_alg == 2, f"stack link: UE {i} has no AS security")
        check(ue.ip_rx == dl_sent[i], f"stack link: UE {i} got {len(ue.ip_rx)}/{len(dl_sent[i])} DL "
              f"packets or out of order")
        check(got_ul.get(ue.ue_ip) == ul_sent[ue.ue_ip], f"stack link: UE {i}'s UL packets "
              f"{len(got_ul.get(ue.ue_ip, ()))}/{len(ul_sent[ue.ue_ip])} or out of order")
    check(len({u.crnti for u in ues}) == len({u.ue_ip for u in ues}) == len(ues),
          "stack link: the UEs share a C-RNTI or an IP")
    check(enb.stats["prach_detected"] == len(ues), f"stack link: PRACH detections {enb.stats}")
    rec["dl_acks"] = [acks[u.crnti] for u in ues]
    check(all(c["false_alarm"] == 0 for c in watch.counts),
          f"stack link: PUCCH format 1 read where the UE sent none, by UE: {watch.counts}")
    if cfg is not None:
        check(rec["prach_sf"] == [2] * len(ues), f"stack link: PRACH detected on subframes {rec['prach_sf']}")
        check(enb.stats.get("dl_ack", 0) > 0, f"stack link: no DL HARQ ACK received {enb.stats}")
        check(min(rec["dl_acks"]) > 0, f"stack link: DL HARQ ACKs received by UE: {rec['dl_acks']}")
        check(all(c["ack_dtx"] == 0 for c in watch.counts),
              f"stack link: ACKs sent on PUCCH and read as DTX, by UE: {watch.counts}")
    check(sorted(s.mme.attached_imsis) == sorted(imsi for imsi, _k, _o in STACK_UES[:len(ues)]),
          f"stack link: MME attached {s.mme.attached_imsis}")
    rec.update(dl_bits=8 * sum(len(p) for d in dl_sent for p in d),
               ul_bits=8 * sum(len(p) for v in ul_sent.values() for p in v))
    return rec


def stack_steps_synced(run_one, device) -> int:
    """Host synchronisations (`torch.cuda.set_sync_debug_mode`'s warnings)
    made by one call of run_one."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_one()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def stored_stack_run(m, fx: dict, **dev_kw) -> StackRun:
    """A stored attach's `StackRun`, set up on the classes in `m`: the
    fixture's cell width and constructor arguments, its frame structure 2
    configuration on both ends (`tdd`, when there is one) and its traffic
    (`traffic`: (DL, UL) as (packets, bytes); STACK's by default)."""
    tdd = dict(tdd_cfg=m.TddConfig(*fx["tdd"])) if fx.get("tdd") else {}
    s = stack_pair(m, fx["nof_prb"], enb_kw=dict(fx["enb_kw"], **tdd), ue_kw=[dict(fx["ue_kw"], **tdd)],
                   **dev_kw)
    dl, ul = fx.get("traffic", (STACK["dl"], STACK["ul"]))
    return StackRun(s.enb, s.ues[0], s.mme, s.spgw, dl=tuple(dl), ul=tuple(ul))


def phase_stored_stack(dev, path: Path = FIXTURE_STACK, tag: str = "stored attach") -> tuple[int, int]:
    """Phase 28 (and 35 with the TDD fixture): a stored reference attach on
    the card, TTI by TTI.  Returns the (static, dynamic-K) launches."""
    fx = json.loads(path.read_text())
    run = stored_stack_run(port_stack_modules(), fx, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    run.run(len(fx["records"]))
    secs = time.perf_counter() - t0
    launches = read_launches()
    n = check_stack_fixture(fx, run)
    run.check_traffic(tag)
    check(launches[0] > 0, f"{tag}: map launches {launches}")
    print(f"{tag}: {fx['nof_prb']} PRB cell {STACK['cell_id']} MCS {STACK['mcs']} {fx['enb_kw']}"
          + (f" TDD {fx['tdd']}" if fx.get("tdd") else "")
          + f": {n} TTIs equal to the reference's stats, RRC and NAS states TTI by TTI "
          f"(registered at TTI {run.reg_tti}, IP {run.ue.ue_ip}); {len(run.dl_pkts)} DL x "
          f"{len(run.dl_pkts[0])} B and {len(run.ul_pkts)} UL x {len(run.ul_pkts[0])} B packets "
          f"identical; {secs * 1e3 / n:.1f} ms per TTI (both ends, host clock); {launches[0]} map launches")
    return launches


def phase_stack_link(dev) -> tuple[tuple[int, int], dict, Counter]:
    """Phase 29: the 20 MHz attached link, timed.  Returns ((static,
    dynamic-K) launches, times dict, the run's launches by kernel shape)."""
    from srsran_tpu_torch.phy.fec import turbo_cuda

    L = STACK_LINK
    marks = {}

    def on_step(_tti, phase):
        marks[f"map {phase}"] = turbo_cuda.LAUNCHES

    reset_launches()
    before = Counter(turbo_cuda.SHAPES)
    rec = stack_link_run(dev, 100, on_step=on_step)
    launches = read_launches()
    shapes = Counter(turbo_cuda.SHAPES)
    shapes.subtract(before)
    mark("phase 29: the link ran; its host syncs, kernels and times")
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    s = rec["stack"]
    enb, ues = s.enb, s.ues
    att = [i for i, p in enumerate(rec["phase"]) if p != "attach"]
    enb_ms, enb_ev = med([rec["enb_ms"][i] for i in att]), med([rec["enb_event_ms"][i] for i in att])
    ue_ms = [med([v[i] for i in att]) for v in rec["ue_ms"]]
    ue_ev = [med([v[i] for i in att]) for v in rec["ue_event_ms"]]
    # the halves of each end: the wrapped methods run once a TTI each
    halves = {k: med(v[-len(att):]) for k, v in rec["timed"].ms.items()}
    attach_tti = [i for i, p in enumerate(rec["phase"]) if p == "attach"]
    attach_ue_ms = med([rec["ue_ms"][0][i] for i in attach_tti])
    n_traffic = sum(p in ("dl", "ul", "drain") for p in rec["phase"])
    map_attached = (marks[f"map {rec['phase'][-1]}"] - marks["map attach"]) / max(1, len(att))
    # host syncs and kernels of one attached TTI (both ends and the air)
    rec["timed"].on = False
    air = StackAir(s.cell, len(ues), dev)
    ul = [None] * len(ues)

    def one():
        x = enb.run_tti(air.ul(ul) if any(u is not None for u in ul) else None)
        for i, (ue, y) in enumerate(zip(ues, air.dl(x, len(ues)))):
            ul[i] = ue.run_tti(y)

    for i, ue in enumerate(ues):
        for _ in range(2):
            s.spgw.sgi_tx(ue.ue_ip, bytes(L["dl_bytes"]))
            ue.send_ip_packet(bytes(L["ul_bytes"]))
    syncs = [stack_steps_synced(one, dev) for _ in range(5)]
    host = []
    for _ in range(5):
        host.append(wall_ms(one, 1))
    kern = [profile_kernels(one) for _ in range(3)]
    kernels, dev_ms = med([k[0] for k in kern]), med([k[1] for k in kern])
    host_ms = med(host)
    step_ms = enb_ms + sum(ue_ms)
    dl_ttis = sum(p == "dl" for p in rec["phase"])
    span = len(att)
    times = dict(enb_ms_per_tti=enb_ms, enb_event_ms_per_tti=enb_ev, ue_ms_per_tti=ue_ms,
                 ue_event_ms_per_tti=ue_ev, halves_ms=halves, attach_ue_ms_per_tti=attach_ue_ms,
                 rtf_enb=1.0 / enb_ms, rtf_ue=[1.0 / v for v in ue_ms], rtf_system=1.0 / step_ms,
                 host_syncs_per_tti=syncs, kernels_per_tti=kernels, device_ms_per_tti=dev_ms,
                 step_host_ms=host_ms, busy=dev_ms / host_ms, map_launches=launches[0] + launches[1],
                 map_launches_per_attached_tti=map_attached, ttis=len(rec["phase"]),
                 attached_tti=rec["attached_tti"], traffic_ttis=n_traffic,
                 dl_mbps_air=rec["dl_bits"] / (span * 1e-3) / 1e6,
                 ul_mbps_air=rec["ul_bits"] / (span * 1e-3) / 1e6,
                 dl_mbps_wall=rec["dl_bits"] / (span * step_ms * 1e-3) / 1e6,
                 ul_mbps_wall=rec["ul_bits"] / (span * step_ms * 1e-3) / 1e6,
                 enb_stats=dict(enb.stats), ue_stats=[dict(u.stats) for u in ues],
                 crntis=[u.crnti for u in ues], ips=[u.ue_ip for u in ues], dl_acks=rec["dl_acks"],
                 pucch=rec["pucch"])
    print(f"stack link: 100 PRB cell {STACK['cell_id']} MCS {STACK['mcs']}, 2 UEs (preambles "
          f"{L['preambles']}, delays {L['attach_delays']}), EPA {L['doppler_hz']} Hz, AWGN {L['amp']}: "
          f"both registered with AS security by TTI {rec['attached_tti'] - 10}, C-RNTIs "
          f"{times['crntis']}, IPs {times['ips']}, {enb.stats['prach_detected']} PRACH detections; "
          f"{L['traffic_ttis']} TTIs of {L['dl_bytes']} B DL a UE, {L['traffic_ttis']} of "
          f"{L['ul_bytes']} B UL a UE, every packet through in order within {n_traffic} TTIs "
          f"(dl {dl_ttis}); DL HARQ ACKs by UE {rec['dl_acks']}; PUCCH format 1 by UE {rec['pucch']}; "
          f"eNB {enb.stats}; UEs {[u.stats for u in ues]}; {launches} map launches")
    print(f"stack link: per attached TTI (median of {len(att)}): EnbStack.run_tti {enb_ms:.2f} ms host "
          f"/ {enb_ev:.2f} ms events, UeStack.run_tti {[round(v, 2) for v in ue_ms]} ms host / "
          f"{[round(v, 2) for v in ue_ev]} ms events (attach TTIs: UE 0 {attach_ue_ms:.2f} ms); halves "
          + ", ".join(f"{k} {v:.2f}" for k, v in halves.items())
          + f"; real-time factor eNB {1 / enb_ms:.4f}x, UE {1 / ue_ms[0]:.4f}x, system "
          f"{1 / step_ms:.4f}x")
    print(f"stack link: one attached TTI (eNB, 2 UEs, air): {host_ms:.2f} ms host, {kernels} kernels, "
          f"{dev_ms:.3f} ms of device time (busy {dev_ms / host_ms:.1%}), host syncs {syncs}; "
          f"{map_attached:.2f} map launches per attached TTI; IP payload DL "
          f"{times['dl_mbps_air']:.2f} Mbps / UL {times['ul_mbps_air']:.2f} Mbps of air time, "
          f"{times['dl_mbps_wall']:.3f} / {times['ul_mbps_wall']:.3f} Mbps of wall time")
    return launches, times, +shapes


def phase_stack_link_tdd(dev) -> tuple[tuple[int, int], dict, Counter]:
    """Phase 36: the 20 MHz attached link under frame structure 2 in each
    run of `STACK_LINK_TDD` (one UE with blind UL grants, then two UEs with
    SRs, and with SRS and SRs), timed by subframe type.  Gates beyond
    `stack_link_run`'s: no UE released, an SR from each UE in the runs with
    SRs, SRS measured in the runs that sound, static MAP launches and no
    dynamic-K one.  Returns
    ((static, dynamic-K) launches over the runs, times by run, the runs'
    launches by kernel shape)."""
    from srsran_tpu_torch.phy import tdd as tdd_mod
    from srsran_tpu_torch.phy.fec import turbo_cuda

    total, shapes, times = [0, 0], Counter(), {}
    for T in STACK_LINK_TDD["runs"]:
        tag = f"TDD link ({T['tag']})"
        reset_launches()
        before = Counter(turbo_cuda.SHAPES)
        rec = stack_link_run(dev, 100, tdd=T["tdd"], n_ues=T["n_ues"], kw=T["kw"])
        launches = read_launches()
        run_shapes = Counter(turbo_cuda.SHAPES)
        run_shapes.subtract(before)
        shapes.update(+run_shapes)
        total = [t + n for t, n in zip(total, launches)]
        s = rec["stack"]
        enb, ues = s.enb, s.ues
        check(launches[0] > 0 and launches[1] == 0, f"{tag}: map launches {launches}")
        check(enb.stats["ue_released"] == 0, f"{tag}: UEs released {enb.stats}")
        if T["kw"].get("sr_enabled"):
            check(all(u.stats.get("sr_sent", 0) > 0 for u in ues),
                  f"{tag}: SRs sent by UE {[u.stats.get('sr_sent', 0) for u in ues]}")
        if T["kw"].get("srs_enabled"):
            check(enb.stats.get("srs_meas", 0) > 0, f"{tag}: no SRS measured {enb.stats}")
        mark(f"phase 36: {tag} ran; its host syncs, kernels and times")
        med = lambda v: sorted(v)[len(v) // 2] if v else None  # noqa: E731
        cfg = enb.tdd
        att = [i for i, p in enumerate(rec["phase"]) if p != "attach"]
        by_type = {}
        for kind in tdd_mod.SfType:
            idx = [i for i in att if tdd_mod.sf_type(cfg, rec["sf"][i]) == kind]
            by_type[kind.name] = dict(ttis=len(idx), enb_ms=med([rec["enb_ms"][i] for i in idx]),
                                      enb_event_ms=med([rec["enb_event_ms"][i] for i in idx]),
                                      ue_ms=[med([v[i] for i in idx]) for v in rec["ue_ms"]],
                                      ue_event_ms=[med([v[i] for i in idx]) for v in rec["ue_event_ms"]])
        # host syncs, kernels and device time of a frame (10 TTIs: every
        # subframe type), per TTI; the profiler's own cost grows with the
        # frame's kernels, so one frame each
        air = StackAir(s.cell, len(ues), dev)
        ul = [None] * len(ues)

        def frame():
            for _ in range(10):
                x = enb.run_tti(air.ul(ul) if any(u is not None for u in ul) else None)
                for i, (ue, y) in enumerate(zip(ues, air.dl(x, len(ues)))):
                    ul[i] = ue.run_tti(y)

        for ue in ues:
            for _ in range(4):
                s.spgw.sgi_tx(ue.ue_ip, bytes(STACK_LINK["dl_bytes"]))
                ue.send_ip_packet(bytes(STACK_LINK["ul_bytes"]))
        rec["timed"].on = False
        syncs = stack_steps_synced(frame, dev) / 10
        host_ms = wall_ms(frame, 2) / 10
        kernels, dev_ms = (v / 10 for v in profile_kernels(frame))
        span = len(att)
        times[T["tag"]] = t = dict(
            tdd=T["tdd"], kw=T["kw"], by_type=by_type, host_syncs_per_tti=syncs,
            kernels_per_tti=kernels, device_ms_per_tti=dev_ms, step_host_ms=host_ms,
            busy=dev_ms / host_ms, map_launches=launches[0], ttis=len(rec["phase"]),
            attached_tti=rec["attached_tti"], prach_sf=rec["prach_sf"],
            dl_mbps_air=rec["dl_bits"] / (span * 1e-3) / 1e6, ul_mbps_air=rec["ul_bits"] / (span * 1e-3) / 1e6,
            dl_acks=rec["dl_acks"], pucch=rec["pucch"], enb_stats=dict(enb.stats),
            ue_stats=[dict(u.stats) for u in ues], crntis=[u.crnti for u in ues], ips=[u.ue_ip for u in ues])
        print(f"{tag}: 100 PRB cell {STACK['cell_id']} MCS {STACK['mcs']}, TddConfig{T['tdd']} {T['kw']}, "
              f"{len(ues)} UEs, EPA {STACK_LINK['doppler_hz']} Hz, AWGN {STACK_LINK['amp']}: registered "
              f"with AS security by TTI {rec['attached_tti'] - 10}, PRACH on subframes {rec['prach_sf']}, "
              f"C-RNTIs {t['crntis']}, IPs {t['ips']}, none released; every packet through in order by "
              f"TTI {len(rec['phase'])}; DL HARQ ACKs by UE {t['dl_acks']}; PUCCH format 1 by UE "
              f"{t['pucch']}; no UE energy outside U subframes, no eNB energy in U or past the DwPTS; eNB "
              f"{enb.stats}; UEs {[u.stats for u in ues]}; {launches[0]} static map launches")
        for kind, v in by_type.items():
            if v["ttis"]:
                print(f"{tag}: {kind} subframes (median of {v['ttis']} attached TTIs): EnbStack.run_tti "
                      f"{v['enb_ms']:.2f} ms host / {v['enb_event_ms']:.2f} ms events, UeStack.run_tti "
                      f"{[round(x, 2) for x in v['ue_ms']]} ms host / "
                      f"{[round(x, 2) for x in v['ue_event_ms']]} ms events")
        print(f"{tag}: per TTI over a frame: {host_ms:.2f} ms host (two frames), {kernels:.0f} kernels, "
              f"{dev_ms:.3f} ms of device time (busy {dev_ms / host_ms:.1%}), host syncs {syncs}; IP payload "
              f"DL {t['dl_mbps_air']:.2f} Mbps / UL {t['ul_mbps_air']:.2f} Mbps of air time")
    return tuple(total), times, +shapes


def stack_planes_run(device, nof_prb: int = 100, on_run=None) -> dict:
    """Phase 30's runs: `StackRun` (plus 2 DL and 2 UL packets) on
    `dynamic_phy=True` and on `windowed_phy=True, phy_window=4`, both ends,
    each gated as phase 28 and required to have used its plane at both
    ends.  `on_run(mode, stack)` runs before each run (phase 30 notes the
    windows' launch shapes there).  Returns {mode: (StackRun, (the eNB's
    plane stats, the UE's), host seconds)}."""
    out = {}
    for mode, kw in STACK_PLANES:
        s = stack_pair(port_stack_modules(), nof_prb, ue_kw=[kw], enb_kw=kw, device=device)
        if on_run is not None:
            on_run(mode, s)
        sync(device)
        t0 = time.perf_counter()
        run = StackRun(s.enb, s.ues[0], s.mme, s.spgw, dl=(STACK["dl"][0] + 2, STACK["dl"][1]),
                       ul=(STACK["ul"][0] + 2, STACK["ul"][1])).run()
        sync(device)
        secs = time.perf_counter() - t0
        run.check_traffic(f"{mode} plane")
        plane = (s.enb._dyn_ul.stats, s.ues[0]._dyn_phy.stats) if mode == "dynamic" else (
            s.enb._win_ul.stats, s.ues[0]._win_dl.stats)
        check(plane[0]["ttis"] > 0 and plane[1]["ttis"] > 0, f"{mode} plane: unused at an end {plane}")
        out[mode] = (run, tuple(dict(p) for p in plane), secs)
    return out


def phase_stack_planes(dev) -> tuple[dict, dict, dict]:
    """Phase 30: `stack_planes_run` at 100 PRB on the card.  Returns ({mode:
    (static, dynamic-K) launches}, times, {mode: launches by kernel
    shape})."""
    from srsran_tpu_torch.phy.fec import turbo_cuda

    by_mode, times, shapes, marks = {}, {}, {}, {}

    def on_run(mode, s):
        if mode == "windowed":
            for eng, tag in ((s.enb._win_ul.engine, "stack windowed UL"),
                             (s.ues[0]._win_dl.engine, "stack windowed DL")):
                def noted(*a, _fn=eng.dispatch_window, _tag=tag, **k):
                    p = _fn(*a, **k)
                    note_shape(_tag, p.pack)
                    return p

                eng.dispatch_window = noted
        if marks:
            by_mode[marks["mode"]] = read_launches()
            shapes[marks["mode"]] = +(Counter(turbo_cuda.SHAPES) - marks["shapes"])
        marks.update(mode=mode, shapes=Counter(turbo_cuda.SHAPES))
        reset_launches()

    runs = stack_planes_run(dev, 100, on_run=on_run)
    by_mode[marks["mode"]] = read_launches()
    shapes[marks["mode"]] = +(Counter(turbo_cuda.SHAPES) - marks["shapes"])
    for mode, (run, plane, secs) in runs.items():
        launches = by_mode[mode]
        check(launches[1] > 0, f"{mode} plane: no dynamic-K map launch ({launches})")
        times[mode] = dict(ms_per_tti=secs * 1e3 / run.tti, ttis=run.tti, reg_tti=run.reg_tti,
                           map_launches=list(launches), plane_stats=list(plane))
        print(f"{mode} plane: 100 PRB, registered at TTI {run.reg_tti}, {len(run.dl_pkts)} DL and "
              f"{len(run.ul_pkts)} UL packets through in order by TTI {run.tti}; "
              f"{secs * 1e3 / run.tti:.1f} ms per TTI (both ends, host clock); eNB plane {plane[0]}, "
              f"UE plane {plane[1]}; map launches static {launches[0]}, dynamic-K {launches[1]}")
    return by_mode, times, shapes


# phase 31: the windowed control-plane stack (`bench.py`
# `bench_stack_window_rtf`): the bench's cell, MCS and link; its offered load
# (48 DL packets of 400 B and one UL packet of 400 B every 64 TTIs), made
# unique by a sequence number so that every delivery can be held to its
# offer; warm 20 W TTIs, time 10 W; then drain
STACK_WINDOW = dict(cell_id=7, mcs=8, snr_db=30.0, w=64, max_attach=9000, warm_windows=20,
                    timed_windows=10, offer_every=64, dl=(48, 400), ul=(1, 400), max_drain_windows=40,
                    widths=(25, 100))


def stack_window_packet(seq: int, size: int) -> bytes:
    return seq.to_bytes(4, "big") + bytes([seq & 0xFF]) * (size - 4)


def stack_window_run(device, nof_prb: int, w: int = STACK_WINDOW["w"], warm_ttis: int | None = None,
                     timed_ttis: int | None = None, on_stack=None) -> dict:
    """Phase 31's run: a `WindowedCtrlEnb` and a `WindowedCtrlUe` (W = w,
    MCS 8, cell 7) over a `WindowedDeviceLoopback` at 30 dB on `device`.
    The UE attaches (at most STACK_WINDOW's 9000 TTIs), then the bench's
    load is offered for `warm_ttis` (20 W) and `timed_ttis` (10 W) TTIs,
    the second timed on the host clock after a synchronize and by CUDA
    events; two more windows run with each end's `run_tti` fenced; then
    the offer stops and the run drains (at most STACK_WINDOW's 40 windows).
    Gates: registered with RRC active and AS security, every offered DL and
    UL packet delivered exactly once and in order, control windows run.
    `on_stack(enb, ue)` runs before the first TTI.  Returns the run's
    record."""
    from srsran_tpu_torch.apps.windowed_stack import (WindowedCtrlEnb, WindowedCtrlUe,
                                                      WindowedDeviceLoopback)
    from srsran_tpu_torch.epc import Hss, Mme, Spgw, Subscriber
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.fec import turbo_cuda
    from srsran_tpu_torch.stack.nas_ue import Usim
    from srsran_tpu_torch.stack.security import compute_opc
    import srsran_tpu_torch.pipeline_ctrl as pc

    S = STACK_WINDOW
    warm_ttis = S["warm_windows"] * w if warm_ttis is None else warm_ttis
    timed_ttis = S["timed_windows"] * w if timed_ttis is None else timed_ttis
    tag = f"stack window {nof_prb} PRB"
    cuda = torch.device(device).type == "cuda"
    imsi, key, op = STACK_UES[0]
    opc = compute_opc(key, op)
    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=S["cell_id"])
    hss = Hss()
    hss._rand_state = STACK["rand_state"]
    hss.add_subscriber(Subscriber("ue1", imsi, key, opc, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    dev_kw = {} if cuda else {"device": device}
    enb = WindowedCtrlEnb(cell, mme, spgw, mcs=S["mcs"], ctrl_window=w, **dev_kw)
    ue = WindowedCtrlUe(cell, Usim(imsi, key, opc), ctrl_window=w, **dev_kw)
    check(enb.phy_device == ue.phy_device == torch.device(device),
          f"{tag}: the stacks are on {enb.phy_device}, {ue.phy_device}, expected {device}")
    if on_stack is not None:
        on_stack(enb, ue)
    link = WindowedDeviceLoopback(enb, ue, snr_db=S["snr_db"])
    vit_calls = [0]
    viterbi = pc._viterbi_batch

    def counted(*a, **k):
        vit_calls[0] += 1
        return viterbi(*a, **k)

    pc._viterbi_batch = counted
    rec = dict(tag=tag, nof_prb=nof_prb, w=w, enb=enb, ue=ue, spgw=spgw, mme=mme)
    try:
        sync(device)
        t0 = time.perf_counter()
        while not stack_registered(ue) and enb.tti < S["max_attach"]:
            link.step()
        sync(device)
        rec.update(attach_tti=enb.tti, attach_s=time.perf_counter() - t0)
        check(stack_registered(ue) and ue.cipher_alg == ue.integ_alg == 2,
              f"{tag}: no attach in {enb.tti} TTIs: RRC {ue.rrc_state}, NAS {ue.nas.state}, {enb.stats}")
        sent_dl, sent_ul = [], []
        n_dl0, n_ul0 = len(ue.ip_rx), len(spgw.sgi_rx)
        seq = [0]

        def offer():
            if (enb.tti - rec["attach_tti"]) % S["offer_every"]:
                return
            for _ in range(S["dl"][0]):
                p = stack_window_packet(seq[0], S["dl"][1])
                seq[0] += 1
                spgw.sgi_tx(ue.ue_ip, p)
                sent_dl.append(p)
            for _ in range(S["ul"][0]):
                p = stack_window_packet(seq[0], S["ul"][1])
                seq[0] += 1
                ue.send_ip_packet(p)
                sent_ul.append(p)

        def traffic(n):
            for _ in range(n):
                offer()
                link.step()

        traffic(warm_ttis)
        counts0 = (turbo_cuda.LAUNCHES, turbo_cuda.LAUNCHES_DYN, vit_calls[0], enb.stats.get("ul_crc_ok", 0),
                   ue.stats["dl_tbs_ok"], ue.stats["ctrl_windows"])
        rx0 = (sum(map(len, ue.ip_rx)), sum(len(p) for _ip, p in spgw.sgi_rx))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
        sync(device)
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        traffic(timed_ttis)
        if ev:
            ev[1].record()
        sync(device)
        secs = time.perf_counter() - t0
        counts1 = (turbo_cuda.LAUNCHES, turbo_cuda.LAUNCHES_DYN, vit_calls[0], enb.stats.get("ul_crc_ok", 0),
                   ue.stats["dl_tbs_ok"], ue.stats["ctrl_windows"])
        rx1 = (sum(map(len, ue.ip_rx)), sum(len(p) for _ip, p in spgw.sgi_rx))
        windows = timed_ttis / w
        ms = secs * 1e3 / timed_ttis
        rec.update(ms_per_tti=ms, event_ms_per_tti=ev[0].elapsed_time(ev[1]) / timed_ttis if ev else None,
                   rtf=1.0 / ms, timed_ttis=timed_ttis, warm_ttis=warm_ttis,
                   map_dyn_per_window=(counts1[1] - counts0[1]) / windows,
                   map_static_timed=(counts1[0] - counts1[1]) - (counts0[0] - counts0[1]),
                   viterbi_calls_per_window=(counts1[2] - counts0[2]) / windows,
                   ul_crc_ok_timed=counts1[3] - counts0[3], dl_tbs_ok_timed=counts1[4] - counts0[4],
                   ctrl_windows_timed=counts1[5] - counts0[5],
                   dl_mbps_air=8 * (rx1[0] - rx0[0]) / (timed_ttis * 1e-3) / 1e6,
                   ul_mbps_air=8 * (rx1[1] - rx0[1]) / (timed_ttis * 1e-3) / 1e6,
                   dl_mbps_wall=8 * (rx1[0] - rx0[0]) / secs / 1e6,
                   ul_mbps_wall=8 * (rx1[1] - rx0[1]) / secs / 1e6)
        if cuda:
            kernels, dev_ms = profile_kernels(lambda: traffic(w))
            rec.update(kernels_per_tti=kernels / w, device_ms_per_tti=dev_ms / w, busy=dev_ms / w / ms)
        # each end's run_tti fenced, by position in the window: the
        # boundary positions dispatch or realise a window, the rest are
        # quiet
        timed = Timed(device)
        timed.wrap(enb, "run_tti", "enb")
        timed.wrap(ue, "run_tti", "ue")
        pos = []
        for _ in range(2 * w):
            pos.append(enb.tti % w)
            offer()
            link.step()
        timed.on = False
        rd = 4
        boundary = {w - 1, 0, rd - 1, rd, 2 * rd - 1, 2 * rd, 3 * rd - 1}
        med = lambda v: sorted(v)[len(v) // 2] if v else None  # noqa: E731
        spans = {}
        for end in ("enb", "ue"):
            v = timed.ms[end]
            spans[end] = dict(quiet_ms=med([x for x, p in zip(v, pos) if p not in boundary]),
                              boundary_ms={p: med([x for x, q in zip(v, pos) if q == p])
                                           for p in sorted(boundary)})
        rec["fenced"] = spans
        # the offer stops; everything offered must come through
        t_stop = enb.tti
        while ((len(ue.ip_rx) - n_dl0 < len(sent_dl) or len(spgw.sgi_rx) - n_ul0 < len(sent_ul))
               and enb.tti < t_stop + S["max_drain_windows"] * w):
            link.step()
        rec.update(drain_ttis=enb.tti - t_stop, ttis=enb.tti, dl_packets=len(sent_dl), ul_packets=len(sent_ul),
                   viterbi_calls=vit_calls[0])
    finally:
        pc._viterbi_batch = viterbi
    got_ul = [p for _ip, p in list(spgw.sgi_rx)[n_ul0:]]
    check(ue.ip_rx[n_dl0:] == sent_dl, f"{tag}: DL packets {len(ue.ip_rx) - n_dl0}/{len(sent_dl)} "
          f"within {rec['drain_ttis']} TTIs of the offer's end, or not once and in order: {enb.stats}")
    check(got_ul == sent_ul, f"{tag}: UL packets {len(got_ul)}/{len(sent_ul)} within {rec['drain_ttis']} "
          f"TTIs of the offer's end, or not once and in order: {ue.stats}")
    check(stack_registered(ue) and enb.rrc_state == enb.RRC_ACTIVE, f"{tag}: the UE left RRC active")
    check(ue.stats["ctrl_windows"] > 0, f"{tag}: no control window ran")
    rec.update(dl_tbs_ok=ue.stats["dl_tbs_ok"], ul_crc_ok=enb.stats.get("ul_crc_ok", 0),
               ctrl_windows=ue.stats["ctrl_windows"], enb_stats=dict(enb.stats), ue_stats=dict(ue.stats))
    return rec


def phase_stack_window(dev, nof_prb: int) -> tuple[tuple[int, int], dict]:
    """Phase 31 at one width on the card.  Returns ((static, dynamic-K)
    launches, times dict)."""
    tag = f"stack window {nof_prb} PRB"

    def on_stack(enb, ue):
        # phase 12 takes every window's launch shape
        for eng, end in ((enb._ul_fe.inner, "UL"), (ue._fe.inner, "DL")):
            def noted(*a, _fn=eng.dispatch_window_from, _tag=f"{tag} {end}", **k):
                p = _fn(*a, **k)
                note_shape(_tag, p.pack)
                return p

            eng.dispatch_window_from = noted

    reset_launches()
    rec = stack_window_run(dev, nof_prb, on_stack=on_stack)
    launches = read_launches()
    check(launches[0] == 0, f"{tag}: the static MAP mode was launched {launches[0]} times")
    check(launches[1] > 0, f"{tag}: no dynamic-K map launch")
    check(rec["attach_tti"] <= STACK_WINDOW["max_attach"], f"{tag}: attach at TTI {rec['attach_tti']}")
    keys = ("attach_tti", "attach_s", "ms_per_tti", "event_ms_per_tti", "rtf", "warm_ttis", "timed_ttis",
            "dl_mbps_air", "ul_mbps_air", "dl_mbps_wall", "ul_mbps_wall", "dl_tbs_ok", "ul_crc_ok",
            "ctrl_windows", "dl_tbs_ok_timed", "ul_crc_ok_timed", "ctrl_windows_timed", "kernels_per_tti",
            "device_ms_per_tti", "busy", "map_dyn_per_window", "viterbi_calls_per_window", "fenced",
            "drain_ttis", "ttis", "dl_packets", "ul_packets")
    times = {k: rec[k] for k in keys}
    times.update(map_launches=list(launches), enb_stats=rec["enb_stats"], ue_stats=rec["ue_stats"])
    S = STACK_WINDOW
    print(f"{tag}: W={rec['w']} MCS {S['mcs']} cell {S['cell_id']} {S['snr_db']} dB: registered at TTI "
          f"{rec['attach_tti']} ({rec['attach_s']:.1f} s); {rec['dl_packets']} DL x {S['dl'][1]} B and "
          f"{rec['ul_packets']} UL x {S['ul'][1]} B packets offered, all through once and in order "
          f"{rec['drain_ttis']} TTIs after the offer stopped; dl_tbs_ok {rec['dl_tbs_ok']}, ul_crc_ok "
          f"{rec['ul_crc_ok']}, ctrl_windows {rec['ctrl_windows']}; map launches static {launches[0]}, "
          f"dynamic-K {launches[1]}")
    print(f"{tag}: timed {rec['timed_ttis']} TTIs after {rec['warm_ttis']} warm: {rec['ms_per_tti']:.3f} ms "
          f"per TTI host clock, {rec['event_ms_per_tti']:.3f} ms by CUDA events, real-time factor "
          f"{rec['rtf']:.4f}x; {rec['kernels_per_tti']:.1f} kernels and {rec['device_ms_per_tti']:.3f} ms of "
          f"device time per TTI (busy {rec['busy']:.1%}); {rec['map_dyn_per_window']:.2f} map_window_dyn "
          f"launches and {rec['viterbi_calls_per_window']:.2f} Viterbi calls per window; IP DL "
          f"{rec['dl_mbps_air']:.3f} / UL {rec['ul_mbps_air']:.4f} Mbps of air time, "
          f"{rec['dl_mbps_wall']:.4f} / {rec['ul_mbps_wall']:.5f} Mbps of wall time")
    print(f"{tag}: fenced run_tti ms (quiet median; boundary positions): "
          + "; ".join(f"{end} quiet {v['quiet_ms']:.3f}, " + ", ".join(
              f"[{p}] {m:.2f}" for p, m in v["boundary_ms"].items()) for end, v in rec["fenced"].items()))
    return launches, times


def phase_dyn_shapes(dev, shapes) -> tuple[float, list]:
    """Phase 12, second half: the dynamic-K kernel at every (B, nw, lw, T)
    that phase 30's dynamic plane launched it at (`turbo_cuda.SHAPES`), on
    codeblocks of mixed K up to the bucket's K_max, against the plain
    version below each K.  Returns (max_abs_err, [dict per shape])."""
    from srsran_tpu_torch.phy.fec import turbo_cuda
    from srsran_tpu_torch.phy.fec.cbsegm import CB_SIZES
    from srsran_tpu_torch.phy.fec.turbo import map_pass_plain

    max_err, rows = 0.0, []
    for (b, nw, lw, T, _dyn), n in sorted(shapes.items()):
        k_max = nw * lw
        sizes = [k for k in CB_SIZES if k <= k_max]
        ks = [k_max] + np.random.default_rng(b + k_max).choice(sizes, b - 1).tolist()
        lx, lz, beta_k, k_vec, below_k = dyn_map_inputs(k_max, ks, seed=b + k_max, device=dev)
        got = turbo_cuda.map_pass(lx, lz, beta_k, nw, lw, T, k_vec=k_vec)
        ref = map_pass_plain(lx, lz, beta_k, k_max, k_vec, layout=(nw, lw, T))
        torch.cuda.synchronize()
        err = float((got - ref)[below_k].abs().max())
        same = bool(torch.equal((got > 0)[below_k], (ref > 0)[below_k]))
        check(bool(torch.isfinite(got[below_k]).all()) and err <= MAP_ATOL and same,
              f"dyn kernel disagrees with plain at B={b} K_max={k_max}: {err}, bits {same}")
        ms = queued_ms(lambda: turbo_cuda.map_pass(lx, lz, beta_k, nw, lw, T, k_vec=k_vec), 50)
        plain = cuda_ms(lambda: map_pass_plain(lx, lz, beta_k, k_max, k_vec, layout=(nw, lw, T)), 3)
        bound, by = map_bound(lx, lz, beta_k, (nw, lw, T), k_vec)
        max_err = max(max_err, err)
        rows.append(dict(shape=[b, k_max], layout=[nw, lw, T], launches=n, ms=ms, plain_ms=plain,
                         bound_ms=bound, bound_by=by, max_abs_err=err))
        print(f"map dyn B={b} K_max={k_max} (nw={nw} lw={lw} T={T}, {n} launches, {len(set(ks))} sizes "
              f"of K): max_abs_err below K {err:.3g}, hard bits identical; kernel {ms:.4f} ms, plain "
              f"{plain:.3f} ms, bound {bound:.3g} ms by {by} ({bound / ms:.2%} of it)")
    return max_err, rows


# phases 32-34: the run scripts as processes (`python -m srsran_tpu_torch.apps.*`),
# each process on the card unless given `--device`.  Phase 32 is the
# three-process `run_lte` (`run_lte_3proc`: EPC, eNB and UE roles on real
# sockets) at 100 PRB with the reference test's traffic, phase 33
# `run_lte_demo` at 100 PRB in one process, phase 34 `enb_app` -> `ue_app`
# over UDP through the native ring at the README's 6 PRB and cell 42.
ROOT = Path(__file__).resolve().parent
RUN_LTE = dict(prb=100, duration=12.0, n_dl=12, n_ul=6, min_ip_rx=6, min_sgi_rx=3)
RUN_LTE_IMSI = "001010123456789"
UDP_APPS = dict(prb=6, cell_id=42, ttis=200, payload_period=5, ue_duration=15.0)
# the eNB's SDU of TTI t (`apps/enb_app.py`) and the length of one
UDP_PAYLOAD = re.compile(rb"(tti-(\d{6})-payload)\1")
MAC_PCAP_CONTEXT = 19  # bytes of the mac-lte context before a PDU (`runtime.pcap.MacPcap`)


def port_cmd(app: str) -> list[str]:
    """The argv that runs one of the port's run scripts."""
    return [sys.executable, "-u", "-m", f"srsran_tpu_torch.apps.{app}"]


def child_env(**extra) -> dict:
    """The environment of a child process: the repo on its path."""
    import os

    path = os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, PYTHONPATH=path, **extra)


def free_ports(n: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class Child:
    """A child process whose merged output one thread collects line by line."""

    def __init__(self, argv: list[str], env: dict):
        import threading

        self.argv = argv
        self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                     env=env, cwd=ROOT)
        self.lines: list[str] = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, text: str, timeout: float) -> bool:
        """True once a line holds `text`; False at the timeout or the exit."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if any(text in line for line in self.lines):
                return True
            if self.proc.poll() is not None and not self._reader.is_alive():
                return any(text in line for line in self.lines)
            time.sleep(0.05)
        return False

    def finish(self, timeout: float) -> int:
        """The exit code; killed at the timeout."""
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self._reader.join(5)
        return rc

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def json_line(self, key: str, value) -> dict | None:
        """The last JSON object of the output whose `key` is `value`."""
        for line in reversed(self.lines):
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(d, dict) and d.get(key) == value:
                return d
        return None

    def tail(self, n: int = 40) -> str:
        return "\n".join(self.lines[-n:])


def run_lte_3proc(prb: int = RUN_LTE["prb"], duration: float = RUN_LTE["duration"], cmds=None,
                  role_args=None, prefix=(), extra=(), env=None) -> dict:
    """The three roles of `run_lte_3proc` as child processes on free ports:
    the EPC first, then the eNB once the EPC listens, and the UE beside it
    (it retries its connection).  `cmds` maps a role to its argv (default:
    the port's script), `role_args` a role to extra arguments (`--device
    cpu`), `prefix` goes before every argv (`ip netns exec ...`) and `extra`
    after the common arguments (`--tun --netns ...`).  Returns {role: its
    result line} with "rc" (exit codes), "wall_s" (start to the last exit)
    and "out" (each role's last lines); a role that exits non-zero or
    prints no result line fails the run."""
    cmds = cmds or {r: port_cmd("run_lte_3proc") for r in ("epc", "enb", "ue")}
    role_args = role_args or {}
    env = env or child_env()
    p1, p2, p3 = free_ports(3)
    common = ["--duration", str(duration), "--prb", str(prb), "--n-dl", str(RUN_LTE["n_dl"]),
              "--n-ul", str(RUN_LTE["n_ul"]), *extra]
    argv = {"epc": ["--role", "epc", "--s1ap-port", str(p1), "--gtpu-port", str(p2)],
            "enb": ["--role", "enb", "--s1ap", f"127.0.0.1:{p1}", "--gtpu", f"127.0.0.1:{p2}",
                    "--phy-port", str(p3)],
            "ue": ["--role", "ue", "--phy", f"127.0.0.1:{p3}"]}
    children: dict[str, Child] = {}
    t0 = time.perf_counter()
    try:
        for role in ("epc", "enb", "ue"):
            if role == "enb":
                check(children["epc"].wait_for('"epc": "listening"', 120),
                      f"run_lte_3proc: the EPC does not listen:\n{children['epc'].tail()}")
            children[role] = Child([*prefix, *cmds[role], *common, *argv[role], *role_args.get(role, ())], env)
        out = {"rc": {}, "out": {}}
        for role in ("ue", "enb", "epc"):
            c = children[role]
            out["rc"][role] = c.finish(duration + 300)
            out["out"][role] = c.tail()
            out[role] = c.json_line("role", role)
        out["wall_s"] = time.perf_counter() - t0
    finally:
        for c in children.values():
            c.stop()
    for role in ("epc", "enb", "ue"):
        check(out["rc"][role] == 0 and out[role] is not None,
              f"run_lte_3proc: the {role} role exited {out['rc'][role]} with "
              f"{'a' if out[role] else 'no'} result line:\n{out['out'][role]}")
    return out


def check_run_lte(out: dict, min_ttis: int = 1):
    """The gates of the reference's `tests/test_run_lte_3proc.py` on a
    three-process run: the UE registered, the EPC attached the one IMSI, IP
    both ways (at least 6 packets DL, 3 UL), and at least `min_ttis` TTIs."""
    ue, enb, epc = out["ue"], out["enb"], out["epc"]
    check(ue["registered"], f"run_lte_3proc: the UE did not register: {ue}")
    check(epc["attached"] == [RUN_LTE_IMSI], f"run_lte_3proc: the EPC attached {epc['attached']}")
    check(ue["ip_rx"] >= RUN_LTE["min_ip_rx"], f"run_lte_3proc: {ue['ip_rx']} DL packets at the UE")
    check(epc["sgi_rx"] >= RUN_LTE["min_sgi_rx"], f"run_lte_3proc: {epc['sgi_rx']} UL packets at the SGi")
    check(enb["ttis"] >= min_ttis, f"run_lte_3proc: {enb['ttis']} TTIs, expected at least {min_ttis}")


def phase_run_lte(dev) -> tuple[tuple[int, int], dict, Counter]:
    """Phase 32: `run_lte_3proc` at 100 PRB with the eNB and the UE on the
    card.  Returns ((static, dynamic-K) launches of both PHY processes, the
    times and counts, the static launch shapes of both)."""
    out = run_lte_3proc()
    check_run_lte(out)
    shapes: Counter = Counter()
    launches = [0, 0]
    for role in ("enb", "ue"):
        r = out[role]
        check(r["device"] == str(dev), f"run_lte_3proc: the {role} ran on {r['device']}, not {dev}")
        launches[0] += r["map_launches"]["static"]
        launches[1] += r["map_launches"]["dyn"]
        for b, nw, lw, t, dyn, n in r["map_shapes"]:
            shapes[(b, nw, lw, t, bool(dyn))] += n
    check(out["ue"]["map_launches"]["static"] > 0 and out["enb"]["map_launches"]["static"] > 0,
          f"run_lte_3proc: a PHY process launched no static MAP pass: "
          f"eNB {out['enb']['map_launches']}, UE {out['ue']['map_launches']}")
    check(launches[1] == 0, f"run_lte_3proc: {launches[1]} dynamic-K launches on the per-TTI plane")
    ue, enb, epc = out["ue"], out["enb"], out["epc"]
    print(f"run_lte_3proc: {RUN_LTE['prb']} PRB, {RUN_LTE['duration']} s from the first exchange: "
          f"{enb['ttis']} TTIs; registered at TTI {ue['attached_tti']} ({ue['attached_s']:.3f} s after "
          f"the first exchange); IP DL {ue['ip_rx']} of {epc['dl_sent']} sent, UL {epc['sgi_rx']} of "
          f"{ue['ul_sent']} sent; eNB ul_crc_ok {enb['ul_crc_ok']}; wall {out['wall_s']:.1f} s with start-up")
    print(f"run_lte_3proc: ms per lockstep TTI (host clock, median / mean): eNB {enb['tti_ms']:.3f} / "
          f"{enb['tti_ms_mean']:.3f}, UE {ue['tti_ms']:.3f} / {ue['tti_ms_mean']:.3f}; each process's own "
          f"part (median, after a synchronize): eNB {enb['busy_ms']:.3f}, UE {ue['busy_ms']:.3f}; map "
          f"launches static eNB {enb['map_launches']['static']}, UE {ue['map_launches']['static']}; "
          f"{len(shapes)} launch shapes")
    times = dict(prb=RUN_LTE["prb"], duration_s=RUN_LTE["duration"], ttis=enb["ttis"],
                 attached_tti=ue["attached_tti"], attached_s=ue["attached_s"], ip_dl=ue["ip_rx"],
                 ip_ul=epc["sgi_rx"], dl_sent=epc["dl_sent"], ul_sent=ue["ul_sent"],
                 ul_crc_ok=enb["ul_crc_ok"], wall_s=out["wall_s"],
                 enb_tti_ms=enb["tti_ms"], ue_tti_ms=ue["tti_ms"], enb_tti_ms_mean=enb["tti_ms_mean"],
                 ue_tti_ms_mean=ue["tti_ms_mean"], enb_busy_ms=enb["busy_ms"], ue_busy_ms=ue["busy_ms"],
                 map_launches={r: out[r]["map_launches"] for r in ("enb", "ue")})
    return tuple(launches), times, shapes


DEMO_LINES = {"attached": re.compile(r"\[(\d+) ms\] ATTACHED .*registered in (\d+) TTIs"),
              "dl": re.compile(r"DL ping: (\d+)/(\d+) received"),
              "ul": re.compile(r"UL pong: (\d+)/(\d+) received at SGi"),
              "launches": re.compile(r"map launches: static (\d+), dynamic-K (\d+)")}


def run_lte_demo(prb: int, role_args=(), env=None) -> dict:
    """`run_lte_demo` in a child process with its defaults (4 pings, no
    AWGN) at `prb`, gated on its own prints: attached, every DL ping and UL
    pong through.  Returns the attach TTI, the pings, the MAP launches and
    the wall time."""
    t0 = time.perf_counter()
    c = Child([*port_cmd("run_lte_demo"), "--prb", str(prb), *role_args], env or child_env())
    try:
        rc = c.finish(600)
    finally:
        c.stop()
    wall = time.perf_counter() - t0
    text = "\n".join(c.lines)
    found = {k: p.search(text) for k, p in DEMO_LINES.items()}
    check(rc == 0 and all(found.values()), f"run_lte_demo exited {rc}:\n{c.tail()}")
    (dl_got, dl_n), (ul_got, ul_n) = (tuple(map(int, found[k].groups())) for k in ("dl", "ul"))
    check(dl_got == dl_n and ul_got >= ul_n, f"run_lte_demo: pings {dl_got}/{dl_n}, pongs {ul_got}/{ul_n}")
    return dict(prb=prb, attached_tti=int(found["attached"].group(2)), pings=dl_got, pongs=ul_got,
                map_launches=[int(x) for x in found["launches"].groups()], wall_s=wall, out=c.tail(8))


def phase_run_lte_demo(dev) -> tuple[tuple[int, int], dict]:
    """Phase 33: `run_lte_demo` at 100 PRB on the card."""
    r = run_lte_demo(RUN_LTE["prb"])
    check(r["map_launches"][0] > 0, "run_lte_demo: no static MAP launch")
    print(f"run_lte_demo: {r['prb']} PRB on {dev}: attached at TTI {r['attached_tti']}, DL pings "
          f"{r['pings']}, UL pongs {r['pongs']}; {r['wall_s']:.1f} s wall with start-up; map launches "
          f"static {r['map_launches'][0]}, dynamic-K {r['map_launches'][1]}")
    print("run_lte_demo: " + r["out"].replace("\n", "\nrun_lte_demo: "))
    return tuple(r["map_launches"]), {k: v for k, v in r.items() if k != "out"}


def pcap_pdus(path) -> list[bytes]:
    """The MAC PDUs of a `MacPcap` file."""
    data = Path(path).read_bytes()
    out, i = [], 24
    while i + 16 <= len(data):
        n = int.from_bytes(data[i + 8:i + 12], "little")
        out.append(data[i + 16 + MAC_PCAP_CONTEXT:i + 16 + n])
        i += 16 + n
    return out


def udp_apps_run(role_args=(), env=None, ue_duration: float = UDP_APPS["ue_duration"]) -> dict:
    """`ue_app` (its MAC PDUs into a pcap) and then `enb_app` over UDP at the
    README's cell, gated: at least one SDU, and every SDU of the pcap's
    CRC-passing PDUs the whole of a payload the eNB wrote, as many as the
    UE printed.  The UE's ring holds 64 subframes and drops what it cannot
    take (the system's own behaviour: the eNB sends as fast as it renders)."""
    import tempfile

    from srsran_tpu_torch.stack.mac_pdu import LCID_DTCH, mac_unpack

    U = UDP_APPS
    (port,) = free_ports(1)
    env = env or child_env()
    cfg = [f"--phy.nof_prb={U['prb']}", f"--phy.cell_id={U['cell_id']}"]
    with tempfile.TemporaryDirectory() as tmp:
        pcap = Path(tmp) / "ue_mac.pcap"
        t0 = time.perf_counter()
        ue = Child([*port_cmd("ue_app"), "--port", str(port), "--duration", str(ue_duration), *cfg,
                    "--pcap.enable=true", f"--pcap.filename={pcap}", *role_args], env)
        enb = None
        try:
            check(ue.wait_for("listening", 120), f"ue_app does not listen:\n{ue.tail()}")
            enb = Child([*port_cmd("enb_app"), "--dest", f"127.0.0.1:{port}", "--ttis", str(U["ttis"]),
                         "--payload-period", str(U["payload_period"]), *cfg, *role_args], env)
            rc_enb = enb.finish(600)
            rc_ue = ue.finish(ue_duration + 300)
        finally:
            ue.stop()
            if enb is not None:
                enb.stop()
        wall = time.perf_counter() - t0
        check(rc_enb == 0, f"enb_app exited {rc_enb}:\n{enb.tail()}")
        check(rc_ue == 0, f"ue_app exited {rc_ue}:\n{ue.tail()}")
        sdus = [sdu for pdu in pcap_pdus(pcap) for lcid, sdu in mac_unpack(pdu) if lcid == LCID_DTCH]
    text = "\n".join(ue.lines)
    done = re.search(r"done: (\d+) SDUs, dropped_samples=(\d+)", text)
    launches = re.search(DEMO_LINES["launches"], text)
    check(done is not None and launches is not None, f"ue_app printed no summary:\n{ue.tail()}")
    n_sdu, dropped = int(done.group(1)), int(done.group(2))
    ttis = []
    for sdu in sdus:
        m = UDP_PAYLOAD.fullmatch(sdu)
        check(m is not None, f"ue_app: an SDU that the eNB did not write: {sdu!r}")
        ttis.append(int(m.group(2)))
    check(n_sdu >= 1 and n_sdu == len(sdus), f"ue_app: {n_sdu} SDUs printed, {len(sdus)} in its pcap")
    check(all(t % U["payload_period"] == 0 and t < U["ttis"] for t in ttis),
          f"ue_app: SDUs of TTIs {ttis}, not the eNB's payloads")
    return dict(sdus=n_sdu, sdu_ttis=ttis, dropped_samples=dropped,
                map_launches=[int(x) for x in launches.groups()], wall_s=wall)


def phase_udp_apps(dev) -> tuple[tuple[int, int], dict]:
    """Phase 34: `enb_app` -> `ue_app` over UDP on the card."""
    r = udp_apps_run()
    check(r["map_launches"][0] > 0, "ue_app: no static MAP launch")
    U = UDP_APPS
    print(f"enb_app -> ue_app: {U['prb']} PRB cell {U['cell_id']}, {U['ttis']} TTIs sent, a payload every "
          f"{U['payload_period']}: {r['sdus']} SDUs (TTIs {r['sdu_ttis']}), each a payload the eNB wrote; "
          f"dropped_samples={r['dropped_samples']}; map launches static {r['map_launches'][0]}; "
          f"{r['wall_s']:.1f} s wall with start-up")
    return tuple(r["map_launches"]), r


# phase 37: the example scripts at 100 PRB (`pdsch_enodeb` → cf32 file →
# `cell_search`, `pdsch_ue`, `synch_file`; `bler_sweep` at three SNRs;
# `dynamic_grants`; `windowed_link`), the Wiener estimators on a batch of
# subframes, the resamplers on one 30.72 Msps frame
EXAMPLES = dict(prb=100, mcs=20, frames=4, cell_id=301, bler_mcs=26, bler_snr="12:14:1", bler_batch=128)
# the estimators: a batch of CRS-only subframes through EPA (TS 36.101 B.2,
# one block-fading draw a subframe) and through tests/test_chest.py's
# dispersive channel (taps at 0, 25 and 60 samples of 15.36 Msps), AWGN of
# amplitude 0.05 a component (the test's SNR, 23 dB); the adaptive
# estimator learns over `warm` batches first
CHEST = dict(batch=64, warm=8, amp=0.05, max_mse=0.01, max_mse_adaptive=0.03,
             epa=((0.0, 30e-9, 70e-9, 90e-9, 110e-9, 190e-9, 410e-9),
                  (0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8)),
             dispersive=((0.0, 25 / 15.36e6, 60 / 15.36e6), (1.0, 0.6 * np.exp(1j), 0.4 * np.exp(-2j))))
RESAMPLE_ATOL = 1e-4  # the card against the CPU, on unit-amplitude samples
SF_ATOL = 1e-4  # the estimators' ce, the card against the CPU


def run_main(main, argv) -> tuple[int, str, float]:
    """An example's `main(argv)` in this process: (exit code, its standard
    output, host seconds)."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue(), time.perf_counter() - t0


def examples_run(device, workdir: Path, prb: int = EXAMPLES["prb"], mcs: int = EXAMPLES["mcs"],
                 frames: int = EXAMPLES["frames"], bler_batch: int = EXAMPLES["bler_batch"],
                 bler_snr: str = EXAMPLES["bler_snr"]) -> dict:
    """Phase 37's scripts on `device` (on the card without `--device`, as a
    user runs them): `pdsch_enodeb` and `pdsch_ue` as `python -m` children,
    then `cell_search`, `pdsch_ue`, `synch_file`, `bler_sweep`,
    `dynamic_grants` and `windowed_link` through `main(argv)` in this
    process.  Gates: the cell and its MIB found, every TB of the file
    decoded both ways, a PSS in every half frame, the sweep's BLER falling
    with SNR to none lost at the top, every grant of `dynamic_grants` (but
    one coded above rate 0.93) and of `windowed_link` decoded.  Returns each script's parsed result and
    seconds."""
    from srsran_tpu_torch.examples import (
        bler_sweep, cell_search, dynamic_grants, pdsch_ue, synch_file, windowed_link)
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.phch.pdsch import MOD_QM, pdsch_nof_re
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod

    E = EXAMPLES
    dev_args = [] if torch.device(device).type == "cuda" else ["--device", str(device)]
    path = str(workdir / "dl.cf32")
    out = {}
    for name, argv in (("pdsch_enodeb", ["-o", path, "-p", str(prb), "-m", str(mcs), "-n", str(frames),
                                         "-c", str(E["cell_id"])]),
                       ("pdsch_ue child", ["-i", path, "-p", str(prb)])):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", f"srsran_tpu_torch.examples.{name.split()[0]}", *argv,
                            *dev_args], cwd=ROOT, env=child_env(OMP_NUM_THREADS="1"), capture_output=True,
                           text=True, timeout=300)
        check(p.returncode == 0, f"{name}: exit {p.returncode}: {p.stderr[-2000:]}")
        out[name] = dict(stdout=p.stdout, s=time.perf_counter() - t0)
    sf_len = Cell(nof_prb=prb).sf_len
    check(Path(path).stat().st_size == 8 * 10 * frames * sf_len, "pdsch_enodeb: file size")
    runs = (("cell_search", cell_search.main, ["-i", path, "-p", str(prb)]),
            ("pdsch_ue", pdsch_ue.main, ["-i", path, "-p", str(prb)]),
            ("synch_file", synch_file.main, ["-i", path, "-l", str(5 * sf_len), "-n", str(2 * frames)]),
            ("bler_sweep", bler_sweep.main, ["--prb", str(prb), "--mcs", str(E["bler_mcs"]), "--snr",
                                             bler_snr, "--batch", str(bler_batch)]),
            ("dynamic_grants", dynamic_grants.main, ["--prb", str(prb)]),
            ("windowed_link", windowed_link.main, ["--prb", str(prb)]))
    for name, main, argv in runs:
        rc, text, secs = run_main(main, argv + dev_args)
        check(rc == 0, f"{name}: exit {rc}: {text[-2000:]}")
        out[name] = dict(stdout=text, s=secs)
    txt = {k: v["stdout"] for k, v in out.items()}
    check(f"PCI={E['cell_id']}" in txt["cell_search"] and f"MIB: nof_prb={prb}" in txt["cell_search"],
          f"cell_search: {txt['cell_search']}")
    for name in ("pdsch_ue child", "pdsch_ue"):
        m = re.search(r"total: (\d+)/(\d+) transport blocks", txt[name])
        check(m is not None and m[1] == m[2] == "20", f"{name}: {txt[name][-300:]}")
        out[name]["tbs"] = int(m[1])
    check(f"{2 * frames}/{2 * frames} frames above threshold" in txt["synch_file"], txt["synch_file"][-300:])
    rows = [line.split() for line in txt["bler_sweep"].splitlines() if not line.startswith("#")]
    bler = [float(r[1]) for r in rows]
    check(len(bler) == 3 and bler == sorted(bler, reverse=True) and bler[-1] == 0.0,
          f"bler_sweep: {txt['bler_sweep']}")
    out["bler_sweep"].update(rows=[dict(snr_db=float(r[0]), bler=float(r[1]), ok=r[2], mbps=float(r[3]),
                                        ms=float(r[4])) for r in rows])
    # a grant coded above rate 0.93 (a narrow allocation at the top MCS) has
    # no decodable TB: only those may fail
    cell = Cell(nof_prb=prb, nof_ports=1, id=17)
    lost = [(int(sf), int(mcs), int(a), int(b), int(tbs)) for sf, mcs, a, b, tbs in re.findall(
        r"sf (\d)  mcs +(\d+)  prb \[ *(\d+), *(\d+)\)  tbs +(\d+)  KO", txt["dynamic_grants"])]
    for sf, mcs, a, b, tbs in lost:
        rate = (tbs + 24) / (pdsch_nof_re(cell, sf, 1, tuple(range(a, b))) * MOD_QM[dl_mcs_to_mod(mcs)])
        check(rate > 0.93, f"dynamic_grants lost a TB coded at rate {rate:.3f}: MCS {mcs}, PRB [{a}, {b})")
    m = re.search(r"\n(\d+)/(\d+) grants decoded", txt["dynamic_grants"])
    check(m is not None and int(m[2]) - int(m[1]) == len(lost), f"dynamic_grants: {txt['dynamic_grants'][-300:]}")
    out["dynamic_grants"]["lost_above_rate"] = len(lost)
    m = re.findall(r"(DL|UL): (\d+)/(\d+) TBs", txt["windowed_link"])
    check(len(m) == 2 and all(a == b for _, a, b in m), f"windowed_link: {txt['windowed_link']}")
    return out


def chest_batch(cell, profile: str, rng, sf_idx: int):
    """`CHEST['batch']` CRS-only received grids of `cell` under `profile`
    ("epa": a block-fading draw a subframe; "dispersive": fixed taps, a
    random common phase), AWGN of `CHEST['amp']`: (grids (B, nsymb, nre)
    complex64 numpy, true channel (B, nre))."""
    from srsran_tpu_torch.phy.chest.refsignal_dl import crs_positions, crs_sequence_port

    b, nre = CHEST["batch"], cell.nof_re_per_symbol
    delays, taps = (np.asarray(v) for v in CHEST[profile])
    if profile == "epa":
        taps = (rng.standard_normal((b, len(delays))) + 1j * rng.standard_normal((b, len(delays)))) \
            * np.sqrt(10 ** (taps / 10) / 2)
    else:
        taps = np.exp(2j * np.pi * rng.random((b, 1))) * taps[None]
    phase = np.exp(-2j * np.pi * np.outer((np.arange(nre) - nre // 2) * 15e3, delays))
    h = (taps[:, None, :] * phase[None]).sum(-1)
    h = (h / np.sqrt(np.mean(np.abs(h) ** 2, axis=1, keepdims=True))).astype(np.complex64)
    syms, freqs = crs_positions(cell, 0)
    seq = crs_sequence_port(cell, sf_idx, 0)
    grid = np.zeros((b, cell.nsymb_per_sf, nre), np.complex64)
    for s in range(len(syms)):
        grid[:, syms[s], freqs[s]] = seq[s][None] * h[:, freqs[s]]
    grid += (CHEST["amp"] * (rng.standard_normal(grid.shape) + 1j * rng.standard_normal(grid.shape))
             ).astype(np.complex64)
    return grid, h


def estimators_run(device, nof_prb: int = 100) -> dict:
    """Phase 37's estimators on `device`: per profile, the MSE of
    `chest_dl` "interpolate" and "wiener" and of `chest_dl_adaptive` (after
    `warm` batches) against the true channel, each estimate held to the same
    call on the CPU, and ms per call (host clock after a synchronize).
    Gates, tests/test_chest.py's on its channel: the Wiener estimators below
    "interpolate", the fixed one below 0.01 and the adaptive one below 0.03;
    on EPA both below 0.01."""
    from srsran_tpu_torch.phy.chest.chest_dl import ChestDlConfig, chest_dl
    from srsran_tpu_torch.phy.chest.wiener_dl import chest_dl_adaptive, wiener_init
    from srsran_tpu_torch.phy.common import Cell

    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=301)
    out = {}
    for profile in ("epa", "dispersive"):
        rng = np.random.default_rng(37)
        # the adaptive state learnt on the card and the one learnt on the CPU
        states = [wiener_init(), wiener_init()]
        for sf in range(CHEST["warm"]):
            grid, _ = chest_batch(cell, profile, rng, sf)
            for i, d in enumerate((device, "cpu")):
                _, states[i] = chest_dl_adaptive(torch.from_numpy(grid).to(d), cell, sf, states[i])
        grid, h = chest_batch(cell, profile, rng, 9)
        calls = {"interpolate": lambda x, _st: chest_dl(x, cell, 9, ChestDlConfig()),
                 "wiener": lambda x, _st: chest_dl(x, cell, 9, ChestDlConfig(algorithm="wiener")),
                 "adaptive": lambda x, st: chest_dl_adaptive(x, cell, 9, st)[0]}
        g = torch.from_numpy(grid).to(device)
        row = {}
        for name, fn in calls.items():
            ce = fn(g, states[0])["ce"][:, 0].cpu()
            err = float((ce - fn(torch.from_numpy(grid), states[1])["ce"][:, 0]).abs().max())
            check(bool(torch.isfinite(ce).all()) and err <= SF_ATOL, f"chest {name} {profile}: card vs CPU {err}")
            row[name] = dict(mse=float(np.mean(np.abs(ce.numpy() - h[:, None, :]) ** 2)), card_vs_cpu=err,
                             ms=wall_ms(lambda: fn(g, states[0]), 10) if g.is_cuda else None)
        mse = {k: v["mse"] for k, v in row.items()}
        if profile == "dispersive":
            check(mse["wiener"] < mse["interpolate"] and mse["wiener"] < CHEST["max_mse"]
                  and mse["adaptive"] < mse["interpolate"] and mse["adaptive"] < CHEST["max_mse_adaptive"],
                  f"chest on the dispersive channel: {mse}")
        else:
            check(mse["wiener"] < CHEST["max_mse"] and mse["adaptive"] < CHEST["max_mse"],
                  f"chest on EPA: {mse}")
        out[profile] = row
    return out


def resampling_run(device) -> dict:
    """Phase 37's resamplers on one 30.72 Msps frame (307200 samples, a
    tone mix of unit amplitude) on `device`: `resample_fft` 3/4 (→ 23.04
    Msps), `decimate` by 16 (→ 1.92 Msps) and `resample_arb` at 0.8; each
    held to the same call on the CPU within RESAMPLE_ATOL, with ms per call
    (CUDA events)."""
    from srsran_tpu_torch.phy.resampling import decimate, resample_arb, resample_fft

    n = 307200
    t = np.arange(n) / 30.72e6
    x = sum(a * np.exp(2j * np.pi * f * t) for f, a in ((1e5, 0.5), (-2.3e6, 0.3), (4.1e6, 0.2)))
    x = x.astype(np.complex64)
    xd = torch.from_numpy(x).to(device)
    calls = {"resample_fft 3/4": lambda v: resample_fft(v, 3, 4),
             "decimate 16": lambda v: decimate(v, 16),
             "resample_arb 0.8": lambda v: resample_arb(v, 0.8)}
    out = {}
    for name, fn in calls.items():
        got = fn(xd)
        want = fn(torch.from_numpy(x))
        err = float((got.cpu() - want).abs().max())
        check(got.shape == want.shape and bool(torch.isfinite(got).all()) and err <= RESAMPLE_ATOL,
              f"{name}: card vs CPU {err}")
        out[name] = dict(n_out=got.shape[-1], card_vs_cpu=err,
                         ms=cuda_ms(lambda: fn(xd), 10) if torch.device(device).type == "cuda" else None)
    return out


def phase_examples(dev) -> tuple[tuple[int, int], dict, Counter]:
    """Phase 37: `examples_run`, `estimators_run` and `resampling_run` at
    full width on the card.  Returns ((static, dynamic-K) launches of the
    in-process scripts, the times, their launches by kernel shape)."""
    import tempfile

    from srsran_tpu_torch.phy.fec import turbo_cuda

    before = Counter(turbo_cuda.SHAPES)
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        ex = examples_run(dev, Path(tmp))
    launches = read_launches()
    shapes = Counter(turbo_cuda.SHAPES)
    shapes.subtract(before)
    check(launches[0] > 0 and launches[1] > 0, f"examples: map launches {launches}")
    est = estimators_run(dev)
    res = resampling_run(dev)
    E = EXAMPLES
    for name, v in ex.items():
        last = [line for line in v["stdout"].splitlines() if line.strip()][-1]
        print(f"example {name} ({v['s']:.1f} s): {last}")
    for r in ex["bler_sweep"]["rows"]:
        print(f"example bler_sweep {E['prb']} PRB MCS {E['bler_mcs']} B={E['bler_batch']}: {r['snr_db']} dB "
              f"BLER {r['bler']} ({r['ok']}), {r['mbps']} Mbps, {r['ms']} ms a batch")
    for profile, row in est.items():
        print(f"chest {profile} ({CHEST['batch']} subframes, 100 PRB, AWGN {CHEST['amp']}): "
              + ", ".join(f"{k} MSE {v['mse']:.5f} ({v['ms']:.3f} ms a call, card vs CPU {v['card_vs_cpu']:.2g})"
                          for k, v in row.items()))
    print("resampling, one 30.72 Msps frame: " + ", ".join(
        f"{k} -> {v['n_out']} samples {v['ms']:.3f} ms (card vs CPU {v['card_vs_cpu']:.2g})"
        for k, v in res.items()))
    times = dict(examples={k: {kk: vv for kk, vv in v.items() if kk != "stdout"} for k, v in ex.items()},
                 chest=est, resampling=res, map_launches=list(launches))
    return launches, times, +shapes


# phase 38: more than one device.  A mesh's positions may name one device
# twice, so eight positions of the one card stand in for an eight-card grid
# (each position still runs its block of the work as its own calls); a
# machine with more cards also runs the same paths over distinct cards.
CARRIERS = dict(prb=100, mcs=26, n=8, sf_idx=2, amp=0.02, cell_id=301)
# bench.py `bench_window_carriers`: 8 carriers x 16 TTIs as one W = 128 window
CARRIER_WINDOW = dict(w=128, mcs=(8, 16, 26), amp=0.05, sf_idx=2, positions=8)
HALO = dict(p=2, q=1, halo=64, n=307200, positions=8, fir_taps=17)
GRID_2D = (4, 2)  # __graft_entry__.dryrun_multichip's carriers x subframes mesh
HALO_ATOL = 1e-4  # the sharded resampler against the blockwise one (the reference's bar)
FIR_ATOL = 1e-5  # the sharded FIR against one FIR over the whole stream, unit amplitude


def carriers_tx(cell, grant, n: int, sf_idx: int, rng, amp: float):
    """n carriers' subframes of one grant, each with a TB and noise of its own:
    (samples (n, 1, sf_len) complex64 numpy, TBs (n, tbs) uint8)."""
    from srsran_tpu_torch.phy.ofdm import OfdmConfig

    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    tbs = np.stack([rng.integers(0, 2, grant.tbs).astype(np.uint8) for _ in range(n)])
    return np.stack([render(cell, ofdm, sf_idx, grant, tb, rng, amp) for tb in tbs]), tbs


def grid_step(mesh, cell, sf_idx: int, cfi: int, grant, x: torch.Tensor):
    """The 2-D (carriers x subframes) step of `__graft_entry__.dryrun_multichip`
    on the port: position (c, s) of `mesh` decodes x[c, s] (nrx, sf_len) on its
    own device through `ue_dl_subframe`; the TBs and verdicts come back in grid
    order and their sum to the first position's device.  Returns (tb (C, S,
    tbs), ok (C, S), total_ok ())."""
    from srsran_tpu_torch.pipeline import ue_dl_subframe

    devs = mesh.devices
    fns = {d: ue_dl_subframe(cell, sf_idx, cfi, grant, device=d) for d in dict.fromkeys(devs.reshape(-1))}
    home = devs.reshape(-1)[0]
    outs = [[fns[devs[c, s]](x[c, s][None].to(devs[c, s])) for s in range(devs.shape[1])]
            for c in range(devs.shape[0])]
    tb = torch.stack([torch.cat([o[0].to(home) for o in row]) for row in outs])
    ok = torch.stack([torch.cat([o[1].to(home) for o in row]) for row in outs])
    return tb, ok, ok.sum(dtype=torch.int32)


def phase_carriers(dev):
    """Phase 38: `multi_carrier_ue_dl` over 1 and 8 positions, the sharded
    `WindowedUeDl` window, the halo resampler and FIR, the 2-D step.  Returns
    ({path: (static, dynamic-K) launches}, times, static launch shapes)."""
    from srsran_tpu_torch.parallel import carrier_mesh, sharded_fir, sharded_resample_fft
    from srsran_tpu_torch.parallel.mesh import Mesh, NamedSharding, PartitionSpec
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.fec import turbo_cuda
    from srsran_tpu_torch.phy.ofdm import OfdmConfig
    from srsran_tpu_torch.phy.phch.pdsch import DlGrant
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu_torch.phy.resampling import resample_fft_blocks
    from srsran_tpu_torch.pipeline import multi_carrier_ue_dl
    from srsran_tpu_torch.pipeline_window import WindowedUeDl

    C = CARRIERS
    before = Counter(turbo_cuda.SHAPES)
    cell = Cell(nof_prb=C["prb"], nof_ports=1, id=C["cell_id"])
    grant = DlGrant(prb=tuple(range(C["prb"])), mod=dl_mcs_to_mod(C["mcs"]), tbs=dl_tbs(C["mcs"], C["prb"]),
                    rnti=0x46)
    rng = np.random.default_rng(38)
    x_np, sent = carriers_tx(cell, grant, C["n"], C["sf_idx"], rng, C["amp"])
    x = torch.from_numpy(x_np).to(dev)
    launches, times = {}, {}

    # multi_carrier_ue_dl: the one card as one position, and as eight
    check(carrier_mesh().size == torch.cuda.device_count(), "carrier_mesh() does not span the cards")
    tbs_by = {}
    for tag, mesh in (("1 position", carrier_mesh(devices=[dev])),
                      ("8 positions of the card", carrier_mesh(devices=[dev] * C["n"]))):
        fn = multi_carrier_ue_dl(cell, C["sf_idx"], 1, grant, mesh=mesh)
        reset_launches()
        tb, ok, total = fn(x)
        launches[f"multi_carrier_ue_dl, {tag}"] = read_launches()
        check(int(total) == C["n"] and total.device == dev and tb.device == dev,
              f"multi_carrier_ue_dl {tag}: total_ok {int(total)}")
        check(bool((tb.cpu().numpy() == sent).all()), f"multi_carrier_ue_dl {tag}: a TB differs from the sent one")
        check(launches[f"multi_carrier_ue_dl, {tag}"][0] > 0, f"multi_carrier_ue_dl {tag}: no MAP launch")
        tbs_by[tag] = tb
        ms = batch_ms(lambda: fn(x))
        times[f"multi_carrier {tag}"] = dict(ms_per_call=ms, carriers_per_card=C["n"] / ms,
                                             map_launches=list(launches[f"multi_carrier_ue_dl, {tag}"]))
        print(f"carriers: multi_carrier_ue_dl {C['n']} carriers of {C['prb']} PRB MCS {C['mcs']} "
              f"(tbs {grant.tbs}) over {tag}: total_ok {int(total)}, every TB the sent one; "
              f"{ms:.3f} ms per call by CUDA events -> {C['n'] / ms:.2f} carriers per card in real time")
    check(torch.equal(*tbs_by.values()), "multi_carrier_ue_dl: 1 and 8 positions give different TBs")
    # the weak-scaling curve of tests/test_scaling.py (reported, not gated)
    curve = {}
    for n in (1, 2, 4, 8):
        fn = multi_carrier_ue_dl(cell, C["sf_idx"], 1, grant, mesh=carrier_mesh(devices=[dev] * n))
        curve[n] = n * grant.tbs / batch_ms(lambda: fn(x[:n])) / 1e3
    times["weak_scaling_mbps"] = curve
    print("carriers: weak scaling over positions of the one card, Mbps: "
          + ", ".join(f"{n}: {v:.1f}" for n, v in curve.items()))
    if torch.cuda.device_count() > 1 and C["n"] % torch.cuda.device_count() == 0:
        mesh = carrier_mesh()
        fn = multi_carrier_ue_dl(cell, C["sf_idx"], 1, grant, mesh=mesh)
        reset_launches()
        tb, ok, total = fn(x)
        launches["multi_carrier_ue_dl, distinct cards"] = read_launches()
        check(int(total) == C["n"] and torch.equal(tb, tbs_by["1 position"]),
              "multi_carrier_ue_dl over distinct cards differs")
        ms = batch_ms(lambda: fn(x))
        times["multi_carrier distinct cards"] = dict(cards=mesh.size, ms_per_call=ms)
        print(f"carriers: over {mesh.size} distinct cards: {ms:.3f} ms per call")
    else:
        print(f"carriers: distinct cards skipped ({torch.cuda.device_count()} card on this machine)")

    # the sharded window at bench.py's shape: bit for bit the unsharded one
    CW = CARRIER_WINDOW
    w, sfs = CW["w"], [CW["sf_idx"]] * CW["w"]
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    sharding = NamedSharding(carrier_mesh(devices=[dev] * CW["positions"]), PartitionSpec("carriers"))
    ue = WindowedUeDl(cell, cfi=1, w=w, max_iterations=5)
    dyn = [0, 0]
    for mcs in CW["mcs"]:
        g = DlGrant(prb=tuple(range(C["prb"])), mod=dl_mcs_to_mod(mcs), tbs=dl_tbs(mcs, C["prb"]), rnti=0x46)
        tb_sent = rng.integers(0, 2, g.tbs).astype(np.uint8)
        tx = render(cell, ofdm, CW["sf_idx"], g, tb_sent, rng, 0.0)
        s = awgn(rng, np.tile(tx[None], (w, 1, 1)), CW["amp"])
        reset_launches()
        p = ue.dispatch_window(s, sfs, [g] * w, sharding=sharding)
        res = ue.results(p)
        got = read_launches()
        dyn = [a + b for a, b in zip(dyn, got)]
        p_plain = ue.dispatch_window(s, sfs, [g] * w)
        check(torch.equal(p.packed, p_plain.packed) and torch.equal(p.softbuffer, p_plain.softbuffer),
              f"carrier window MCS {mcs}: the sharded window is not bit for bit the unsharded one")
        note_shape(f"carrier window MCS {mcs}", p.pack)
        n_ok = sum(ok for _tb, ok, _n in res)
        check(n_ok >= w * 3 // 4 and all((tb == tb_sent).all() for tb, ok, _n in res if ok),
              f"carrier window MCS {mcs}: {n_ok}/{w} pass CRC")
        check(got[1] > 0 and got[0] == 0, f"carrier window MCS {mcs}: map launches {got}")
        ms_sh = batch_ms(lambda: ue.results(ue.dispatch_window(s, sfs, [g] * w, sharding=sharding)))
        ms_plain = batch_ms(lambda: ue.results(ue.dispatch_window(s, sfs, [g] * w)))
        times[f"carrier window MCS {mcs}"] = dict(w=w, crc_ok=n_ok, ms_per_window_sharded=ms_sh,
                                                  ms_per_window_unsharded=ms_plain,
                                                  carriers_per_card_sharded=w / ms_sh,
                                                  map_launches=list(got))
        print(f"carriers: WindowedUeDl W={w} (8 carriers x 16 TTIs) MCS {mcs} tbs {g.tbs}, noise "
              f"{CW['amp']}: crc_ok {n_ok}/{w}, sharded over {CW['positions']} positions bit for bit the "
              f"unsharded window (packed results and softbuffer); {ms_sh:.3f} ms per window sharded, "
              f"{ms_plain:.3f} ms unsharded (CUDA events) -> {w / ms_sh:.1f} carriers per card")
    launches["WindowedUeDl sharded"] = tuple(dyn)
    del ue

    # the sample axis: the halo resampler and FIR over 8 positions
    H = HALO
    t = np.arange(H["n"]) / 30.72e6
    xs = sum(a * np.exp(2j * np.pi * f * t) for f, a in ((1e5, 0.5), (-2.3e6, 0.3), (4.1e6, 0.2)))
    xs = torch.from_numpy(xs.astype(np.complex64)).to(dev)
    mesh_s = carrier_mesh(1, samples=H["positions"], devices=[dev] * H["positions"])
    y = sharded_resample_fft(xs, H["p"], H["q"], mesh_s, halo=H["halo"])
    y_blk = resample_fft_blocks(xs.reshape(H["positions"], -1), H["p"], H["q"], halo=H["halo"]).reshape(-1)
    err = float((y - y_blk).abs().max())
    check(y.shape == y_blk.shape and err <= HALO_ATOL, f"sharded_resample_fft vs blockwise: {err}")
    ms_res = batch_ms(lambda: sharded_resample_fft(xs, H["p"], H["q"], mesh_s, halo=H["halo"]))
    taps = np.hamming(H["fir_taps"]).astype(np.float32)
    taps /= taps.sum()
    y8 = sharded_fir(xs, taps, mesh_s)
    y1 = sharded_fir(xs, taps, carrier_mesh(1, samples=1, devices=[dev]))
    ref = np.convolve(np.concatenate([np.zeros(len(taps) - 1, np.complex64), xs.cpu().numpy()]), taps, "valid")
    err_fir = float((y8 - y1).abs().max())
    err_np = float(np.abs(y8.cpu().numpy() - ref).max())
    check(err_fir <= FIR_ATOL and err_np <= HALO_ATOL, f"sharded_fir: {err_fir} against one FIR, {err_np} numpy")
    ms_fir = batch_ms(lambda: sharded_fir(xs, taps, mesh_s))
    times["halo"] = dict(resample_ms=ms_res, resample_vs_blocks=err, fir_ms=ms_fir, fir_vs_whole=err_fir)
    print(f"carriers: sharded_resample_fft {H['p']}/{H['q']} halo {H['halo']} on one 30.72 Msps frame over "
          f"{H['positions']} positions: {err:.3g} from resample_fft_blocks, {ms_res:.3f} ms; sharded_fir "
          f"({H['fir_taps']} taps): {err_fir:.3g} from one FIR over the stream, {ms_fir:.3f} ms")

    # the 2-D (carriers x subframes) step at 100 PRB
    nc, ns = GRID_2D
    grid = np.empty(nc * ns, dtype=object)
    grid[:] = [dev] * (nc * ns)
    mesh2d = Mesh(grid.reshape(nc, ns), ("carriers", "subframes"))
    x2 = x.reshape(nc, ns, *x.shape[1:])
    reset_launches()
    tb2, ok2, total2 = grid_step(mesh2d, cell, C["sf_idx"], 1, grant, x2)
    launches["2-D carriers x subframes step"] = read_launches()
    check(int(total2) == nc * ns and bool((tb2.reshape(C["n"], -1).cpu().numpy() == sent).all()),
          f"2-D step: total_ok {int(total2)}")
    ms2 = batch_ms(lambda: grid_step(mesh2d, cell, C["sf_idx"], 1, grant, x2))
    times["2-D step"] = dict(ms_per_step=ms2, positions=nc * ns)
    print(f"carriers: 2-D ({nc} carriers x {ns} subframes) step at {C['prb']} PRB: total_ok {int(total2)}, "
          f"{ms2:.3f} ms per step")
    shapes = Counter(turbo_cuda.SHAPES)
    shapes.subtract(before)
    return launches, times, +shapes


# phase 39: eMBMS at 20 MHz, extended CP, the control region of 2 symbols.
# MCS 28's own TBS (75376) exceeds the 61200 coded bits of the MBSFN region,
# so that row takes the TBS of 0.75 x N_PRB, the rule of the shortened DwPTS
# subframe (55056 bits, code rate 0.9)
EMBMS = dict(prb=100, region=2, sf_idx=1, area_id=11, amp=0.01, rows=((9, False), (28, True)))


def phase_embms(dev):
    """Phase 39: PMCH in a mixed-CP MBSFN subframe through
    `ofdm_tx_sf_mbsfn` → AWGN → `ofdm_rx_sf_mbsfn` → `pmch_decode`.
    Returns ((static, dynamic-K) launches, times, static shapes)."""
    from srsran_tpu_torch.phy.common import CP, Cell, cp_len_norm
    from srsran_tpu_torch.phy.fec import turbo_cuda
    from srsran_tpu_torch.phy.ofdm import OfdmConfig, mbsfn_guard_len, ofdm_rx_sf_mbsfn, ofdm_tx_sf_mbsfn
    from srsran_tpu_torch.phy.phch.pmch import pmch_decode, pmch_encode_np
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs

    E = EMBMS
    before = Counter(turbo_cuda.SHAPES)
    cell = Cell(nof_prb=E["prb"], nof_ports=1, id=301, cp=CP.EXT)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    n = ofdm.symbol_sz
    g0 = 2 * n + cp_len_norm(0, n) + cp_len_norm(1, n)
    glen = mbsfn_guard_len(E["region"], n)
    rng = np.random.default_rng(39)
    gen = torch.Generator(device=dev).manual_seed(39)
    total, times = [0, 0], {}
    for mcs, short in E["rows"]:
        mod, tbs = dl_mcs_to_mod(mcs), dl_tbs(mcs, E["prb"], dwpts=short)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        grid = pmch_encode_np(cell, E["sf_idx"], E["area_id"], mod, tbs, tb)
        grid[:2] = ((rng.integers(0, 2, (2, grid.shape[1])) * 2 - 1) / np.sqrt(2)).astype(np.complex64)
        tx = ofdm_tx_sf_mbsfn(ofdm, torch.from_numpy(grid).to(dev), E["region"])
        check(bool((tx[g0 : g0 + glen] == 0).all()) and bool((tx[g0 - 1] != 0) & (tx[g0 + glen] != 0)),
              f"PMCH MCS {mcs}: the guard is not exactly the zero gap")
        noise = torch.complex(torch.randn(tx.shape, generator=gen, device=dev),
                              torch.randn(tx.shape, generator=gen, device=dev))
        rx = tx + E["amp"] * noise

        def decode():
            return pmch_decode(ofdm_rx_sf_mbsfn(ofdm, rx, E["region"]), cell, E["sf_idx"], E["area_id"],
                               mod, tbs)

        reset_launches()
        tb_hat, ok = decode()
        got = read_launches()
        check(ok and bool((tb_hat.cpu().numpy() == tb).all()), f"PMCH MCS {mcs}: TB not decoded")
        check(got[0] > 0 and got[1] == 0, f"PMCH MCS {mcs}: map launches {got}")
        total = [a + b for a, b in zip(total, got)]
        ms = batch_ms(decode)
        times[f"PMCH MCS {mcs}"] = dict(tbs=tbs, ms_per_subframe=ms, map_launches=list(got))
        print(f"embms: PMCH MCS {mcs} ({mod.name}, tbs {tbs}) in a {E['prb']} PRB MBSFN subframe, "
              f"{E['region']} normal-CP symbols + {glen}-sample zero guard + extended CP, AWGN {E['amp']}: "
              f"CRC ok, the sent TB; {ms:.3f} ms per subframe (demod + decode, CUDA events), "
              f"{got[0]} MAP launches")
    shapes = Counter(turbo_cuda.SHAPES)
    shapes.subtract(before)
    return tuple(total), times, +shapes


# phase 40: NB-IoT, the anchor carrier at 1.92 Msps
NBIOT = dict(cell=257, cfo=0.02, offset=777, amp=0.02, frames=4,
             scan=((2500, 11, 0.01, 100), (2502, None, 0, 0), (2504, 200, -0.015, 5000),
                   (2506, None, 0, 0), (2508, 404, 0.005, 12345), (2510, None, 0, 0),
                   (2512, 503, -0.02, 17), (2514, None, 0, 0)))


def nbiot_capture(ncell: int, rng, cfo: float, offset: int, amp: float, frames: int = 4, mib=None):
    """Raw 1.92 Msps samples of `frames` anchor frames of cell `ncell` behind
    a timing offset, CFO (subcarriers), a phase and AWGN; numpy."""
    from srsran_tpu_torch.examples.cell_search_nbiot import anchor_frame
    from srsran_tpu_torch.phy.phch.npbch import MibNb
    from srsran_tpu_torch.phy.ue.ue_sync_nbiot import FFT, nbiot_modulate_np

    tx = nbiot_modulate_np(np.tile(anchor_frame(ncell, mib or MibNb(sfn_msb=5, op_mode=2)), (frames, 1, 1)))
    n = np.arange(len(tx))
    rx = np.concatenate([np.zeros(offset, np.complex64),
                         tx * np.exp(2j * np.pi * cfo * n / FFT) * np.exp(0.7j) * 0.8])
    return (rx + amp * (rng.standard_normal(len(rx)) + 1j * rng.standard_normal(len(rx)))).astype(np.complex64)


def phase_nbiot(dev):
    """Phase 40: raw acquisition, the EARFCN scan, NPDCCH → NPDSCH, NPRACH,
    the two example scripts.  Returns times (no MAP kernel on this path: the
    tail-biting Viterbi)."""
    from srsran_tpu_torch.examples import cell_search_nbiot, npdsch_ue
    from srsran_tpu_torch.phy.phch.npbch import MibNb
    from srsran_tpu_torch.phy.phch.nprach import nprach_detect, nprach_generate_np
    from srsran_tpu_torch.phy.ue.ue_nbiot import nbiot_ue_rx_data
    from srsran_tpu_torch.phy.ue.ue_sync_nbiot import SF_LEN, nbiot_acquire_raw, nbiot_cell_search_scan

    N = NBIOT
    rng = np.random.default_rng(40)
    mib = MibNb(sfn_msb=5, op_mode=2)
    rx = nbiot_capture(N["cell"], rng, N["cfo"], N["offset"], N["amp"], N["frames"], mib)
    reset_launches()
    res = nbiot_acquire_raw(rx)
    check(read_launches() == (0, 0), "NB-IoT launched the MAP kernel")
    check(res is not None and res.cell.n_id_ncell == N["cell"] and res.cell.mib == mib,
          "NB-IoT raw acquisition failed")
    check(abs(res.cfo - N["cfo"]) < 0.005 and res.timing % (10 * SF_LEN) == N["offset"] % (10 * SF_LEN),
          f"NB-IoT raw acquisition: cfo {res.cfo}, timing {res.timing}")
    check(res.grids.device == dev, "NB-IoT grids are not on the card")
    times = {"acquire_raw_ms": wall_ms(lambda: nbiot_acquire_raw(rx), 3)}
    caps, want = {}, []
    for earfcn, ncell, cfo, offset in N["scan"]:
        if ncell is None:
            caps[earfcn] = (0.1 * (rng.standard_normal(len(rx)) + 1j * rng.standard_normal(len(rx)))
                            ).astype(np.complex64)
        else:
            caps[earfcn] = nbiot_capture(ncell, rng, cfo, offset, N["amp"])[: len(rx)]
            want.append((earfcn, ncell))
    found = nbiot_cell_search_scan(caps)
    check([(e, r.cell.n_id_ncell) for e, r in found] == want, f"NB-IoT scan found {found}")
    times["scan_8_earfcn_ms"] = wall_ms(lambda: nbiot_cell_search_scan(caps), 1)
    # NPDCCH -> NPDSCH on the acquired grids of the npdsch_ue stream
    raw, rnti, tb = npdsch_ue.selftest_stream(np.random.default_rng(11))
    acq = nbiot_acquire_raw(raw)
    check(acq is not None, "NB-IoT: the NPDSCH stream was not acquired")
    dci, tb_hat, ok = nbiot_ue_rx_data(acq.grids[1], acq.grids[2:4], acq.cell, rnti, 1, 2)
    check(dci is not None and ok and np.array_equal(tb_hat, tb), "NB-IoT NPDCCH -> NPDSCH failed")
    times["npdcch_npdsch_ms"] = wall_ms(
        lambda: nbiot_ue_rx_data(acq.grids[1], acq.grids[2:4], acq.cell, rnti, 1, 2), 5)
    for n_init in (0, 5, 11):
        p = nprach_generate_np(n_init)
        prx = (p * np.complex64(0.7) + 0.1 * (rng.standard_normal(len(p)) + 1j * rng.standard_normal(len(p)))
               ).astype(np.complex64)
        metric, det, _delay = nprach_detect(prx)
        check(bool(det[n_init]) and int(torch.argmax(metric)) == n_init, f"NPRACH {n_init} not detected")
    _m, det, _d = nprach_detect((0.1 * (rng.standard_normal(5376) + 1j * rng.standard_normal(5376))
                                 ).astype(np.complex64))
    check(not bool(det.any()), "NPRACH detected a preamble in noise")
    times["nprach_detect_ms"] = wall_ms(lambda: nprach_detect(prx), 10)
    for name, mod in (("cell_search_nbiot", cell_search_nbiot), ("npdsch_ue", npdsch_ue)):
        rc, out, s = run_main(mod.main, ["--selftest"])
        check(rc == 0 and "selftest:" in out and "FAILED" not in out, f"example {name}: rc {rc}\n{out}")
        times[f"example {name} s"] = s
        print(f"nbiot: example {name} --selftest ({s:.2f} s): {out.strip().splitlines()[-1]}")
    print(f"nbiot: raw acquisition of a {N['frames'] * 10} ms capture (cell {N['cell']}, CFO {N['cfo']} "
          f"subcarriers, offset {N['offset']}): cell, MIB-NB, CFO {res.cfo:+.4f}, timing {res.timing}; "
          f"{times['acquire_raw_ms']:.2f} ms; scan of 8 EARFCNs ({len(want)} cells): "
          f"{times['scan_8_earfcn_ms']:.2f} ms; NPDCCH -> NPDSCH {times['npdcch_npdsch_ms']:.2f} ms; "
          f"nprach_detect {times['nprach_detect_ms']:.3f} ms (host clock, synchronised)")
    return times


# phase 41: sidelink.  Each stored capture through examples/pssch_ue.py with
# the (SCIs, TBs) that the reference script gives on it (the TM2 captures:
# the reference script stops at its MIB print, the port's goes on; the data
# there waits for a later subframe, as test_sidelink_full_chain_golden has it)
PSSCH_UE_CAPTURES = (
    ("signal_sidelink_ideal_tm2_p6_c0_s1.92e6.dat", "-p 6 --tm2", (1, 0)),
    ("signal_sidelink_ideal_tm2_p15_c84_s3.84e6.dat", "-p 15 --tm2", (1, 0)),
    ("signal_sidelink_ideal_tm2_p25_c168_s7.68e6.dat", "-p 25 --tm2", (1, 0)),
    ("signal_sidelink_ideal_tm2_p50_c252_s15.36e6.dat", "-p 50 --tm2", (1, 0)),
    ("signal_sidelink_ideal_tm2_p100_c335_s30.72e6.dat", "-p 100 --tm2", (1, 0)),
    ("signal_sidelink_ideal_tm2_p50_c252_s15.36e6_ext.dat", "-p 50 --tm2", (0, 0)),
    ("signal_sidelink_ideal_tm4_p100_c335_size10_num10_cshift0_s30.72e6.dat",
     "-p 100 --size-sub-channel 10", (1, 0)),
    ("signal_sidelink_cmw500_f5.92e9_s11.52e6_50prb_slss_id169.dat", "-p 50 --nonstandard-rates", (0, 0)),
    ("signal_sidelink_cmw500_f5.92e9_s11.52e6_50prb_0offset_1ms.dat",
     "-p 50 --nonstandard-rates --num-sub-channel 5 --size-sub-channel 10", (1, 1)),
    ("signal_sidelink_huawei_s11.52e6_50prb_10prb_offset_with_retx.dat",
     "-p 50 --nonstandard-rates --num-sub-channel 5 --size-sub-channel 10", (2, 0)),
    ("signal_sidelink_qc9150_f5.92e9_s15.36e6_50prb_20offset.dat",
     "-p 50 --num-sub-channel 5 --size-sub-channel 10", (1, 0)),
    ("signal_sidelink_uxm_s15.36e6_50prb_0prb_offset_mcs12.dat", "-p 50", (2, 2)),
    ("signal_sidelink_uxm_s15.36e6_50prb_0prb_offset_mcs28_padding_5ms.dat", "-p 50", (5, 0)),
    ("signal_sidelink_uxm_s23.04e6_100prb_1prb_offset_mcs12_padding.dat",
     "-p 100 --nonstandard-rates --size-sub-channel 10", (4, 4)),
    ("signal_sidelink_uxm_s30.72e6_100prb_1prb_offset_mcs12_its.dat", "-p 100 --size-sub-channel 10", (1, 0)),
)
SIDELINK_SEEDED = dict(prb=100, mcs=20, n_x_id=1234, sf_idx=4, amp=0.02)


def phase_sidelink(dev):
    """Phase 41: `pssch_ue` on every stored capture, the 100 PRB TM2 chain,
    the four subframes of the 100 PRB UXM capture, a seeded PSSCH at 100 PRB.
    Returns ((static, dynamic-K) launches, times, static shapes)."""
    from srsran_tpu_torch.examples import pssch_ue
    from srsran_tpu_torch.phy.common import Cell
    from srsran_tpu_torch.phy.fec import turbo_cuda
    from srsran_tpu_torch.phy.ofdm import OfdmConfig, ofdm_rx_sf, ofdm_tx_sf
    from srsran_tpu_torch.phy.phch.pscch import pscch_decode, pscch_search_tm34
    from srsran_tpu_torch.phy.phch.pssch import pssch_decode, pssch_decode_tm34, put_pssch_np
    from srsran_tpu_torch.phy.phch.ra import riv_decode, tbs_lookup, ul_mcs_to_itbs

    before = Counter(turbo_cuda.SHAPES)
    times, total = {}, [0, 0]

    def grids(name, cell, n_sf):
        x = torch.from_numpy(np.fromfile(VECTORS / name, np.complex64)).to(dev)
        ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)
        return ofdm_rx_sf(ofdm, x[: n_sf * cell.sf_len].reshape(n_sf, cell.sf_len))

    reset_launches()
    for name, args, want in PSSCH_UE_CAPTURES:
        rc, out, s = run_main(pssch_ue.main, ["-i", str(VECTORS / name)] + args.split())
        res = json.loads(out.strip().splitlines()[-1])
        check((res["scis"], res["tbs"]) == want and rc == (0 if want[0] else 1),
              f"pssch_ue {name}: rc {rc}, {res}, expected {want}")
        times[f"pssch_ue {name}"] = dict(s=s, ms_per_subframe=s * 1e3 / res["subframes"], **res)
        print(f"sidelink: pssch_ue {name} {args}: {res['scis']} SCIs, {res['tbs']} TBs in {res['subframes']} "
              f"subframes, {s:.2f} s ({s * 1e3 / res['subframes']:.1f} ms per subframe, host clock)")
    got = read_launches()
    total = [a + b for a, b in zip(total, got)]
    check(got[0] > 0, "pssch_ue launched no MAP kernel")

    # the TM2 full chain on the 100 PRB capture: SCI-0 in sf 1, its TB in sf 3
    cell = Cell(nof_prb=100, nof_ports=1, id=0)
    g = grids("signal_sidelink_ideal_tm2_p100_c335_s30.72e6.dat", cell, 4)

    def tm2_chain():
        sci, ok = pscch_decode(g[1], cell, prb_idx=0)
        rb0, l_crb = riv_decode(100, sci.riv)
        return ok, pssch_decode(g[3], cell, sci.n_sa_id, sci.mcs_idx, rb0, l_crb, sf_idx=0, rv=0)

    reset_launches()
    ok_sci, (tb, ok) = tm2_chain()
    got = read_launches()
    total = [a + b for a, b in zip(total, got)]
    check(ok_sci and ok and np.packbits(tb.cpu().numpy()).tobytes() == bytes.fromhex("c8e4"),
          "sidelink TM2 chain: the TB is not c8e4")
    times["tm2_chain_ms"] = wall_ms(tm2_chain, 5)

    # the 100 PRB UXM capture at 23.04 Msps: 4 SCIs, 4 TBs of 9528 bits
    cell_u = Cell(nof_prb=100, nof_ports=1, id=0, use_standard_rates=False)
    gu = grids("signal_sidelink_uxm_s23.04e6_100prb_1prb_offset_mcs12_padding.dat", cell_u, 4)

    def uxm_subframe(sf):
        hits = pscch_search_tm34(gu[sf], cell_u, [0], 10)
        if not hits:
            return None, None, (torch.zeros(0), False)
        _p, _cs, sci, crc = hits[-1]
        n_x_id = int("".join(map(str, crc)), 2)
        return sci, n_x_id, pssch_decode_tm34(gu[sf], cell_u, n_x_id, sci.mcs_idx, 2, 48, sf_idx=sf, rv=0)

    reset_launches()
    for sf in range(4):
        sci, n_x_id, (tb, ok) = uxm_subframe(sf)
        check(sci is not None and sci.mcs_idx == 12 and sci.riv == 40 and n_x_id == 28300,
              f"UXM 100 PRB sf {sf}: SCI {sci}, N_x_id {n_x_id}")
        check(ok and len(tb) == 9528, f"UXM 100 PRB sf {sf}: TB not decoded")
    got = read_launches()
    total = [a + b for a, b in zip(total, got)]
    times["uxm_100prb_ms_per_subframe"] = wall_ms(lambda: uxm_subframe(1), 5)

    # a seeded PSSCH at 100 PRB, the widest valid allocation, MCS 20
    S = SIDELINK_SEEDED
    rng = np.random.default_rng(41)
    tbs = tbs_lookup(ul_mcs_to_itbs(S["mcs"]), S["prb"])
    tb_sent = rng.integers(0, 2, tbs).astype(np.uint8)
    grid = np.zeros((cell.nsymb_per_sf, cell.nof_re_per_symbol), np.complex64)
    put_pssch_np(grid, cell, tb_sent, S["n_x_id"], S["mcs"], 0, S["prb"], S["sf_idx"])
    tx = ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=0.5), torch.from_numpy(grid).to(dev))
    gen = torch.Generator(device=dev).manual_seed(41)
    rx = tx + S["amp"] * torch.complex(torch.randn(tx.shape, generator=gen, device=dev),
                                       torch.randn(tx.shape, generator=gen, device=dev))
    ofdm_rx = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)

    def seeded():
        return pssch_decode(ofdm_rx_sf(ofdm_rx, rx), cell, S["n_x_id"], S["mcs"], 0, S["prb"], S["sf_idx"])

    reset_launches()
    tb, ok = seeded()
    got = read_launches()
    total = [a + b for a, b in zip(total, got)]
    check(ok and bool((tb.cpu().numpy() == tb_sent).all()), "seeded PSSCH at 100 PRB not decoded")
    times["seeded_pssch_ms"] = batch_ms(seeded)
    print(f"sidelink: TM2 chain on the 100 PRB capture (SCI sf 1 -> TB sf 3, c8e4): {times['tm2_chain_ms']:.2f} ms; "
          f"UXM 100 PRB 23.04 Msps: 4 SCIs, 4 TBs of 9528 bits, {times['uxm_100prb_ms_per_subframe']:.2f} ms "
          f"per subframe (host clock); seeded PSSCH {S['prb']} PRB MCS {S['mcs']} (tbs {tbs}): ok, "
          f"{times['seeded_pssch_ms']:.3f} ms per subframe (CUDA events)")
    check(total[1] == 0, "sidelink launched the dynamic-K mode")
    shapes = Counter(turbo_cuda.SHAPES)
    shapes.subtract(before)
    return tuple(total), times, +shapes


# phase 42: NR — the DM-RS on the card, the coreless NR link over VNF, the
# TTCN-3 system interface.  The widths are 10, 20 and 50 MHz at the module's
# 15 kHz numerology (270 PRB its widest).
DMRS = dict(widths=(52, 106, 270), durations=(14, 12, 9), ttis=20, batch=64, n_id=77, n_scid=1,
            h=0.8 - 0.6j, amp=0.05)
DMRS_GET_ATOL = 1e-6  # get_sf on the card against the same call on the CPU
DMRS_FLAT_ATOL = 1e-5  # a flat channel h comes back as h (the reference test's bar)
NR_LINK = dict(cell_id=7, n_sdus=50, sdu_bytes=300, seed=42, max_connect=100, max_ttis=600)
TTCN3 = dict(pci=7, nof_prb=100, preamble=17, crnti=0x46)


def dmrs_configs(nof_prb: int, durations=DMRS["durations"]) -> list:
    """Every valid type A `DmrsPdschConfig` at these durations: both
    configuration types, single and double symbol, additional positions 0-3,
    dmrs-TypeA-Position 2 and 3."""
    from srsran_tpu_torch.phy.phch.dmrs_nr import DmrsPdschConfig, symbols_idx

    out = []
    for duration in durations:
        for typ in (1, 2):
            for length in (1, 2):
                for additional_pos in range(4):
                    for typea_pos in (2, 3):
                        cfg = DmrsPdschConfig(nof_prb=nof_prb, typeA_pos=typea_pos,
                                              additional_pos=additional_pos, length=length,
                                              duration=duration, type=typ, n_id=DMRS["n_id"],
                                              n_scid=DMRS["n_scid"])
                        try:
                            symbols_idx(cfg)
                        except ValueError:
                            continue
                        out.append(cfg)
    return out


def crandn(shape, gen: torch.Generator, device) -> torch.Tensor:
    return torch.complex(torch.randn(shape, generator=gen, device=device),
                         torch.randn(shape, generator=gen, device=device))


def dmrs_run(device, widths=DMRS["widths"], batch: int = DMRS["batch"], ttis: int = DMRS["ttis"],
             timed: bool = True) -> dict:
    """`put_sf` and `get_sf` for every valid configuration over subframes
    0..ttis-1 on batches of seeded grids (batch, 14, 12·nof_prb) on `device`.
    Each call is held to the same call on CPU tensors: `put_sf` bit for bit
    on one grid of the batch (a different one each call), and every grid of
    the batch carrying that grid's pilots over the rest of its own seeded
    grid; `get_sf` of h·grid + noise within DMRS_GET_ATOL on that grid, and
    of h·grid (a flat channel) within DMRS_FLAT_ATOL of h on the whole batch.
    Returns per width the cases, the largest errors and, if timed, the ms
    per batch."""
    from srsran_tpu_torch.phy.phch.dmrs_nr import get_sf, put_sf, sc_idx, symbols_idx

    h = DMRS["h"]
    out = {}
    for nof_prb in widths:
        gen = torch.Generator(device=device).manual_seed(nof_prb)
        base = crandn((batch, 14, 12 * nof_prb), gen, device)
        noise = DMRS["amp"] * crandn(base.shape, gen, device)
        base_cpu = base.cpu()
        cfgs = dmrs_configs(nof_prb)
        flat_err = torch.zeros((), device=device)
        get_err, n = 0.0, 0
        for cfg in cfgs:
            syms, k = np.asarray(symbols_idx(cfg))[:, None], sc_idx(cfg)
            for tti in range(ttis):
                i = n % batch
                grid = put_sf(cfg, tti, base.clone())
                rx = h * grid + noise
                ls = get_sf(cfg, tti, rx)
                flat_err = torch.maximum(flat_err, (get_sf(cfg, tti, h * grid) - h).abs().max())
                want = base.clone()
                want[..., syms, k] = grid[i, syms, k]
                ref_put = put_sf(cfg, tti, base_cpu[i].clone())
                ref_get = get_sf(cfg, tti, rx[i].cpu())
                check(bool(torch.equal(grid[i].cpu(), ref_put)) and bool(torch.equal(grid, want)),
                      f"put_sf at {nof_prb} PRB, {cfg}, tti {tti}: not the CPU call's grid")
                check(tuple(ls.shape) == (batch, len(syms), len(k)) and ls.dtype == torch.complex64,
                      f"get_sf shape {tuple(ls.shape)} at {nof_prb} PRB")
                get_err = max(get_err, float((ls[i].cpu() - ref_get).abs().max()))
                n += 1
        flat_err = float(flat_err)
        check(get_err <= DMRS_GET_ATOL, f"get_sf at {nof_prb} PRB: {get_err} from the CPU call")
        check(flat_err <= DMRS_FLAT_ATOL, f"get_sf at {nof_prb} PRB: a flat channel back {flat_err} from h")
        row = dict(configs=len(cfgs), cases=n, grid_mb=base.numel() * 8 / 1e6, get_err=get_err,
                   flat_err=flat_err)
        if timed:
            # the densest pilots: 4 symbols of configuration type 1
            cfg = next(c for c in cfgs if c.type == 1 and c.length == 1 and c.additional_pos == 3
                       and c.duration == 14)
            rx = h * put_sf(cfg, 3, base.clone()) + noise
            row["put_ms"] = batch_ms(lambda: put_sf(cfg, 3, rx))
            row["get_ms"] = batch_ms(lambda: get_sf(cfg, 3, rx))
        out[f"{nof_prb} PRB"] = row
    return out


def nr_link_run() -> dict:
    """The coreless NR link (`NrAirLink`, host only): MIB and SIB1, the RRC
    setup, NAS both ways, NR_LINK's seeded DRB SDUs each way, the release.
    Delivered bytes must equal the bytes sent."""
    from srsran_tpu_torch.apps.nr_stack import GnbStackNr, NrAirLink, UeStackNr

    L = NR_LINK
    n_sdus, sdu_bytes = L["n_sdus"], L["sdu_bytes"]
    gnb, ue = GnbStackNr(cell_id=L["cell_id"]), UeStackNr()
    link = NrAirLink(gnb, ue)
    t0 = time.perf_counter()
    while not (ue.connected and gnb.connected):
        check(link.tti < L["max_connect"], f"NR: not connected after {link.tti} TTIs")
        link.step()
    connect_ttis = link.tti
    _, (_, sib1) = ue.sib1["message"]
    check(ue.mib["message"][1]["cell_barred"] == "not_barred"
          and sib1["cell_access_related_info"]["plmn_id_list"][0]["cell_id"] == L["cell_id"],
          "NR: MIB or SIB1 not acquired")
    check(gnb.rx_nas == [b"\x7e\x00\x41"], f"NR: the setup complete's NAS {gnb.rx_nas}")
    rng = np.random.default_rng(L["seed"])
    dl = [rng.bytes(sdu_bytes) for _ in range(n_sdus)]
    ul = [rng.bytes(sdu_bytes) for _ in range(n_sdus)]
    gnb.write_nas(b"\x7e\x02\xaa\xbb")
    ue.write_nas(b"\x7e\x03\xcc")
    for a, b in zip(dl, ul):
        gnb.write_drb(a)
        ue.write_drb(b)
    t_data, tti_data = time.perf_counter(), link.tti
    while ue.rx_drb != dl or gnb.rx_drb != ul or not ue.rx_nas or len(gnb.rx_nas) < 2:
        check(link.tti < L["max_ttis"], f"NR: {len(ue.rx_drb)}/{n_sdus} DL and {len(gnb.rx_drb)}/"
              f"{n_sdus} UL SDUs after {link.tti} TTIs")
        link.step()
    data_ttis, data_s = link.tti - tti_data, time.perf_counter() - t_data
    check(ue.rx_nas == [b"\x7e\x02\xaa\xbb"] and gnb.rx_nas[1:] == [b"\x7e\x03\xcc"], "NR: NAS transfer")
    gnb.send_release()
    link.run(10)
    check(ue.released and not ue.connected, "NR: the release did not reach the UE")
    wall = time.perf_counter() - t0
    return dict(connect_ttis=connect_ttis, data_ttis=data_ttis, ttis=link.tti,
                ms_per_step=wall * 1e3 / link.tti, data_ms_per_step=data_s * 1e3 / data_ttis,
                dl_bytes=sum(map(len, ue.rx_drb)), ul_bytes=sum(map(len, gnb.rx_drb)))


def ttcn3_run(device, nof_prb: int = TTCN3["nof_prb"]) -> dict:
    """The TTCN-3 system interface over localhost TCP with the port's
    `UeStack` on `device`: cell_cfg, attach (the preamble), the RAR, Msg3 (an
    RRC connection request on CCCH), contention resolution with the setup,
    the setup complete on SRB1, and the C-RNTI read back."""
    import socket

    from srsran_tpu_torch.apps.full_stack import LCID_SRB1
    from srsran_tpu_torch.apps.ttcn3 import SystemInterface
    from srsran_tpu_torch.stack import rrc
    from srsran_tpu_torch.stack.mac import LCID_CCCH, LCID_CON_RES
    from srsran_tpu_torch.stack.mac_pdu import DL_CE_SIZES, UL_CE_SIZES, mac_pack, mac_unpack

    T = TTCN3
    srv = SystemInterface(device=device)
    srv.serve_background()
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
    f = sock.makefile("rwb")
    times = {}

    def rpc(**msg):
        t0 = time.perf_counter()
        f.write((json.dumps(msg) + "\n").encode())
        f.flush()
        reply = json.loads(f.readline())
        times[msg["cmd"]] = times.get(msg["cmd"], 0.0) + (time.perf_counter() - t0) * 1e3
        check(reply.get("event") != "error", f"TTCN-3 {msg['cmd']}: {reply}")
        return reply

    try:
        check(rpc(cmd="cell_cfg", pci=T["pci"], nof_prb=nof_prb)["event"] == "cell_ready", "cell_cfg")
        check(srv.phy.stack.device == torch.device(device), "the UeStack is not on the device")
        r = rpc(cmd="attach")
        check(r["event"] == "prach" and r["preamble"] == T["preamble"], f"attach: {r}")
        check(rpc(cmd="rar", rapid=T["preamble"], temp_crnti=T["crnti"])["crnti"] == T["crnti"], "RAR")
        sdus = dict(mac_unpack(bytes.fromhex(rpc(cmd="ul_pdu", size=64)["data"]), ce_sizes=UL_CE_SIZES))
        check(LCID_CCCH in sdus and rrc.unpack_ul_ccch(sdus[LCID_CCCH])[0] == "rrc_conn_request", "Msg3")
        dl = mac_pack([(LCID_CON_RES, rrc.contention_resolution_id(sdus[LCID_CCCH])),
                       (LCID_CCCH, rrc.pack_conn_setup())], 128, ce_sizes=DL_CE_SIZES)
        check(rpc(cmd="dl_pdu", data=dl.hex())["rrc_state"] >= 3, "the setup did not connect")
        ul = dict(mac_unpack(bytes.fromhex(rpc(cmd="ul_pdu", size=128)["data"]), ce_sizes=UL_CE_SIZES))
        check(LCID_SRB1 in ul, "no setup complete on SRB1")
        st = rpc(cmd="status")
        check(st["rrc_state"] >= 3 and st["crnti"] == T["crnti"], f"status: {st}")
        check(rpc(cmd="ip_rx")["data"] is None, "an IP packet out of nowhere")
    finally:
        f.close()
        sock.close()
        srv.close()
    return dict(crnti=st["crnti"], rrc_state=st["rrc_state"], rpc_ms=times)


def phase_nr(dev) -> dict:
    """Phase 42: the NR DM-RS on the card at 52, 106 and 270 PRB, the
    coreless NR link, the TTCN-3 system interface at 100 PRB.  Returns
    times (no MAP kernel on these paths)."""
    dmrs = dmrs_run(dev)
    for width, r in dmrs.items():
        print(f"nr: DM-RS at {width}: {r['configs']} configurations x {DMRS['ttis']} subframes on "
              f"batches of {DMRS['batch']} grids ({r['grid_mb']:.1f} MB), put_sf bit for bit the CPU's, "
              f"get_sf within {r['get_err']:.3g} of it, the flat channel back within {r['flat_err']:.3g}; "
              f"put_sf {r['put_ms']:.4f} ms, get_sf {r['get_ms']:.4f} ms per batch (CUDA events, "
              f"4 symbols of type 1)")
    link = nr_link_run()
    print(f"nr: the coreless link connected in {link['connect_ttis']} TTIs; {NR_LINK['n_sdus']} x "
          f"{NR_LINK['sdu_bytes']} B each way in {link['data_ttis']} TTIs, every byte back; released; "
          f"{link['ms_per_step']:.3f} ms per step ({link['data_ms_per_step']:.3f} with the data, host)")
    ttcn3 = ttcn3_run(dev)
    print(f"nr: TTCN-3 over localhost TCP, UeStack on {dev} at {TTCN3['nof_prb']} PRB: C-RNTI "
          f"{ttcn3['crnti']:#x} read back, RRC state {ttcn3['rrc_state']}; ms per command "
          + ", ".join(f"{k} {v:.1f}" for k, v in ttcn3["rpc_ms"].items()))
    return dict(dmrs=dmrs, link=link, ttcn3=ttcn3)


# phase 43: the grid-form rate match and `turbo_decode_dyn(perm_groups=)` on a
# W = 8 window of 100 PRB grants at CFI 1, MCS 0-28 (the largest, 13
# codeblocks of K 6144), codeword LLRs of the port's host encoder as BPSK
# at noise sigma
PERM_GROUPS = dict(prb=100, cfi=1, mcs=(0, 4, 8, 12, 16, 20, 24, 28), k_max=6144, rv=0, sigma=0.3,
                   max_iterations=6, rep=8, seed=43, filler=(512, 28))
RM_FORMS_ATOL = 1e-5  # the scatter and gather softbuffers (the reference test's bar)


def rm_positions_check(device) -> int:
    """`turbo_rm_positions_dev` for all 188 sizes at F = 0 and for one
    filler case, rv 0-3, against the host's `turbo_rm_indices`.  Returns
    the number of (K, F, rv) cases."""
    from srsran_tpu_torch.phy.fec.cbsegm import CB_SIZES
    from srsran_tpu_torch.phy.fec.rate_match import turbo_rm_indices
    from srsran_tpu_torch.phy.fec.rate_match_dev import turbo_rm_positions_dev

    k_max = PERM_GROUPS["k_max"]
    cases = [(k, 0) for k in CB_SIZES] + [PERM_GROUPS["filler"]]
    ks = torch.tensor([k for k, _ in cases], device=device)
    fs = torch.tensor([f for _, f in cases], device=device)
    dump = 3 * (k_max + 4)
    for rv in range(4):
        pos, n_valid = turbo_rm_positions_dev(ks, fs, rv, k_max)
        pos, n_valid = pos.cpu().numpy(), n_valid.cpu().numpy()
        for i, (k, f) in enumerate(cases):
            idx = turbo_rm_indices(k, 3 * (k + 4) - 2 * f, rv, f)
            want = idx // (k + 4) * (k_max + 4) + idx % (k + 4)
            check(n_valid[i] == len(want) and np.array_equal(pos[i, : len(want)], want)
                  and bool((pos[i, len(want):] == dump).all()),
                  f"turbo_rm_positions_dev K={k} F={f} rv={rv}: not the host's positions")
    return 4 * len(cases)


def perm_groups_window(device, nof_prb: int = PERM_GROUPS["prb"], mcs=PERM_GROUPS["mcs"]):
    """A window of len(mcs) transport blocks (row w: MCS mcs[w] on every PRB
    of subframe w % 10 at CFI 1), codeword LLRs from the host encoder plus
    seeded noise, and its plan on `device`.  Returns a namespace with the
    rows and `run(per_row=False)`, the chain: the softbuffers by
    `codeword_scatter_dev` and by `codeword_d_fill_dev` (both returned), the
    QPP tables by `qpp_dev`, `turbo_decode_dyn(perm_groups=)` (or, per_row,
    the same tables resolved row by row), the TBs by
    `tb_reassembly_gather_dev` and the TB CRC."""
    from srsran_tpu_torch.phy.common import LTE_CRC24A, Cell
    from srsran_tpu_torch.phy.crc import crc_compute
    from srsran_tpu_torch.phy.fec.cbsegm import F1, F2, cb_size_index, cbsegm
    from srsran_tpu_torch.phy.fec.rate_match_dev import (codeword_d_fill_dev, codeword_scatter_dev,
                                                          ncb_max, qpp_dev, tb_reassembly_gather_dev)
    from srsran_tpu_torch.phy.fec.turbo_dyn import crc_table_ab, turbo_decode_dyn
    from srsran_tpu_torch.phy.phch.pdsch import pdsch_nof_re
    from srsran_tpu_torch.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu_torch.phy.phch.sch import FILLER_LLR, TbCoding, dlsch_encode_np

    P = PERM_GROUPS
    k_max, rv = P["k_max"], P["rv"]
    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=301)
    rng = np.random.default_rng(P["seed"])
    prb = tuple(range(nof_prb))
    rows = []
    for w, m in enumerate(mcs):
        mod, tbs = dl_mcs_to_mod(m), dl_tbs(m, nof_prb)
        cfg = TbCoding(tbs=tbs, g=pdsch_nof_re(cell, w % 10, P["cfi"], prb) * mod.bits_per_symbol,
                       qm=mod.bits_per_symbol, rv=rv)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        cw = dlsch_encode_np(tb, cfg).astype(np.float32)
        llr = (2 * cw - 1 + P["sigma"] * rng.standard_normal(cw.size)).astype(np.float32)
        rows.append(SimpleNamespace(mcs=m, tbs=tbs, g=cfg.g, segm=cbsegm(tbs), es=cfg.e_sizes(), tb=tb,
                                    llr=llr))
    nw, b_cb = len(rows), max(r.segm.C for r in rows)
    g_max, tbs_max = max(r.g for r in rows), max(r.tbs for r in rows)
    dflat = 3 * (k_max + 4)
    cb_k, cb_e, cb_f, cls = (np.zeros((nw, b_cb), np.int64) for _ in range(4))
    valid = np.zeros((nw, b_cb), bool)
    k3 = np.zeros((nw, 3), np.int64)
    llr_pad = np.zeros((nw, g_max + ncb_max(k_max)), np.float32)
    for w, r in enumerate(rows):
        s = r.segm
        # layout classes: codeblock 0 (with the filler bits), K-, K+
        k3[w] = (s.cb_sizes[0], s.K_minus or s.K_plus, s.K_plus)
        llr_pad[w, : r.g] = r.llr
        for c, k in enumerate(s.cb_sizes):
            cb_k[w, c], cb_e[w, c], cb_f[w, c], valid[w, c] = k, r.es[c], s.F if c == 0 else 0, True
            cls[w, c] = 0 if c == 0 else (1 if c < s.C_minus else 2)
    f12 = np.array([[F1[cb_size_index(k)], F2[cb_size_index(k)]] for k in k3.reshape(-1)], np.int64)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    cb_k_t, cb_e_t, cb_f_t, valid_t, cls_t, llr_t, k3_t, f12_t = map(
        t, (cb_k, cb_e, cb_f, valid, cls, llr_pad, k3, f12))
    crc_ab = t(crc_table_ab(k_max))
    is_b = t(np.repeat([r.segm.C > 1 for r in rows], b_cb))
    k_vec = torch.where(valid_t, cb_k_t, 40).reshape(-1)  # unused slots: the smallest size
    pos = torch.arange(k_max + 4, device=device)

    def run(per_row: bool = False):
        soft_s, soft_g = [], []
        for w, r in enumerate(rows):
            tgt = codeword_scatter_dev(cb_k_t[w], cb_e_t[w], cb_f_t[w], valid_t[w], rv, k_max, g_max)
            soft_s.append(torch.zeros(b_cb * dflat + 1, device=device).index_add_(
                0, tgt, llr_t[w, :g_max])[:-1].reshape(b_cb, 3, k_max + 4))
            off, fills = 0, []
            for c in range(b_cb):
                if c < r.segm.C:
                    fills.append(codeword_d_fill_dev(llr_t[w], off, r.es[c], int(cb_k[w, c]),
                                                     int(cb_f[w, c]), rv, k_max, P["rep"]))
                    off += r.es[c]
                else:
                    fills.append(torch.zeros(3, k_max + 4, device=device))
            soft_g.append(torch.stack(fills))
        soft_s, soft_g = torch.stack(soft_s), torch.stack(soft_g)  # (W, B_CB, 3, K_max+4)
        d = soft_g.reshape(nw * b_cb, 3, k_max + 4).clone()
        pin = pos[None, :] < cb_f_t.reshape(-1, 1)  # filler bits are known zeros
        d[:, 0] = torch.where(pin, float(FILLER_LLR), d[:, 0])
        per, inv = qpp_dev(k3_t.reshape(-1), f12_t[:, 0], f12_t[:, 1], k_max)
        per3, inv3 = per.reshape(nw, 3, k_max), inv.reshape(nw, 3, k_max)
        if per_row:
            w_idx = torch.arange(nw, device=device)[:, None]
            perms = dict(per=per3[w_idx, cls_t].reshape(-1, k_max),
                         inv=inv3[w_idx, cls_t].reshape(-1, k_max))
        else:
            perms = dict(per=None, inv=None, perm_groups=(per3, inv3, cls_t))
        bits, post, n_it = turbo_decode_dyn(d, k_vec, valid=valid_t.reshape(-1), k_max=k_max,
                                            max_iterations=P["max_iterations"], crc_table=crc_ab,
                                            crc_is_b=is_b, **perms)
        flat = torch.cat([bits.reshape(nw, -1), bits.new_zeros((nw, 1))], dim=1)
        tbs_hat, ok = [], []
        for w, r in enumerate(rows):
            tb_idx, crc_idx = tb_reassembly_gather_dev(cb_k_t[w], cb_f_t[w], valid_t[w],
                                                       is_b[w * b_cb:(w + 1) * b_cb], r.tbs, k_max,
                                                       tbs_max)
            tb_hat = flat[w][tb_idx][tbs_max - r.tbs:]
            tbs_hat.append(tb_hat)
            ok.append(bool(torch.equal(crc_compute(tb_hat, LTE_CRC24A), flat[w][crc_idx])))
        return SimpleNamespace(soft_s=soft_s, soft_g=soft_g, d=d, bits=bits, post=post, n_it=n_it,
                               tbs=tbs_hat, ok=ok)

    return SimpleNamespace(rows=rows, w=nw, b_cb=b_cb, k_vec=k_vec, run=run)


def check_perm_groups(win, res, res_row) -> int:
    """Phase 43's gates on one run of the window and the per-row form's run
    beside it.  Returns the number of TBs whose CRC passed."""
    err = float((res.soft_s - res.soft_g).abs().max())
    check(err <= RM_FORMS_ATOL, f"perm_groups window: the scatter and gather softbuffers {err} apart")
    check(torch.equal(res.bits, res_row.bits) and torch.equal(res.post, res_row.post)
          and torch.equal(res.n_it, res_row.n_it), "perm_groups differs from the per-row form")
    below_k = torch.arange(res.bits.shape[1], device=res.bits.device)[None, :] < win.k_vec[:, None]
    check(bool(torch.isfinite(res.post[below_k]).all()), "perm_groups window: non-finite posteriors")
    for w, r in enumerate(win.rows):
        check(not res.ok[w] or bool((res.tbs[w].cpu().numpy() == r.tb).all()),
              f"perm_groups window row {w} (MCS {r.mcs}): a CRC-passing TB differs from the sent one")
    return sum(res.ok)


def phase_perm_groups(dev) -> tuple[tuple[int, int], dict]:
    """Phase 43: `turbo_rm_positions_dev` over every size, then the W = 8
    window of 100 PRB grants through the grid-form chain and
    `turbo_decode_dyn(perm_groups=)`: every TB back and the sent one, the
    per-row form identical, the kernel bit for bit its plain version on the
    window's first pass; its N = W·B_CB shape goes to phase 12.  Returns
    ((static, dynamic-K) launches, times)."""
    from srsran_tpu_torch.phy.fec import turbo_cuda
    from srsran_tpu_torch.phy.fec.turbo import _beta_tail, dstream_tails, map_pass_plain, pass_layout

    P = PERM_GROUPS
    t0 = time.perf_counter()
    n_pos = rm_positions_check(dev)
    pos_s = time.perf_counter() - t0
    win = perm_groups_window(dev)
    reset_launches()
    res = win.run()
    launches = read_launches()
    res_row = win.run(per_row=True)
    n_ok = check_perm_groups(win, res, res_row)
    check(n_ok == win.w, f"perm_groups window: {n_ok}/{win.w} TBs pass their CRC")
    check(launches[0] == 0 and launches[1] > 0, f"perm_groups window: map launches {launches}")
    # the kernel at this shape against its plain version on the window's
    # first decoder-1 pass (no extrinsic yet)
    k_max, n = P["k_max"], win.w * win.b_cb
    below_k = torch.arange(k_max, device=dev)[None, :] < win.k_vec[:, None]
    tail_cols = (win.k_vec[:, None, None] + torch.arange(4, device=dev)).expand(n, 3, 4)
    lx1_t, lz1_t, _, _ = dstream_tails(torch.gather(res.d, 2, tail_cols))
    lx, lz = (torch.where(below_k, res.d[:, s, :k_max], 0.0).contiguous() for s in (0, 1))
    beta_k, k_i32 = _beta_tail(lx1_t, lz1_t), win.k_vec.to(torch.int32)
    got = turbo_cuda.map_pass(lx, lz, beta_k, *pass_layout(k_max), k_vec=k_i32)
    ref = map_pass_plain(lx, lz, beta_k, k_max, k_i32)
    check(torch.equal(got[below_k], ref[below_k]), f"dyn kernel not bit for bit plain at N={n}")
    tags = WINDOW_SHAPES.setdefault(n, {}).setdefault(tuple(win.k_vec.tolist()), [])
    if "perm_groups window" not in tags:
        tags.append("perm_groups window")
    win.run()  # warm
    ms = cuda_ms(win.run, 3)
    host_ms = wall_ms(win.run, 3)
    rows = win.rows
    times = dict(positions_cases=n_pos, positions_s=pos_s, w=win.w, b_cb=win.b_cb, n=n,
                 mcs=[r.mcs for r in rows], tbs=[r.tbs for r in rows], codeblocks=[r.segm.C for r in rows],
                 n_iters=res.n_it.reshape(win.w, win.b_cb).max(dim=1).values.tolist(),
                 map_launches=list(launches), ms_per_window=ms, host_ms_per_window=host_ms)
    print(f"perm_groups: turbo_rm_positions_dev equals the host's turbo_rm_indices at {n_pos} (K, F, rv) "
          f"cases ({pos_s:.1f} s with the host's); the W = {win.w} window of {P['prb']} PRB grants, MCS "
          f"{times['mcs']}, tbs {times['tbs']}, {times['codeblocks']} codeblocks (B_CB {win.b_cb}, N {n}): "
          f"the scatter and gather softbuffers agree, {n_ok}/{win.w} TBs back and the sent ones, "
          f"iterations {times['n_iters']}, the per-row form identical, {launches[1]} dynamic-K launches, "
          f"the kernel bit for bit plain at N={n}; {ms:.3f} ms per window by CUDA events, {host_ms:.3f} ms "
          f"host wall")
    return launches, times


def phase_static_shapes(dev, shapes) -> tuple[float, list]:
    """Phase 25: the static kernel against `map_pass_plain` at every (B, nw,
    lw, T) that phases 22-24 launched it at.  Returns (max_abs_err, [dict
    per shape])."""
    from srsran_tpu_torch.phy.fec import turbo_cuda
    from srsran_tpu_torch.phy.fec.turbo import map_pass_plain

    max_err, rows = 0.0, []
    for (b, nw, lw, T, _dyn), n in sorted(shapes.items(), key=lambda kv: (kv[0][1] * kv[0][2], kv[0][0])):
        k = nw * lw
        lx, lz, beta_k = map_inputs(k, b, seed=k + b, device=dev)
        got = turbo_cuda.map_pass(lx, lz, beta_k, nw, lw, T)
        ref = map_pass_plain(lx, lz, beta_k, k, layout=(nw, lw, T))
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        same = bool(torch.equal(got > 0, ref > 0))
        check(bool(torch.isfinite(got).all()) and err <= MAP_ATOL and same,
              f"static kernel disagrees with plain at B={b} K={k}: {err}, bits {same}")
        ms = queued_ms(lambda: turbo_cuda.map_pass(lx, lz, beta_k, nw, lw, T), 50)
        plain = cuda_ms(lambda: map_pass_plain(lx, lz, beta_k, k, layout=(nw, lw, T)), 3)
        bound, by = map_bound(lx, lz, beta_k, (nw, lw, T))
        max_err = max(max_err, err)
        rows.append(dict(shape=[b, k], layout=[nw, lw, T], launches=n, ms=ms, plain_ms=plain,
                         bound_ms=bound, bound_by=by, max_abs_err=err))
        print(f"map B={b} K={k} (nw={nw} lw={lw} T={T}, {n} launches): max_abs_err {err:.3g}, hard bits "
              f"identical; kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.3g} ms by {by} "
              f"({bound / ms:.2%} of it)")
    return max_err, rows


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
    mark("phase 2: build")
    t0 = time.perf_counter()
    lib = turbo_cuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib.name})")
    from srsran_tpu_torch import native

    t0 = time.perf_counter()
    native_lib = native.build()
    print(f"build: native library {time.perf_counter() - t0:.1f} s ({native_lib.name}, g++ "
          f"{' '.join(native.CXXFLAGS)})")
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
    mark("phase 3: the kernel against plain")
    max_err = 0.0
    headline = None
    ul_shape = None
    for k, ncb, layout in ((5632, 88, None), (5632, 1408, None), (512, 64, None), (40, 300, None),
                           (6080, 16, None), (6144, 16, None), (135, 64, (3, 45, 32)),
                           (5824, 896, None), (6144, 2048, None)):
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
        if ncb == 896:
            ul_shape = (lx, lz, beta_k, (nw, lw, T))
    max_err_dyn = 0.0
    # mixed K in every bucket, then the bucket a UL grant of 7 codeblocks of
    # K=5824 reaches (B bucket 8; the unused slot takes the first one's K)
    for k_max, ks in list(DYN_KS.items()) + [(6144, (5824,) * 8)]:
        ks = ks * max(1, 32 // len(ks)) if len(set(ks)) > 1 else ks
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
    mark("phases 4-5: ue_dl_subframe")
    fx, cell, grant, fn, samples = load_slice(dev)
    tbs, nof_prb = grant.tbs, cell.nof_prb
    tb_tx = torch.from_numpy(np.unpackbits(fx["tb_packed"], count=tbs)).to(dev)
    ref_tb = torch.from_numpy(np.unpackbits(fx["ref_tb_packed"], axis=-1, count=tbs)).to(dev)

    reset_launches()
    tb, ok, snr_db = fn(samples)
    launches, _ = read_launches()
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
    # the UL path's shape: 128 subframes x 7 codeblocks of K=5824 (nw=56, lw=104)
    lx_u, lz_u, beta_u, layout_u = ul_shape
    ul_ms = queued_ms(lambda: turbo_cuda.map_pass(lx_u, lz_u, beta_u, *layout_u), 20)
    ul_plain_ms = cuda_ms(lambda: map_pass_plain(lx_u, lz_u, beta_u, lx_u.shape[1]), 3)
    ul_bound_ms, ul_bound_by = map_bound(lx_u, lz_u, beta_u, layout_u)
    print(f"map pass at {tuple(lx_u.shape)}: kernel {ul_ms:.4f} ms, plain {ul_plain_ms:.3f} ms, "
          f"bound {ul_bound_ms:.4f} ms by {ul_bound_by}")
    # other shapes: one block, one wave of three blocks an SM, other K
    for k, ncb in ((6144, 1), (6144, 396), (6144, 1408), (2048, 1408), (512, 4096), (40, 4096)):
        ins = map_inputs(k, ncb, seed=1, device=dev)
        ms = queued_ms(lambda: turbo_cuda.map_pass(*ins, *pass_layout(k)), 50)
        print(f"map pass at ({ncb}, {k}): kernel {ms:.4f} ms, bound "
              f"{map_bound(*ins, pass_layout(k))[0]:.4f} ms")

    # phase 6: the dynamic-grant decode at full width
    mark("phases 6-7: DynamicUeDl")
    ue = DynamicUeDl(cell, cfi=1, max_iterations=int(fx["max_iterations"]))
    check(ue.device == dev, "DynamicUeDl did not take the card by default")
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    reset_launches()

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
    launches_static, launches_dyn = read_launches()
    check(launches_dyn > 0, "the dynamic path did not launch the dynamic-K kernel mode")
    check(launches_static == 0, "the dynamic path launched the static mode")
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

    # phases 8-11: the other entry points, each with its own launch counts
    del fn, samples, ue, ue_fx
    by_path = {"ue_dl_subframe": (launches, 0), "DynamicUeDl": (0, launches_dyn)}
    for name, phase in (("ue_dl_subframe_mimo", phase_mimo),
                        ("enb_dl_subframe_encode+ue_dl_subframe", phase_encode),
                        ("enb_ul_subframe", phase_ul),
                        ("DynamicEnbUl+DynamicUeDl 2-port", phase_dynamic_ul)):
        mark(name)
        by_path[name] = phase(dev)
        torch.cuda.empty_cache()

    # phases 12-16: the windowed engines
    windows = {}
    mark("phase 13: WindowedUeDl")
    by_path["WindowedUeDl"], windows["WindowedUeDl"] = phase_window_dl(dev)
    torch.cuda.empty_cache()
    for name, kind in (("WindowedUeDlMimo", "ue_dl_mimo"), ("WindowedEnbUl", "enb_ul")):
        mark(f"phase {14 + (kind == 'enb_ul')}: {name}")
        by_path[name], windows[name] = phase_window_other(dev, kind)
        torch.cuda.empty_cache()
    mark("phase 16: the stored windows")
    by_path["stored windows"] = phase_stored_windows(dev)
    # phases 17-18: the generate windows and the loopbacks
    for kind in GEN_KINDS:
        mark(f"phase 17: {GEN_NAMES[kind]}")
        windows[GEN_NAMES[kind]] = phase_generate(dev, kind)
        torch.cuda.empty_cache()
    for kind in GEN_KINDS:
        mark(f"phase 18: loopback {kind}")
        by_path[f"loopback {kind}"], windows[f"loopback {kind}"] = phase_loopback(dev, kind)
        torch.cuda.empty_cache()
    # phases 19-21: the control plane
    for kind, phase in (("dl", phase_ctrl_dl), ("ul", phase_ctrl_ul)):
        mark(f"phase {19 + (kind == 'ul')}: ctrl loopback {kind}")
        by_path[f"ctrl loopback {kind}"], windows[f"ctrl loopback {kind}"] = phase(dev)
        torch.cuda.empty_cache()
    mark("phase 21: the stored control windows")
    by_path["stored ctrl windows"] = phase_stored_ctrl(dev)
    # phases 22-25: the DL receive chain from air samples
    turbo_cuda.SHAPES.clear()
    mark("phase 22: the golden vectors")
    by_path["golden vectors"] = phase_golden(dev)
    mark("phase 23: the stored received frame")
    by_path["stored frame"] = phase_stored_frame(dev)
    rx_shapes = Counter(turbo_cuda.SHAPES)
    mark("phase 24: the 20 MHz link")
    by_path["link EnbApp->UeApp"], windows["link EnbApp->UeApp"], link_shapes = phase_link(dev)
    rx_shapes.update(link_shapes)
    # phases 26-27: the eNB UL receive chain
    mark("phase 26: the stored UL subframes")
    before = Counter(turbo_cuda.SHAPES)
    by_path["stored UL subframes"] = phase_stored_ul(dev)
    stored_ul_shapes = Counter(turbo_cuda.SHAPES)
    stored_ul_shapes.subtract(before)
    rx_shapes.update(+stored_ul_shapes)
    mark("phase 27: the 20 MHz UL link")
    by_path["UL link"], windows["UL link"], ul_link_shapes = phase_ul_link(dev)
    rx_shapes.update(ul_link_shapes)
    torch.cuda.empty_cache()
    # phases 28-30: the per-TTI LTE stack
    mark("phase 28: the stored attach")
    before = Counter(turbo_cuda.SHAPES)
    by_path["stack stored attach"] = phase_stored_stack(dev)
    rx_shapes.update(+(Counter(turbo_cuda.SHAPES) - before))
    torch.cuda.empty_cache()
    mark("phase 29: the 20 MHz attached link")
    by_path["stack link"], windows["stack link"], stack_shapes = phase_stack_link(dev)
    rx_shapes.update(stack_shapes)
    torch.cuda.empty_cache()
    mark("phase 30: the dynamic and windowed data planes")
    plane_launches, windows["stack planes"], plane_shapes = phase_stack_planes(dev)
    for mode, launches_mode in plane_launches.items():
        by_path[f"stack {mode} plane"] = launches_mode
        rx_shapes.update(plane_shapes[mode])
    torch.cuda.empty_cache()
    # phase 31: the windowed control-plane stack at the bench's width and at
    # the full width
    for nof_prb in STACK_WINDOW["widths"]:
        mark(f"phase 31: the windowed control-plane stack at {nof_prb} PRB")
        name = f"stack window {nof_prb} PRB"
        by_path[name], windows[name] = phase_stack_window(dev, nof_prb)
        torch.cuda.empty_cache()
    # phases 32-34: the run scripts as processes on the card
    mark("phase 32: run_lte_3proc at 100 PRB")
    by_path["run_lte_3proc"], windows["run_lte_3proc"], proc_shapes = phase_run_lte(dev)
    rx_shapes.update(proc_shapes)
    mark("phase 33: run_lte_demo at 100 PRB")
    by_path["run_lte_demo"], windows["run_lte_demo"] = phase_run_lte_demo(dev)
    mark("phase 34: enb_app -> ue_app over UDP")
    by_path["enb_app->ue_app"], windows["enb_app->ue_app"] = phase_udp_apps(dev)
    # phases 35-37: frame structure 2, the examples, the Wiener estimators
    # and the resamplers
    mark("phase 35: the stored TDD attach")
    before = Counter(turbo_cuda.SHAPES)
    by_path["stack stored TDD attach"] = phase_stored_stack(dev, FIXTURE_STACK_TDD, "stored TDD attach")
    rx_shapes.update(+(Counter(turbo_cuda.SHAPES) - before))
    torch.cuda.empty_cache()
    mark("phase 36: the 20 MHz TDD attached link")
    by_path["TDD link"], windows["TDD link"], tdd_shapes = phase_stack_link_tdd(dev)
    rx_shapes.update(tdd_shapes)
    torch.cuda.empty_cache()
    mark("phase 37: the examples, the Wiener estimators and the resamplers")
    by_path["examples"], windows["examples"], example_shapes = phase_examples(dev)
    rx_shapes.update(example_shapes)
    torch.cuda.empty_cache()
    # phases 38-41: more than one device, eMBMS, NB-IoT, sidelink
    mark("phase 38: carriers over a mesh")
    carrier_paths, windows["carriers"], carrier_shapes = phase_carriers(dev)
    by_path.update(carrier_paths)
    rx_shapes.update(carrier_shapes)
    torch.cuda.empty_cache()
    mark("phase 39: eMBMS")
    by_path["PMCH"], windows["eMBMS"], embms_shapes = phase_embms(dev)
    rx_shapes.update(embms_shapes)
    mark("phase 40: NB-IoT")
    windows["NB-IoT"] = phase_nbiot(dev)
    mark("phase 41: sidelink")
    by_path["sidelink"], windows["sidelink"], sl_shapes = phase_sidelink(dev)
    rx_shapes.update(sl_shapes)
    torch.cuda.empty_cache()
    # phases 42-43: NR, the grid-form rate match and perm_groups
    mark("phase 42: NR")
    windows["NR"] = phase_nr(dev)
    torch.cuda.empty_cache()
    mark("phase 43: the grid-form rate match and perm_groups")
    by_path["perm_groups window"], windows["perm_groups window"] = phase_perm_groups(dev)
    torch.cuda.empty_cache()
    mark("phase 25: the static kernel at the receive chains' and the stack's shapes")
    max_err_rx, rx_rows = phase_static_shapes(dev, {k: v for k, v in rx_shapes.items() if not k[4]})
    max_err = max(max_err, max_err_rx)
    torch.cuda.empty_cache()
    mark("phase 12: the dynamic-K kernel at the windows' shapes")
    max_err_win, win_shapes = phase_window_kernel(dev)
    # and at the shapes the dynamic plane of phase 30 and the examples of
    # phase 37 gave it
    max_err_stack, stack_dyn_rows = phase_dyn_shapes(
        dev, {k: v for k, v in (plane_shapes["dynamic"] + example_shapes).items() if k[4]})
    max_err_dyn = max(max_err_dyn, max_err_win, max_err_stack)
    print(json.dumps({"windows": windows}))

    common = {"route": "cuda", "source": "srsran_tpu_torch/csrc/map_window.cu", "library_ms": None}
    print(json.dumps({"kernels": [
        dict(common, name="map_window", replaces="srsran_tpu/phy/fec/turbo_pallas.py:99",
             launches=sum(v[0] for v in by_path.values()),
             launches_by_path={k: v[0] for k, v in by_path.items() if v[0]},
             max_abs_err=max_err, ms=kern_ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by, shape=list(lx.shape),
             other_shapes=[dict(shape=list(lx_u.shape), ms=ul_ms, plain_ms=ul_plain_ms,
                                bound_ms=ul_bound_ms, bound_by=ul_bound_by)] + rx_rows),
        dict(common, name="map_window_dyn", replaces="srsran_tpu/phy/fec/turbo_pallas.py:232",
             launches=sum(v[1] for v in by_path.values()),
             launches_by_path={k: v[1] for k, v in by_path.items() if v[1]},
             max_abs_err=max_err_dyn, ms=kern_dyn_ms, plain_ms=plain_dyn_ms,
             bound_ms=bound_dyn_ms, bound_by=bound_dyn_by, shape=list(lx_d.shape),
             other_shapes=win_shapes + stack_dyn_rows)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
