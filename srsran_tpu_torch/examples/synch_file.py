"""synch_file — PSS correlation over a captured sample file (the
`lib/examples/synch_file.c` analog; the port's twin of
`examples/synch_file.py`): correlate every frame against the three PSS
roots (one batched FFT correlation on `--device`), print per-frame peak
position, metric and CFO; optionally dump the correlation magnitude.

  python -m srsran_tpu_torch.examples.synch_file -i capture.cf32
  python -m srsran_tpu_torch.examples.synch_file -i capture.cf32 -l 9600 -N 2 -o corr.txt
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve
from ..phy.sync.pss import pss_cfo_estimate, pss_correlate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", required=True, help="cf32 capture")
    ap.add_argument("-l", "--frame-length", type=int, default=9600)
    ap.add_argument("-n", "--nof-frames", type=int, default=100)
    ap.add_argument("-N", "--force-n-id-2", type=int, default=-1,
                    help="only report this PSS root (0/1/2)")
    ap.add_argument("-t", "--threshold", type=float, default=4.0,
                    help="peak-to-sidelobe detection threshold")
    ap.add_argument("-o", "--output", default=None,
                    help="write |correlation| of the chosen root per frame")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    x = np.fromfile(args.input, np.complex64)
    fl = args.frame_length
    n_frames = min(len(x) // fl, args.nof_frames)
    if n_frames == 0:
        raise SystemExit("input shorter than one frame")

    frames = torch.from_numpy(x[: n_frames * fl].reshape(n_frames, fl)).to(device)
    mags_all = pss_correlate(frames).cpu().numpy()  # (n_frames, 3, fl)
    out = open(args.output, "w") if args.output else None
    n_det = 0
    for fi in range(n_frames):
        mags = mags_all[fi]
        roots = [args.force_n_id_2] if args.force_n_id_2 >= 0 else range(3)
        best = None
        for r in roots:
            m = mags[r]
            pk = int(np.argmax(m))
            metric = m[pk] / max(np.mean(m), 1e-12)
            if best is None or metric > best[2]:
                best = (r, pk, metric)
        r, pk, metric = best
        det = metric > args.threshold
        # peak index = sample where the PSS replica starts
        cfo = (float(pss_cfo_estimate(frames[fi, pk: pk + 128], r)) if pk + 128 <= fl else 0.0)
        n_det += int(det)
        print(f"frame {fi:3d}: N_id_2 {r}  peak @ {pk:6d}  metric {metric:6.1f} "
              f"{'DET' if det else '   '}  cfo {cfo:+.3f} subcarriers")
        if out is not None and (args.force_n_id_2 < 0 or r == args.force_n_id_2):
            np.savetxt(out, mags[r][None], fmt="%.4e")
    if out is not None:
        out.close()
    print(f"{n_det}/{n_frames} frames above threshold")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
