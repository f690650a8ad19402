"""What every link that decodes one transport block a subframe shares: the
tally of a batch and the judgement of the kept batches.

The entry's results are (tb (B, tbs) uint8, ok (B,) bool, snr_db (B,)).
The numbers compared (`CHECKS`, each with its limit in the
configuration's file): `tb_wrong`, CRC-passing TBs whose bits differ from
the sent TB, over every kept batch; `crc_diff`, subframes whose CRC flag
differs from the plain reference receiver's, and `snr_gap_db`, the widest
gap between the program's snr_db and the reference's, over the first
`ref_batches` kept batches.
"""

from __future__ import annotations

import numpy as np

CHECKS = ("tb_wrong", "crc_diff", "snr_gap_db")


def tally(results, cfg: dict) -> tuple[int, int]:
    """(TBs that pass their CRC, bits they deliver) of one batch's results
    on the host."""
    n_ok = int(results[1].sum())
    return n_ok, n_ok * cfg["grant"]["tbs"]


def judge(kept, pool, idx, sent, cfg: dict, reference, ref_batches: int) -> dict:
    """`kept` [(pool index, results on the host)]; `idx` the TB each
    subframe of the pool carries, `sent` the TBs; `reference(samples, cfg)`
    the plain receiver."""
    tb_wrong, crc_diff, snr_gap = 0, 0, 0.0
    for n, (p, (tb_h, ok_h, snr_h)) in enumerate(kept):
        ok = ok_h.numpy()
        tb_wrong += int((ok & (tb_h.numpy() != sent[idx[p]]).any(axis=1)).sum())
        if n < ref_batches:
            _r_tb, r_ok, r_snr = reference(pool[p], cfg)
            crc_diff += int((ok != r_ok.cpu().numpy()).sum())
            gap = np.abs(snr_h.numpy().astype(np.float64) - r_snr.cpu().numpy())
            snr_gap = max(snr_gap, float(np.nan_to_num(gap, nan=np.inf).max()))
    return {"tb_wrong": tb_wrong, "crc_diff": crc_diff, "snr_gap_db": snr_gap}
