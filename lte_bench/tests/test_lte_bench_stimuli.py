"""The generator: the same seed gives the same inputs, another seed others."""

from __future__ import annotations

import numpy as np
import torch

from lte_bench import catalog, stimuli
from lte_bench.tests.small import SMALL_MIX, make_root


def _pool(root, seed):
    _w, cfg, mix = catalog.cell(root, "dl_small")
    link = catalog.link(cfg)
    sent = stimuli.draw_tbs(seed, mix["n_tbs"], cfg["grant"]["tbs"])
    return sent, stimuli.build_pool(torch.from_numpy(stimuli.render(link, cfg, sent)), mix, seed)


def test_stimuli_per_seed(tmp_path):
    root = make_root(tmp_path)
    big = 2**31 + 12345
    a_tb, a = _pool(root, big)
    b_tb, b = _pool(root, big)
    c_tb, c = _pool(root, big + 1)
    assert np.array_equal(a_tb, b_tb) and torch.equal(a, b)
    assert not np.array_equal(a_tb, c_tb) and not torch.equal(a, c)
    assert a.shape == (SMALL_MIX["pool_batches"], SMALL_MIX["batch"], 1, 15 * 512)
    assert len({row.tobytes() for row in a_tb}) == SMALL_MIX["n_tbs"]


def test_tb_index_rotates_between_batches():
    mix = dict(SMALL_MIX, batch=128, n_tbs=32, pool_batches=16)
    idx = stimuli.tb_index(mix)
    assert idx.shape == (16, 128)
    assert all(sorted(set(row)) == list(range(32)) for row in idx)
    assert not (idx[1:] == idx[:-1]).any()
