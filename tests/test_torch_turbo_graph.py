"""On the card only; skipped without a CUDA device.  Run on the chip with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_turbo_graph.py

(`--noconftest`: the suite's conftest imports JAX, which that machine
lacks).  The turbo loop's set-up and iteration replayed as CUDA graphs
(`turbo._GraphedLoop`) against the eager loop, on the d-stream LLRs that
the benchmark's entries hand `turbo_decode` for batches made as
`lte_bench/stimuli.py` makes them: DL n090 (1408 x 5632, about 3
iterations) and UL n150 (896 x 5824, 2-3):

- every call's bits, posteriors, iteration count and MAP launches (the
  delta of `turbo_cuda.LAUNCHES`) equal the eager loop's on the same
  LLRs, and calls that alternate two batches see nothing of each other;
- the first call with a key runs eagerly and captures nothing, the
  second captures, the later ones replay every iteration;
- the number of graphs a device keeps stays at `GRAPHS_PER_DEVICE`.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from lte_bench import catalog, stimuli
from srsran_tpu_torch.phy.fec import turbo, turbo_cuda
from srsran_tpu_torch.phy.phch import sch
from srsran_tpu_torch.runtime.trace import counts

pytestmark = pytest.mark.card

REPO = Path(__file__).resolve().parents[1]
SEED = 2**31 + 23


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the chip "
                    "(python -m pytest --noconftest tests/test_torch_turbo_graph.py)")
    turbo._GRAPHS.clear()
    turbo._SEEN.clear()
    yield torch.device("cuda", 0)
    turbo._GRAPHS.clear()
    turbo._SEEN.clear()


def entry_llrs(cell: str, dev: torch.device, monkeypatch) -> list[tuple]:
    """(d_llr, k, max_iterations, crc_table) of the `turbo_decode` calls
    the cell's entry makes on two batches of its mix."""
    _w, cfg, mix = catalog.cell(REPO, cell)
    link = catalog.link(cfg)
    sent = stimuli.draw_tbs(SEED, mix["n_tbs"], cfg["grant"]["tbs"])
    clean = torch.from_numpy(stimuli.render(link, cfg, sent)).to(dev)
    pool = stimuli.build_pool(clean, dict(mix, pool_batches=2), SEED)
    calls = []

    def spy(d_llr, k, max_iterations=5, crc_table=None, graphed=False):
        calls.append((d_llr.clone(), k, max_iterations, crc_table))
        return turbo.turbo_decode(d_llr, k, max_iterations, crc_table=crc_table)

    monkeypatch.setattr(sch, "turbo_decode", spy)
    fn = link.build_entry(cfg, [dev])
    for x in pool:
        fn(x)
    monkeypatch.undo()
    return calls


def decode(d_llr, k, max_iterations, crc_table, graphed):
    """turbo_decode's results on the host, with its MAP launches and the
    iterations it counted and replayed."""
    launches, before = turbo_cuda.LAUNCHES, counts()
    bits, post, n_it = turbo.turbo_decode(d_llr, k, max_iterations, crc_table=crc_table,
                                          graphed=graphed)
    bits, post = bits.cpu().numpy(), post.cpu().numpy()
    after = counts()
    delta = {name: after.get(name, 0) - before.get(name, 0)
             for name in ("turbo_iterations", "turbo_graph_replays")}
    return bits, post, n_it, turbo_cuda.LAUNCHES - launches, delta


@pytest.mark.parametrize("cell,b,k", [("dl_siso-b128-n090", 1408, 5632),
                                      ("ul_pusch-b128-n150", 896, 5824)])
def test_graphed_loop_is_the_eager_loop(cuda_device, monkeypatch, cell, b, k):
    calls = entry_llrs(cell, cuda_device, monkeypatch)
    assert [(c[0].shape[0], c[1]) for c in calls] == [(b, k), (b, k)]
    eager = [decode(*c, graphed=False) for c in calls]
    assert max(e[2] for e in eager) >= 2  # iterations past the first to replay
    key = (b, k, id(calls[0][3]))
    # first, second (capture), then replays, alternating the two batches
    for n, j in enumerate([0, 1, 0, 1, 1, 0]):
        bits, post, n_it, launches, delta = decode(*calls[j], graphed=True)
        want = eager[j]
        np.testing.assert_array_equal(bits, want[0])
        np.testing.assert_array_equal(post, want[1])
        assert (n_it, launches) == (want[2], want[3]) == (n_it, 2 * n_it)
        assert delta["turbo_iterations"] == n_it
        graphs = turbo._GRAPHS.get(cuda_device, {})
        if n == 0:  # a key seen once is not captured
            assert key not in graphs and delta["turbo_graph_replays"] == 0
        elif n == 1:  # the capture call runs its first iteration for real
            assert len(graphs[key].graphs) == 2
            assert delta["turbo_graph_replays"] == n_it - 1
        else:
            assert delta["turbo_graph_replays"] == n_it


def test_graphs_per_device_stay_bounded(cuda_device):
    """Two calls each of GRAPHS_PER_DEVICE + 2 shapes: the device keeps the
    GRAPHS_PER_DEVICE used last, and each replay gives the eager loop's
    results."""
    rng = np.random.default_rng(SEED)
    k, shapes = 40, range(1, turbo.GRAPHS_PER_DEVICE + 3)
    for b in shapes:
        d_llr = torch.from_numpy(rng.standard_normal((b, 3, k + 4)).astype(np.float32))
        d_llr = d_llr.to(cuda_device)
        want = decode(d_llr, k, 3, None, graphed=False)
        for _ in range(2):
            got = decode(d_llr, k, 3, None, graphed=True)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2:4] == want[2:4] == (3, 6)
        assert len(turbo._GRAPHS[cuda_device]) == min(b, turbo.GRAPHS_PER_DEVICE)
    kept = list(shapes)[-turbo.GRAPHS_PER_DEVICE:]
    assert [key[0] for key in turbo._GRAPHS[cuda_device]] == kept
