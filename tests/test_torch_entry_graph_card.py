"""On the card only; skipped without a CUDA device.  Run on the chip with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_entry_graph_card.py

(`--noconftest`: the suite's conftest imports JAX, which that machine
lacks).  The DL entries replayed as CUDA graphs (`graphs.Graphed`) against
the same entries run eagerly, at the benchmark cells' configurations
(`dl_siso-b128-n090`, `dl_mimo2x2-b64-n045`) on batches made as
`lte_bench/stimuli.py` makes them:

- every call's TB bits, CRC flags and snr_db equal the eager entry's on the
  same batch bit for bit, and calls that alternate two batches see nothing
  of each other; a result kept from one call is unchanged after the next;
- the first call with a shape captures nothing, the second captures, the
  later ones replay (`entry_graph_replays`);
- a replayed call launches the eager call's kernels, name for name (a
  copy inside a graph may run as CUDA's own `memcpy32_post` kernel);
- the graphs a device keeps stay at `graphs.ENTRY_GRAPHS_PER_DEVICE`.
"""

from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_leaves

from lte_bench import catalog, stimuli
from srsran_tpu_torch import graphs, pipeline
from srsran_tpu_torch.phy.common import Cell
from srsran_tpu_torch.phy.modem import Mod
from srsran_tpu_torch.phy.phch.pdsch import DlGrant
from srsran_tpu_torch.runtime.trace import counts

pytestmark = pytest.mark.card

REPO = Path(__file__).resolve().parents[1]
SEED = 2**31 + 25


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the chip "
                    "(python -m pytest --noconftest tests/test_torch_entry_graph_card.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    graphs.ENTRIES.by_device.clear()
    graphs.ENTRIES.seen.clear()
    yield torch.device("cuda", 0)
    graphs.ENTRIES.by_device.clear()
    graphs.ENTRIES.seen.clear()


def host(out) -> list[torch.Tensor]:
    """An entry's results, flattened, on the host."""
    return [t.cpu() for t in tree_leaves(out)]


def replays() -> int:
    return counts().get("entry_graph_replays", 0)


def device_ops(call) -> Counter:
    """The operations, kernels and copies, that `call()` runs on the card."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation())


def kernels(ops: Counter) -> Counter:
    """The kernels of `ops`, copies and fills not counted: neither the
    eager copies (`Memcpy ...`) nor those a graph runs as a kernel of
    CUDA's own (`memcpy32_post`)."""
    return Counter({n: c for n, c in ops.items()
                    if not n.startswith(("Memcpy", "Memset")) and n != "memcpy32_post"})


@pytest.mark.parametrize("cell", ["dl_siso-b128-n090", "dl_mimo2x2-b64-n045"])
def test_replays_are_the_eager_entry(cuda_device, cell):
    _w, cfg, mix = catalog.cell(REPO, cell)
    link = catalog.link(cfg)
    sent = stimuli.draw_tbs(SEED, mix["n_tbs"], cfg["grant"]["tbs"])
    clean = torch.from_numpy(stimuli.render(link, cfg, sent)).to(cuda_device)
    pool = stimuli.build_pool(clean, dict(mix, pool_batches=2), SEED)
    # each batch's eager results: a fresh entry's first call runs eagerly
    eager = [host(link.build_entry(cfg, [cuda_device])(x)) for x in pool]
    assert all(bool(e[1].any()) for e in eager)
    fn = link.build_entry(cfg, [cuda_device])
    kept = None
    for n, j in enumerate([0, 1, 0, 1, 1, 0]):
        before = replays()
        out = fn(pool[j])
        got = host(out)
        assert len(got) == len(eager[j])
        for a, b in zip(got, eager[j]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        held = graphs.ENTRIES.by_device.get(cuda_device, {})
        if n == 0:  # a shape seen once is not captured
            assert not held and replays() == before
        elif n == 1:  # the second call captures
            assert len(held) == 1 and replays() == before
        else:
            assert replays() == before + 1
        if kept is not None:  # the last call's results are its own
            for a, b in zip(host(kept[0]), kept[1]):
                assert torch.equal(a, b)
        kept = (out, got)
    # a replayed call runs the kernels of an eager one; a device-to-device
    # copy inside a graph may run as CUDA's own kernel `memcpy32_post`
    eager_fn = link.build_entry(cfg, [cuda_device])
    replayed, eager_ops = device_ops(lambda: fn(pool[0])), device_ops(lambda: eager_fn(pool[0]))
    assert kernels(replayed) == kernels(eager_ops)
    copies = sum(c for n, c in eager_ops.items() if n.startswith("Memcpy DtoD"))
    assert replayed["memcpy32_post"] <= copies


def test_graphs_per_device_stay_bounded(cuda_device):
    """Two calls each of ENTRY_GRAPHS_PER_DEVICE + 2 entries: the device
    keeps the graphs of those used last, and each replay gives the eager
    call's results."""
    cell = Cell(nof_prb=6, id=7)
    x = torch.randn((2, 1, cell.sf_len), dtype=torch.complex64, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(SEED))
    n = graphs.ENTRY_GRAPHS_PER_DEVICE + 2
    for i in range(n):
        grant = DlGrant(prb=tuple(range(6)), mod=Mod.QPSK, tbs=504, rnti=0x1234 + i)
        fn = pipeline.ue_dl_subframe(cell, 2, 1, grant, 3, device=cuda_device)
        want = host(fn(0.1 * x))
        for _ in range(2):
            got = host(fn(0.1 * x))
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert len(graphs.ENTRIES.by_device[cuda_device]) == min(i + 1,
                                                                 graphs.ENTRY_GRAPHS_PER_DEVICE)
