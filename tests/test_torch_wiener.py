"""The Wiener channel estimators on the port against the JAX reference, on
the CPU: `chest_dl(ChestDlConfig(algorithm="wiener"))` (the fixed MMSE
matrices, `chest_dl._wiener_matrices`) and `phy/chest/wiener_dl.py`'s
adaptive estimator (`wiener_init`, `wiener_adapt`, `chest_dl_adaptive`).

Tolerances: the fixed matrices within 1e-5 (both complex64 casts of one
float64 inverse); the branch's outputs within 1e-5 relative and absolute
(complex64 products in another order); the adaptive estimator over 20
subframes from one state: `r3` within 1e-5, `ce` within 1e-4, noise, RSRP
and SNR within 1e-4 relative (the state feeds back through an 8x8 inverse
each subframe).  Plus the two Wiener cases of `tests/test_chest.py` on the
port, with their gates.  Inputs are numpy arrays made from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srsran_tpu.phy.chest.chest_dl as r_chest
import srsran_tpu.phy.chest.wiener_dl as r_wiener
from srsran_tpu.phy.chest.refsignal_dl import crs_positions, crs_sequence_port, put_crs_np
from srsran_tpu.phy.common import Cell
import srsran_tpu_torch.phy.chest.chest_dl as t_chest
import srsran_tpu_torch.phy.chest.wiener_dl as t_wiener
from srsran_tpu_torch.convert import from_reference, wiener_state_from_reference

torch.set_num_threads(1)

CPU = "cpu"


def cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)


@pytest.mark.parametrize("prb,ports,sf_idx,delay", [(6, 1, 0, 0.07), (25, 2, 5, 0.07), (50, 1, 3, 0.15)])
def test_wiener_matrices(prb, ports, sf_idx, delay):
    cell = Cell(nof_prb=prb, nof_ports=ports, id=11)
    cfg = r_chest.ChestDlConfig(algorithm="wiener", wiener_delay_spread=delay)
    for p in range(ports):
        want = r_chest._wiener_matrices(cell, cfg, p, sf_idx)
        got = t_chest._wiener_matrices(from_reference(cell), from_reference(cfg), p, sf_idx)
        assert got.dtype == np.complex64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("prb,ports,last", [(6, 1, None), (25, 2, None), (25, 1, 3), (15, 2, 10)])
def test_chest_dl_wiener_branch(prb, ports, last):
    cell = Cell(nof_prb=prb, nof_ports=ports, id=29)
    cfg = r_chest.ChestDlConfig(algorithm="wiener")
    grid = cplx(np.random.default_rng(prb + ports), (2, 14, prb * 12))
    ref = r_chest.chest_dl(jnp.asarray(grid), cell, 1, cfg, nof_ports=ports, last_symbol=last)
    got = t_chest.chest_dl(torch.from_numpy(grid), from_reference(cell), 1, from_reference(cfg),
                           nof_ports=ports, last_symbol=last)
    for key in ("ce", "noise", "rsrp", "snr"):
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-5, atol=1e-5)


def epa_grids(cell, n_sf: int, seed: int, snr_db: float = 15.0):
    """`n_sf` subframes of CRS through one static 4-tap channel with AWGN
    (tests/test_chest.py's adaptive case): (grids, the true channel)."""
    rng = np.random.default_rng(seed)
    nre = cell.nof_re_per_symbol
    taus = np.array([0.0, 0.018, 0.045, 0.075])
    gains = np.array([1.0, 0.7, 0.5, 0.3]) * np.exp(2j * np.pi * rng.random(4))
    h = (gains[None, :] * np.exp(-2j * np.pi * np.outer(np.arange(nre), taus))).sum(1)
    h = (h / np.sqrt(np.mean(np.abs(h) ** 2))).astype(np.complex64)
    syms, freqs = crs_positions(cell, 0)
    snr = 10 ** (snr_db / 10)
    grids = []
    for sf in range(n_sf):
        g = np.zeros((cell.nsymb_per_sf, nre), np.complex64)
        seq = crs_sequence_port(cell, sf % 10, 0)
        for s in range(len(syms)):
            g[syms[s], freqs[s]] = seq[s] * h[freqs[s]]
        g += cplx(rng, g.shape, np.sqrt(0.5 / snr))
        grids.append(g)
    return grids, h


def test_chest_dl_adaptive_twenty_subframes():
    """20 subframes from one state (the reference's `wiener_init` carried
    across by `wiener_state_from_reference`): the state and every estimate
    as the reference's."""
    cell = Cell(nof_prb=25, nof_ports=1, id=17)
    pcell = from_reference(cell)
    grids, _ = epa_grids(cell, 20, 3)
    r_state = r_wiener.wiener_init()
    t_state = wiener_state_from_reference(
        {k: np.asarray(v) for k, v in r_state.items()}, CPU)
    for sf, g in enumerate(grids):
        ref, r_state = r_wiener.chest_dl_adaptive(jnp.asarray(g), cell, sf % 10, r_state)
        got, t_state = t_wiener.chest_dl_adaptive(torch.from_numpy(g), pcell, sf % 10, t_state)
        np.testing.assert_allclose(t_state["r3"].numpy(), np.asarray(r_state["r3"]), rtol=0, atol=1e-5)
        assert float(t_state["count"]) == float(r_state["count"]) == sf + 1
        np.testing.assert_allclose(got["ce"].numpy(), np.asarray(ref["ce"]), rtol=0, atol=1e-4)
        for key in ("noise", "rsrp", "snr"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-4)


def test_adapted_state_crosses_from_the_reference():
    """A state the reference adapted over 6 subframes, taken onto the port,
    gives the reference's next estimate (2 ports, a batch of 2 antennas)."""
    cell = Cell(nof_prb=15, nof_ports=2, id=4)
    rng = np.random.default_rng(9)
    state = r_wiener.wiener_init()
    for sf in range(6):
        _, state = r_wiener.chest_dl_adaptive(jnp.asarray(cplx(rng, (2, 14, 180))), cell, sf, state)
    grid = cplx(rng, (2, 14, 180))
    ref, r_next = r_wiener.chest_dl_adaptive(jnp.asarray(grid), cell, 6, state)
    got, t_next = t_wiener.chest_dl_adaptive(
        torch.from_numpy(grid), from_reference(cell), 6,
        wiener_state_from_reference({k: np.asarray(v) for k, v in state.items()}, CPU))
    np.testing.assert_allclose(t_next["r3"].numpy(), np.asarray(r_next["r3"]), rtol=0, atol=1e-5)
    for key in ("ce", "noise", "rsrp", "snr"):
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4)


# --- tests/test_chest.py's Wiener cases on the port ---------------------------------


def test_chest_wiener_beats_linear_on_selective_channel():
    cell = from_reference(Cell(nof_prb=50, nof_ports=1, id=3))
    nre = cell.nof_re_per_symbol
    rng = np.random.default_rng(7)
    grid = np.zeros((1, cell.nsymb_per_sf, nre), np.complex64)
    put_crs_np(grid, Cell(nof_prb=50, nof_ports=1, id=3), 2)
    # dispersive channel with delays approaching the CP (72 samples @ 1024)
    taps = [(0, 1.0), (25, 0.6 * np.exp(1j)), (60, 0.4 * np.exp(-2j))]
    k = np.arange(nre)
    h = sum(a * np.exp(-2j * np.pi * k * d / cell.symbol_sz) for d, a in taps).astype(np.complex64)
    rx = grid[0] * h[None, :] + cplx(rng, grid[0].shape, 0.05)
    mses = {}
    for alg in ("interpolate", "wiener"):
        ce = t_chest.chest_dl(torch.from_numpy(rx), cell, 2, t_chest.ChestDlConfig(algorithm=alg))["ce"]
        mses[alg] = float(np.mean(np.abs(ce.numpy()[0] - h[None, :]) ** 2))
    assert mses["wiener"] < mses["interpolate"], mses
    assert mses["wiener"] < 0.01


def test_adaptive_wiener_tracks_measured_channel():
    cell_ref = Cell(nof_prb=50, nof_ports=1, id=17)
    cell = from_reference(cell_ref)
    grids, h = epa_grids(cell_ref, 10, 5)

    def mse(ce):
        return float(np.mean(np.abs(ce.numpy()[0] - h[None, :]) ** 2))

    state = t_wiener.wiener_init()
    for sf in range(8):
        res, state = t_wiener.chest_dl_adaptive(torch.from_numpy(grids[sf]), cell, sf % 10, state)
    grid9 = torch.from_numpy(grids[9])
    lin = mse(t_chest.chest_dl(grid9, cell, 9, t_chest.ChestDlConfig(algorithm="interpolate"))["ce"])
    fixed = mse(t_chest.chest_dl(grid9, cell, 9, t_chest.ChestDlConfig(algorithm="wiener"))["ce"])
    res, state = t_wiener.chest_dl_adaptive(grid9, cell, 9, state)
    adaptive = mse(res["ce"])
    assert adaptive < lin, (adaptive, lin)
    assert adaptive < 0.6 * fixed, (adaptive, fixed)
    assert adaptive < 0.03
    assert state["r3"].device.type == CPU and float(state["count"]) == 9
