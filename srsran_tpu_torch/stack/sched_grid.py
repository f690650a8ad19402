"""Host copy of `srsran_tpu/stack/sched_grid.py`, held to it by `tests/test_torch_stack.py`.

PDCCH CCE allocation grid with CFI adaptation.

The reference resolves PDCCH collisions across UEs and the common
search space with an allocation tree per TTI and escalates the CFI when
the control region cannot host every needed DCI
(`srsenb/src/stack/mac/scheduler_grid.cc:154-165` alloc_dci / pdcch_grid).
This module is that role for the TPU stack: `PdcchGrid` tracks one TTI's
CCE occupancy and allocates collision-free candidates from the proper
search space (UE-specific Yk hash or the common space for SI-/P-/RA-RNTI
— TS 36.213 §9.1.1), and `min_cfi_for` dry-runs the allocation to find
the smallest CFI that fits a DCI demand list, the CFI-adaptation
decision the reference takes before building the subframe.
"""

from __future__ import annotations

from ..phy.common import Cell
from ..phy.phch.pdcch import nof_cce, search_space_candidates

# RNTIs that use the COMMON search space (TS 36.213 §9.1.1: SI-RNTI,
# P-RNTI, RA-RNTI — and any RNTI may fall back to it for DCI 1A/1C)
SIRNTI = 0xFFFF
PRNTI = 0xFFFE


def uses_common_space(rnti: int) -> bool:
    return rnti >= 0xFFF4 or rnti <= 0x0042  # SI/P or RA-RNTI range


class PdcchGrid:
    """One TTI's PDCCH occupancy (the alloc-tree role, flattened: the
    reference explores alternative placements via a tree of partial
    allocations; with first-fit over the candidate lists and a shared
    occupancy mask the result is equivalent for the sizes LTE allows —
    every candidate set is tried against the union of prior grants)."""

    def __init__(self, cell: Cell, sf_idx: int, cfi: int):
        self.cell = cell
        self.sf_idx = sf_idx
        self.cfi = cfi
        self.n_cce = nof_cce(cell, sf_idx, cfi)
        self.used: list[tuple[int, int]] = []  # (start, L)

    def _fits(self, start: int, lvl: int) -> bool:
        return all(start + lvl <= s or start >= s + l for s, l in self.used)

    def alloc(self, rnti: int, agg_levels=(4, 8, 2, 1)) -> tuple[int, int] | None:
        """First collision-free (agg, cce) for this RNTI's search space;
        common-space RNTIs draw from the common candidates (agg 4/8
        only, §9.1.1).  Returns None when the control region is full —
        the caller's cue to escalate the CFI or drop the grant."""
        common = uses_common_space(rnti)
        cands = search_space_candidates(rnti, self.sf_idx, self.n_cce,
                                        ue_specific=not common)
        for lvl in agg_levels:
            for start in cands.get(lvl, []):
                if self._fits(start, lvl):
                    self.used.append((start, lvl))
                    return lvl, start
        return None

    def release_last(self):
        self.used.pop()


def min_cfi_for(cell: Cell, sf_idx: int, demands: list[int],
                cfi_min: int = 1, cfi_max: int = 3) -> int:
    """Smallest CFI whose control region hosts a collision-free DCI for
    every RNTI in `demands` (dry-run allocation — the scheduler_grid.cc
    CFI-adaptation decision).  Returns cfi_max when even that cannot fit
    everything (callers then drop the excess grants, as the reference
    does when the alloc tree has no leaf)."""
    for cfi in range(cfi_min, cfi_max + 1):
        grid = PdcchGrid(cell, sf_idx, cfi)
        if all(grid.alloc(r) is not None for r in demands):
            return cfi
    return cfi_max
