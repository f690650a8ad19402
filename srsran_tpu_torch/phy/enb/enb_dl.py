"""eNB downlink subframe schedule.

Counterpart of `DlSched` of `srsran_tpu/phy/enb/enb_dl.py`, the schedule that
`pipeline_ctrl.enb_ctrl_overlay` renders.  The facade that renders a whole
subframe on the host (`enb_dl_subframe`) is not ported yet.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DlSched:
    """One subframe's schedule (the FAPI-like pull result, mac get_dl_sched)."""

    cfi: int = 1
    # list of (dci_bits, rnti, agg_level, cce_start)
    dcis: list = dataclasses.field(default_factory=list)
    # list of (grant, tb_bits)
    grants: list = dataclasses.field(default_factory=list)
    # list of (group, n_seq, ack)
    phich: list = dataclasses.field(default_factory=list)
