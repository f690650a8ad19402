"""Automatic gain control — 3-state FSM (init / measure / hold).

Host copy of `srsran_tpu/phy/agc.py` (`lib/src/phy/agc/agc.c`, FSM at
agc.h:48-60).  Control flow on the host: one power reading per call, read
back as a float when the samples are a tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Agc:
    target: float = 0.3  # target RMS amplitude
    max_gain_db: float = 90.0
    min_gain_db: float = 0.0
    gain_db: float = 30.0
    bandwidth: float = 0.7
    state: str = "INIT"  # INIT → MEASURE → HOLD
    hold_cnt: int = 0
    set_gain_callback: object = None

    def process(self, samples) -> float:
        """Measure one block of samples (numpy or a tensor), update the gain;
        returns the linear gain to apply."""
        if isinstance(samples, torch.Tensor):
            rms = float(torch.sqrt(torch.mean(torch.abs(samples) ** 2))) + 1e-12
        else:
            rms = float(np.sqrt(np.mean(np.abs(samples) ** 2))) + 1e-12
        err_db = 20.0 * np.log10(self.target / rms)
        if self.state == "INIT":
            self.gain_db += err_db  # jump straight to target
            self.state = "MEASURE"
        elif self.state == "MEASURE":
            self.gain_db += self.bandwidth * err_db
            if abs(err_db) < 1.0:
                self.state = "HOLD"
                self.hold_cnt = 0
        else:  # HOLD: only react to large deviations (e.g. after re-tune)
            if abs(err_db) > 6.0:
                self.state = "MEASURE"
        self.gain_db = float(np.clip(self.gain_db, self.min_gain_db, self.max_gain_db))
        if self.set_gain_callback is not None:
            self.set_gain_callback(self.gain_db)
        return 10.0 ** (self.gain_db / 20.0)
