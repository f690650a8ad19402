"""The control: the plain reference receiver put in the program's place
and computed in the precision below the one the configuration states
(its `control`: "tf32" or "bf16").  A run with it has to come out as not
correct; `tools/readings.py` reads its numbers on the chip, and the CPU
tests see it fail at a small size.  The benchmark's own runs never use it."""

from __future__ import annotations


def entry(precision: str):
    """An `entry` for `run.run_cell`: the reference at `precision`."""

    def build(cfg, link, _devices):
        return lambda samples: link.reference(samples, cfg, precision)

    return build
