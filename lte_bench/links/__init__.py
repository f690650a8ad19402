"""One module per kind of link the benchmark drives, named by a
configuration's `link`.  Each gives:

- `build_entry(cfg, devices)`: the program's entry point for the
  configuration (imported only there), on the cell's devices, as
  fn(samples) -> a tuple of result tensors;
- `render(cfg, tb)`: the clean subframe from the benchmark's own
  transmitter;
- `reference(samples, cfg, precision)`: the plain reference receiver, with
  the results in the entry's form;
- `CHECKS`, `tally(results, cfg)` -> (units that pass, bits delivered) of
  one batch, and `judge(kept, pool, idx, sent, cfg)` -> the numbers
  compared, one per name of `CHECKS`, which the configuration's `limits`
  name too;
- `map_launch_shape(cfg, batch)`: code blocks and K of one MAP pass over a
  batch.
"""


def single(devices):
    """The one device of a link that runs on one card."""
    devices = list(devices)
    if len(devices) != 1:
        raise ValueError(f"this link runs on one device, not {len(devices)}")
    return devices[0]
