"""Host copy of `srsran_tpu/io/radio.py`, held to it by `tests/test_torch_stack.py`.

Radio abstraction: timestamped TX alignment + carrier→channel mapping
(re-design of `lib/src/radio/radio.cc` and `channel_mapping.cc`).

The reference radio sits between the PHY workers and the RF driver and
owns three behaviors this module reproduces over sample sinks/sources
(UDP links, files, rings — the "RF device" of this framework):

* **TX timestamp alignment** (`radio.cc:470-560` tx_dev): each `tx()`
  carries a timestamp.  If it overlaps the end of the previous burst the
  leading samples are trimmed; if it leaves a gap shorter than
  `tx_max_gap` seconds the gap is filled with zeros; a larger gap ends
  the burst (the receiver sees silence).
* **Carrier→channel mapping** (`channel_mapping.cc`): logical carriers
  are allocated to physical device channels by center frequency;
  `allocate_freq`/`release_freq`/`get_device_mapping`.
* **Sample-rate bookkeeping**: timestamps are converted to sample counts
  at the current TX/RX rate; `rx_now` returns samples with the timestamp
  of their first sample.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class _Writable:
    """Anything with .write(np.ndarray complex64)."""


@dataclasses.dataclass
class _ChannelState:
    sink: object  # .write(samples)
    end_of_burst: float = 0.0  # seconds
    in_burst: bool = False


class ChannelMapping:
    """Logical carrier → device channel allocation by frequency
    (channel_mapping.cc:34-80)."""

    def __init__(self, nof_channels: int):
        self.nof_channels = nof_channels
        self.alloc: dict[int, tuple[int, float]] = {}  # logical -> (ch, freq)

    def allocate_freq(self, logical_ch: int, freq_hz: float) -> bool:
        if logical_ch in self.alloc:
            self.alloc[logical_ch] = (self.alloc[logical_ch][0], freq_hz)
            return True
        used = {ch for ch, _ in self.alloc.values()}
        for ch in range(self.nof_channels):
            if ch not in used:
                self.alloc[logical_ch] = (ch, freq_hz)
                return True
        return False

    def release_freq(self, logical_ch: int) -> bool:
        return self.alloc.pop(logical_ch, None) is not None

    def get_device_mapping(self, logical_ch: int) -> int:
        """Physical channel index, or -1 if unallocated."""
        return self.alloc.get(logical_ch, (-1, 0.0))[0]

    def is_allocated(self, logical_ch: int) -> bool:
        return logical_ch in self.alloc


class Radio:
    """Timestamp-aligned multi-channel transmitter/receiver.

    `sinks` is one writable per physical channel; `source` (optional) is a
    readable (`.read(n)`) for `rx_now`.  `tx_max_gap` mirrors the
    reference's `tx_max_gap_zeros` default (stop the burst rather than
    transmit very long zero runs)."""

    SF_LEN_MAX = 30720 * 10

    def __init__(self, sinks, source=None, srate_hz: float = 1.92e6, tx_max_gap: float = 0.1):
        if not isinstance(sinks, (list, tuple)):
            sinks = [sinks]
        self.channels = [_ChannelState(sink=s) for s in sinks]
        self.source = source
        self.tx_srate = float(srate_hz)
        self.rx_srate = float(srate_hz)
        self.tx_max_gap = tx_max_gap
        self.mapping = ChannelMapping(len(self.channels))
        self.rx_time = 0.0
        self.stats = {"trimmed": 0, "gap_zeros": 0, "burst_ends": 0, "late": 0}

    # --- config ---
    def set_tx_srate(self, srate_hz: float):
        self.tx_srate = float(srate_hz)

    def set_rx_srate(self, srate_hz: float):
        self.rx_srate = float(srate_hz)

    # --- TX path ---
    def tx(self, samples: np.ndarray, timestamp: float, logical_ch: int = 0) -> bool:
        """Transmit `samples` so their first sample airs at `timestamp`
        seconds.  Applies the reference's overlap-trim / zero-gap-fill /
        burst-end policy (radio.cc:489-545)."""
        ch_idx = self.mapping.get_device_mapping(logical_ch) if self.mapping.alloc else logical_ch
        if ch_idx < 0 or ch_idx >= len(self.channels):
            return False
        ch = self.channels[ch_idx]
        samples = np.asarray(samples, np.complex64)
        n = len(samples)
        offset = 0

        if ch.in_burst:
            past = int(round((ch.end_of_burst - timestamp) * self.tx_srate))
            if past > 0:
                # overlaps the previous transmission: trim the leading part
                if n <= past:
                    self.stats["late"] += 1
                    return True  # entirely in the past — drop
                offset = past
                timestamp = ch.end_of_burst
                n -= past
                self.stats["trimmed"] += past
            elif past < 0:
                gap = -past
                if gap / self.tx_srate > self.tx_max_gap:
                    self.tx_end(ch_idx)  # too long: end the burst
                else:
                    # fill with zeros in SF_LEN_MAX slices
                    self.stats["gap_zeros"] += gap
                    while gap > 0:
                        nz = min(gap, self.SF_LEN_MAX)
                        ch.sink.write(np.zeros(nz, np.complex64))
                        gap -= nz
                        ch.end_of_burst += nz / self.tx_srate
        ch.sink.write(samples[offset:])
        ch.end_of_burst = timestamp + n / self.tx_srate
        ch.in_burst = True
        return True

    def tx_end(self, ch_idx: int | None = None):
        for ch in self.channels if ch_idx is None else [self.channels[ch_idx]]:
            ch.in_burst = False
            self.stats["burst_ends"] += 1

    # --- RX path ---
    def rx_now(self, nsamples: int) -> tuple[np.ndarray, float]:
        """Blocking read of `nsamples`; returns (samples, timestamp of the
        first sample)."""
        ts = self.rx_time
        out = self.source.read(nsamples)
        self.rx_time += len(out) / self.rx_srate
        return out, ts
