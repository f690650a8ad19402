"""Host copy of `srsran_tpu/io/filesource.py`, held to it by `tests/test_torch_stack.py`.

I/Q file capture and replay (re-design of `lib/src/phy/io/filesource.c`,
`filesink.c`, `binsource.c`).

File format matches the reference's SRSLTE_COMPLEX_FLOAT_BIN: raw
interleaved little-endian float32 I/Q — so captures recorded with the
reference tools replay here directly (the record-replay mechanism of
SURVEY §5.4).
"""

from __future__ import annotations

import numpy as np


class FileSource:
    """Replay complex64 samples from a raw cf32 file."""

    def __init__(self, path: str, repeat: bool = False):
        self.path = path
        self.repeat = repeat
        self._data = np.fromfile(path, dtype=np.complex64)
        self._pos = 0

    def __len__(self) -> int:
        return len(self._data)

    def read(self, nsamples: int) -> np.ndarray:
        out = np.zeros(nsamples, np.complex64)
        n = 0
        while n < nsamples:
            take = min(nsamples - n, len(self._data) - self._pos)
            if take <= 0:
                if not self.repeat:
                    break
                self._pos = 0
                continue
            out[n : n + take] = self._data[self._pos : self._pos + take]
            self._pos += take
            n += take
        return out[:n] if n < nsamples and not self.repeat else out

    def seek(self, pos: int):
        self._pos = pos % max(len(self._data), 1)


class FileSink:
    """Append complex64 samples to a raw cf32 file."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, samples: np.ndarray):
        np.asarray(samples, np.complex64).tofile(self._f)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def binsource(seed: int, nbits: int) -> np.ndarray:
    """Pseudorandom bit source (`binsource.c`)."""
    return np.random.default_rng(seed).integers(0, 2, nbits).astype(np.uint8)
