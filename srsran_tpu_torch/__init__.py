"""srsran_tpu_torch — the PyTorch/CUDA port of `srsran_tpu`.

The package mirrors the JAX reference module for module
(`srsran_tpu_torch/phy/ofdm.py` is the counterpart of
`srsran_tpu/phy/ofdm.py`).  Device code is torch; the windowed
max-log-MAP pass is a hand-written CUDA kernel for Hopper
(`csrc/map_window.cu`).  Host tables are numpy copies of the reference's
functions: importing the reference would import jax, and this package never
does.
"""

__version__ = "0.1.0"
