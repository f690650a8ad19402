"""The LTE example scripts of the repo's `examples/` on the port.

Each is `python -m srsran_tpu_torch.examples.<name>` with the reference
script's arguments, plus `--device` (the card by default; raises where
there is none) and `--seed` where it draws noise (numpy), and a
`main(argv=None)` that returns the exit code:

- `pdsch_enodeb`: DL frames with PSS/SSS/PBCH/CRS and a full-band PDSCH a
  subframe, to a cf32 file or UDP;
- `cell_search`: PSS/SSS cell search and MIB decode of a capture;
- `pdsch_ue`: cell search, MIB, then PDSCH every subframe of a capture;
- `synch_file`: PSS correlation per frame of a capture;
- `remote_rx`: record or relay I/Q from UDP or the ZMQ fake RF;
- `bler_sweep`: PDSCH BLER and goodput over an SNR range;
- `dynamic_grants`: a random grant mix through `DynamicUeDl` (or
  `WindowedUeDl` with `--window`);
- `windowed_link`: the four windowed engines closing a DL and UL link.
"""
