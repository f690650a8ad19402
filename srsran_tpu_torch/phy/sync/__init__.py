"""Synchronisation signals (mirrors `srsran_tpu.phy.sync`; the transmit half so far)."""
