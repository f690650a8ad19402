"""Synchronisation: PSS/SSS, CFO and the CRS cell validation (mirrors `srsran_tpu.phy.sync`)."""
