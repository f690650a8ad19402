"""Physical channels (mirrors `srsran_tpu.phy.phch`)."""
