"""Channel estimation (mirrors `srsran_tpu.phy.chest`)."""
