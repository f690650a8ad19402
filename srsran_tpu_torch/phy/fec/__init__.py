"""Forward error correction (mirrors `srsran_tpu.phy.fec`)."""
