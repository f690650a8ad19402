"""LTE PHY layer of the PyTorch port (mirrors `srsran_tpu.phy`)."""
