"""eNB-side facades of the port."""
