"""Host-side stack code of the port's apps (copies of the reference's)."""
