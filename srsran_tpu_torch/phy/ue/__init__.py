"""UE-side facades of the port."""
