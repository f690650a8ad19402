"""Host runtime helpers of the port's apps."""
