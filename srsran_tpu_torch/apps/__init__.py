"""In-process eNB and UE applications on the port."""
