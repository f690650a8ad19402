"""Channel emulation: fading, AWGN, delay, high-speed-train Doppler, RLF."""
