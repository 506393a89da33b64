"""Engine and CLI apps (the WAAM flagship)."""
