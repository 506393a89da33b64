"""Engine and CLI apps (the WAAM flagship and the spiral tube)."""
