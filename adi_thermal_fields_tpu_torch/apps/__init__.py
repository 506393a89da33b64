"""Engine and CLI apps (the WAAM flagship, the spiral tube, the single
track and the frame viewer)."""
