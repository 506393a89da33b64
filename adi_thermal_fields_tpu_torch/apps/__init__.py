"""Engine and CLI apps (the WAAM flagship, the spiral tube, the single
track, the frame viewer, the inverse apps and the implementation
comparison)."""
import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on: the card unless the caller
    asks for the CPU.  Raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this machine; pass "
                           "--device cpu (device='cpu') to run the plain "
                           "versions on the CPU")
    return device
