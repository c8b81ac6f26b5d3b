"""Device selection: the port runs on the GPU unless told otherwise."""

import torch


def resolve_device(device=None) -> torch.device:
    """`device` (None means "cuda") as a torch.device. A CUDA device with no
    GPU present raises: the port never carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available. Pass device='cpu' explicitly to "
            "run the plain PyTorch path on the CPU."
        )
    return dev
