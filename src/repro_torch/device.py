"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means CUDA.  Asking for CUDA on a host without it raises:
    an entry point never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
