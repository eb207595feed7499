"""Where the port runs: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  Asking for CUDA where there is none
    raises: the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless device='cpu' is passed, "
            "and torch.cuda.is_available() is False")
    return dev
