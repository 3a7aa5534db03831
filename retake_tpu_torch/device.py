"""Device resolution for the port: explicit devices, no global default.

The main path runs on CUDA only. Asking for a CUDA device on a host without
one raises instead of continuing on the CPU; the CPU is used only when a
caller (the tests) names it.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` (str or torch.device) -> torch.device; raises for a CUDA
    device when CUDA is not available."""
    if device is None:
        raise ValueError("pass an explicit device ('cuda' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; the port's main path runs on CUDA only"
        )
    return dev
