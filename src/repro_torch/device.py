"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default ``device=None`` means ``"cuda"``, and a CUDA request on a machine
without a usable card raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for (or
    defaulted to) and torch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; "
                         "expected 'cuda' or 'cpu'")
    return dev
