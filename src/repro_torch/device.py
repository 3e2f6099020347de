"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never falls back from one to the other."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and there is none (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
