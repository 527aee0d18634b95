"""Device selection shared by the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``.  Asking for
CUDA where there is none raises; nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    return dev
