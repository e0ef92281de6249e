"""Device selection for the port's entry points.

Every entry point takes `device`; None means the CUDA card. There is no
fallback: asking for CUDA where no card is present raises, and the CPU
runs only when the caller names it (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` (None, str or torch.device) -> torch.device, default cuda.
    Raises RuntimeError for a CUDA device when torch sees no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
