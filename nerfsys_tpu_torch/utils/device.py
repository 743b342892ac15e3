"""Device resolution for the port's entry points.

Entry points default to the card. Without a CUDA device they raise rather
than carry on quietly on the CPU; a caller that wants the CPU says so with
`device="cpu"` (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` (str or torch.device) -> torch.device, raising for a CUDA
    device when none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nerfsys_tpu_torch: no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch path on the CPU"
        )
    return dev
