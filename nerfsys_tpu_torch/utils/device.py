"""Device resolution for the port's entry points, and the card's facts
that the kernels' launch plans use.

Entry points default to the card. Without a CUDA device they raise rather
than carry on quietly on the CPU; a caller that wants the CPU says so with
`device="cpu"` (the tests do).
"""
from __future__ import annotations

from typing import Dict

import torch

# Shared memory on an H100: what one block may opt into as dynamic shared
# memory (227 KB), and what one SM holds (228 KB, 1 KB of it reserved per
# resident block).
SMEM_BLOCK_BYTES = 232_448
SMEM_SM_BYTES = 233_472


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


def aligned(*tensors) -> bool:
    """Every tensor starts on a 16-byte boundary (the kernels' vector
    loads, stores and atomics); None counts as aligned."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


_NUM_SMS: Dict[int, int] = {}


def num_sms(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (asked once)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _NUM_SMS:
        _NUM_SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _NUM_SMS[idx]
