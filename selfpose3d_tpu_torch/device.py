"""Device selection shared by the port's entry points and kernel wrappers."""

from __future__ import annotations

from typing import Iterable

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises rather than falling back to
    the CPU when a CUDA device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def kernel_route(tensors: Iterable[torch.Tensor]) -> bool:
    """True for a kernel (all CUDA, contiguous, one device), False for the
    plain version (all CPU); raises on anything else. A wrapper never falls
    back from the kernel to the plain version."""
    tensors = tuple(tensors)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    return True
