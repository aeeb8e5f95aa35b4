"""Device selection shared by the port's entry points and kernel wrappers,
and the device copies of host constants."""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import torch

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


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


def device_constant(values: Sequence[float], dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    values, dtype and device and then shared: its blocking copy from the
    host happens at the first call alone, so later calls (and the CUDA
    graphs captured from them, ``utils/graphs.py``) make the host wait for
    nothing. The caller never writes into it."""
    values = [float(v) for v in values]
    key = (tuple(v.hex() for v in values), dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):  # usable outside inference mode too
            t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t
