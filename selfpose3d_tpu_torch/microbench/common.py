"""What the measurement probes share: the card line, the device rule and
CUDA-event timing (the counterpart of ``timeit`` in ``scripts/microbench.py``
and ``scripts/microbench_pallas_conv.py``)."""

from __future__ import annotations

import subprocess
from typing import Callable

import torch

from selfpose3d_tpu_torch.device import resolve_device


def card_line() -> str:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line (first card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sm_clock_max_mhz() -> float:
    """The first card's highest SM clock in MHz, as ``nvidia-smi
    --query-gpu=clocks.max.sm`` reports it (the clock of its published
    rates)."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(line)


def card(device="cuda") -> torch.device:
    """The probe's device: a CUDA device, or an error (a probe times the card
    and has no CPU mode)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probes time a CUDA device, not {dev}")
    return dev


# cycles the card spins before the timed calls (about 25 ms at 1.98 GHz)
QUEUE_AHEAD_CYCLES = 50_000_000


def cuda_ms(fn: Callable[[], object], iters: int, warmup: int = 2) -> float:
    """Mean device time of one call in ms: ``warmup`` calls, then CUDA events
    around ``iters`` calls. The card first spins for a while, so that the
    host enqueues the timed calls ahead of the device and the events time
    the device, not the host's launch overhead (for calls whose host side
    outlasts the spin, as the plain versions' op loops do, they time the
    host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
