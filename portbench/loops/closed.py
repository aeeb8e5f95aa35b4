"""Closed loop: one client; the next call starts when the last has returned
(its outputs on the host). Runs for ``seconds`` (no call starts after
them) or for ``calls`` calls, from pool index ``start``."""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

from torch.profiler import record_function


def run(prog, seconds: Optional[float] = None, calls: Optional[int] = None, start: int = 0,
        keep: Optional[Callable] = None) -> List[Tuple[float, float, int]]:
    out: List[Tuple[float, float, int]] = []
    clock = time.perf_counter
    t0 = clock()
    i = 0
    while (calls is None or i < calls) and (seconds is None or not out or clock() - t0 < seconds):
        s = clock()
        with record_function("portbench.call"):
            result = prog.call(start + i)
        e = clock()
        out.append((s, e, prog.items_per_call))
        if keep is not None:
            keep(i, result)
        i += 1
    return out
