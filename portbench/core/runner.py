"""One run of a cell: set-up, the measured window (and in a traced run the
traced calls after it), the check against the reference, the metrics. Device-agnostic, so that the tests can
drive it on the CPU at a small size; ``run.py`` adds the card's checks."""

from __future__ import annotations

import gc
import random
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from portbench.core import compare, spec
from portbench.core import trace as tracing
from portbench.reference.config import RefConfig, ref_config


@dataclass
class Ctx:
    workload: str
    seed: int
    device: torch.device
    cell: dict
    traffic: dict
    yaml: dict
    ref_cfg: RefConfig
    prog_cfg: Any


def make_ctx(workload: str, seed: int, device, cell: dict, traffic: dict,
             yaml: Optional[dict] = None) -> Ctx:
    from selfpose3d_tpu_torch.config import load_config

    yaml = spec.cell_yaml(cell) if yaml is None else yaml
    return Ctx(workload, int(seed), torch.device(device), cell, traffic, yaml,
               ref_config(yaml), load_config(overrides=yaml))


class Reservoir:
    """A uniform sample of ``k`` of the window's call results, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed), []

    def offer(self, i: int, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randint(0, i)
            if j < self.k:
                self.items[j] = item


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def run(ctx: Ctx, seconds: float, trace: bool, t_start: float, program=None) -> Dict:
    """-> {"setup_s", "calls", "numbers", "correct", "memory_peak_bytes",
    "peak_window_bytes", "trace" (traced runs), "flops_per_call",
    "sampler_bytes_per_call", "items_per_call"}. ``program`` replaces the
    cell's entry (the tests' planted faults).

    Every run measures its window of ``seconds``; a traced run then traces
    the traffic's ``trace_calls`` calls in each of ``core/trace.py``'s two
    passes, after the window, so that the window is never recorded."""
    entry = spec.entry(ctx.cell["entry"])
    prog = (program or entry.Program)(ctx)
    _sync(ctx.device)
    setup_s = time.perf_counter() - t_start
    peak_setup = _peak(ctx.device)
    loop = spec.loop(ctx.traffic["loop"])
    keeper = Reservoir(ctx.traffic.get("check_calls", 1), ctx.seed)
    start = compare.STEPS if ctx.traffic.get("task") == "train" else 0
    out: Dict[str, Any] = {"setup_s": setup_s, "items_per_call": prog.items_per_call,
                           "flops_per_call": prog.flops_per_call(),
                           "sampler_bytes_per_call": prog.sampler_bytes_per_call()}
    from selfpose3d_tpu_torch.ops import slicewarp  # the program's launch counter

    slicewarp.reset_launches()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    calls = loop.run(prog, seconds=seconds, start=start, keep=keeper.offer)
    _sync(ctx.device)
    out["calls"] = calls
    out["sampler_launches_per_call"] = {k: v / len(calls) for k, v in slicewarp.LAUNCHES.items()}
    out["peak_window_bytes"] = _peak(ctx.device)
    if trace:
        out["trace"] = tracing.traced(prog, loop, ctx.device, ctx.traffic["trace_calls"],
                                      start + len(calls), calls)
    out["memory_peak_bytes"] = max(peak_setup, _peak(ctx.device))
    kept = list(keeper.items)
    prog.release()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["numbers"] = prog.check(kept)
    out["check_s"] = time.perf_counter() - t0
    out["correct"] = compare.verdict(out["numbers"], ctx.cell["limits"])
    return out


def metric_values(run_out: Dict, metrics: List[dict]) -> Dict[str, dict]:
    """Each listed metric's reader over the run; a reader that finds nothing
    to read returns None and the metric is left out."""
    values = {}
    for m in metrics:
        v = spec.metric(m["name"]).read(run_out)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    return values
