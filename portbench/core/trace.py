"""Profiler arithmetic: the device's busy time, kernel times by name, and the
idle gaps by what the host was doing, from ``torch.profiler`` traces.

A traced run traces the same number of calls twice, after its measured
window. The first pass records the device alone (CUDA activity: kernels,
copies, fills), so that the host's operators are not slowed by being
recorded; its window runs from a fill launched once the device is idle to
a fill launched once the calls are done, and busy time, kernel times and
launch counts come from it. The second pass records the host too, inside
the harness's own ``portbench.window`` span, and names each idle gap by the
innermost host event open at its middle (a runtime call such as
``cudaStreamSynchronize``, an ``aten::`` operator, or one of the harness's
``portbench.*`` spans where the host ran Python between operators). Each
pass's calls are timed on the host clock, so that what the recording costs
(its stretch over the measured window's calls) is reported beside them.
Device operations leave out the user annotations that the profiler mirrors
onto the device.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import torch

WINDOW_SPAN = "portbench.window"
NAME_CHARS = 120  # a templated kernel's name is cut to its first characters


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that ``busy`` (merged, sorted) leaves free."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def host_at(points: List[float], host: List[Tuple[float, float, str]]) -> List[str]:
    """For each time in ``points`` (ascending), the innermost host event open
    then (the latest started among those not yet ended), by a sweep over
    ``host`` (start, end, name) sorted by start."""
    names, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        inner = next((ev for ev in reversed(stack) if ev[1] >= t), None)
        names.append(inner[2] if inner else "host (no event open)")
    return names


def summarize(device: List[Tuple[float, float, str]], host: List[Tuple[float, float, str]],
              window: Tuple[float, float], top: int = 10) -> Dict:
    """``device`` and ``host``: (start_us, end_us, name); ``window`` (start_us, end_us).

    Returns busy_s, window_s, kernels (launches of kernels in the window,
    copies and fills left out), seconds by device-op name, the sampler
    kernels' seconds, and the idle seconds by host activity."""
    lo, hi = window
    inside = [(s, e, n) for s, e, n in device if e > lo and s < hi]
    busy = union(clip([(s, e) for s, e, _ in inside], lo, hi))
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n in inside:
        by_name[n[:NAME_CHARS]] += (min(e, hi) - max(s, lo)) * 1e-6
    kernels = sum(1 for _, _, n in inside if not n.startswith(("Memcpy", "Memset")))
    free = gaps(busy, lo, hi)
    host_sorted = sorted((h for h in host if h[2] != WINDOW_SPAN), key=lambda h: (h[0], -h[1]))
    labels = host_at([(s + e) / 2 for s, e in free], host_sorted)
    idle: Dict[str, float] = defaultdict(float)
    for (s, e), name in zip(free, labels):
        idle[name] += (e - s) * 1e-6
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (hi - lo) * 1e-6,
        "kernels": kernels,
        "device_s_by_name": dict(by_name),
        "sampler_s": sum(v for k, v in by_name.items() if "sample_view" in k),
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:top],
    }


def _events(prof):
    """(device, host) spans (start_us, end_us, name) of a finished profile."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end, ev.name)
        if ev.device_type == DeviceType.CUDA:
            # the harness's own spans appear on the device's timeline too: no operation
            if not (getattr(ev, "is_user_annotation", False) or ev.name.startswith("portbench.")):
                device.append(span)
        elif ev.device_type == DeviceType.CPU:
            host.append(span)
    return device, host


def from_profiler(prof) -> Dict:
    """``summarize`` over a finished profile of host and device, inside its
    ``portbench.window`` span."""
    device, host = _events(prof)
    window = next((h[:2] for h in host if h[2] == WINDOW_SPAN), None)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    return summarize(device, host, window)


def marked(device: List[Tuple[float, float, str]]) -> Dict:
    """``summarize`` over a device-only trace whose first and last operations
    are the window's two marks: the window runs from the first mark's start
    to the last mark's end, and the marks themselves are no operation."""
    device = sorted(device)
    if len(device) < 2:
        raise RuntimeError("the device-only trace holds no marks")
    window = (device[0][0], max(e for _, e, _ in device))
    return summarize(device[1:-1], [], window)


def _calls_ms(calls) -> float:
    return 1e3 * sum(e - s for s, e, _ in calls) / len(calls)


def traced(prog, loop, device: torch.device, calls: int, start: int, window_calls) -> Dict:
    """The two passes over ``calls`` calls each, from pool index ``start``:
    the device-only pass's summary (where there is a device), the idle gaps
    named by the second pass, the number of calls a pass makes, and each
    pass's mean call time over the measured window's (``stretch``,
    ``named_stretch``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    out: Dict = {}
    if cuda:
        mark = torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mark.fill_(1.0)  # the window's start on the device's timeline
            timed = loop.run(prog, calls=calls, start=start)
            torch.cuda.synchronize(device)
            mark.fill_(2.0)  # its end
            torch.cuda.synchronize(device)
        out = marked(_events(prof)[0])
        out["stretch"] = _calls_ms(timed) / _calls_ms(window_calls)
        del prof
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            named = loop.run(prog, calls=calls, start=start + calls)
            if cuda:
                torch.cuda.synchronize(device)
    both = from_profiler(prof)
    if not cuda:  # no device: the host's pass stands for both
        out = dict(both)
    out["idle_gaps"] = both["idle_gaps"]
    out["named_stretch"] = _calls_ms(named) / _calls_ms(window_calls)
    out["calls"] = calls
    return out
