"""mfu.<suffix>: the convolutions' FLOPs of the measured window's calls (the
cell's shapes, ``core/flops.py``) over the window's time on the host clock,
as a share of the card's bf16 dense peak (%). Read in the traced run, from
its window, which no profiler records."""

from portbench.core import peaks, timeline


def read(run):
    if "trace" not in run:
        return None
    calls = run["calls"]
    return 100.0 * run["flops_per_call"] * len(calls) / (timeline.window_s(calls) * peaks.BF16_FLOPS)
