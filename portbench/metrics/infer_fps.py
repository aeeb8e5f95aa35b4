"""infer_fps: frame sets inferred over the whole window (all frames over
all the time from the first call's start to the last call's end)."""

from portbench.core import timeline


def read(run):
    return timeline.rate(run["calls"])
