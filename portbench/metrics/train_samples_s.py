"""train_samples_s: training samples over the whole window (all samples
over all the time from the first step's start to the last step's end)."""

from portbench.core import timeline


def read(run):
    return timeline.rate(run["calls"])
