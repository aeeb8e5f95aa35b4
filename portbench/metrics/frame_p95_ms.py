"""frame_p95_ms: the 95th percentile over every call of the window of one
frame set's latency, from the copy of its inputs to its poses on the host."""

from portbench.core import timeline


def read(run):
    return timeline.percentile(timeline.latencies_ms(run["calls"]), 95)
