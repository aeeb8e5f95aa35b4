"""graph_replays.<suffix>: the stages per call that the program replays from
CUDA graphs, by its counters ``graphs.replays.<stage>`` (``core/stages.py``);
none where the program keeps no such counters."""

from portbench.core import stages


def read(run):
    try:
        from selfpose3d_tpu_torch.utils import spans
    except ImportError:
        return None
    if not any(k.startswith("graphs.replays.") for k in spans.counters()):
        return None
    return stages.counted(run, "graphs.replays.")
