"""host_syncs.<suffix>: the times per call that the program makes the host
wait for the device, by its counters ``host_syncs.<site>``: reads of device
values and blocking copies of host values to the device (``core/stages.py``)."""

from portbench.core import stages


def read(run):
    return stages.counted(run, "host_syncs.")
