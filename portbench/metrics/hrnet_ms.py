"""hrnet_ms.<suffix>: the device ms per call of the program's span
``sp3d.hrnet``, s4's top-down network on the call's crops with the flip
test (``core/stages.py``)."""

from portbench.core import stages


def read(run):
    return stages.stage_ms(run, "sp3d.hrnet")
