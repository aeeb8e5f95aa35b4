"""backward_ms.<suffix>: the device ms per call of the program's span
``sp3d.backward``, the backward of the step's summed losses (``core/stages.py``)."""

from portbench.core import stages


def read(run):
    return stages.stage_ms(run, "sp3d.backward")
