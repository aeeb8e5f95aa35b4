"""optimizer_ms.<suffix>: the device ms per call of the program's span
``sp3d.optimizer``, the optimizer's update and the schedule's step (``core/stages.py``)."""

from portbench.core import stages


def read(run):
    return stages.stage_ms(run, "sp3d.optimizer")
