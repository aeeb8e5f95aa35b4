"""crops_ms.<suffix>: the device ms per call of the program's span
``sp3d.crops``, s4's copies of the frames and boxes to the device and the
crops cut from them there (``core/stages.py``)."""

from portbench.core import stages


def read(run):
    return stages.stage_ms(run, "sp3d.crops")
