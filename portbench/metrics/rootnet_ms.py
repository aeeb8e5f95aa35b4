"""rootnet_ms.<suffix>: the device ms per call of the program's span
``sp3d.rootnet``, each RootNet call: the unprojection, V2V and
proposals, and in training the synthetic pass (``core/stages.py``)."""

from portbench.core import stages


def read(run):
    return stages.stage_ms(run, "sp3d.rootnet")
