"""losses_ms.<suffix>: the device ms per call of the program's span
``sp3d.losses``, the loss terms after PoseNet: projections,
Gaussians, the Hungarian-matched L1 (``core/stages.py``)."""

from portbench.core import stages


def read(run):
    return stages.stage_ms(run, "sp3d.losses")
