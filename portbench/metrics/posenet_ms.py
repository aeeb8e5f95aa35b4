"""posenet_ms.<suffix>: the device ms per call of the program's span
``sp3d.posenet``, each PoseNet call: the cubes' sampling, V2V and
soft-argmax (``core/stages.py``)."""

from portbench.core import stages


def read(run):
    return stages.stage_ms(run, "sp3d.posenet")
