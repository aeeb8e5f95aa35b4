"""backbone_ms.<suffix>: the device ms per call of the program's span
``sp3d.backbone``, the backbone's heatmaps of every view
(``backbone_heatmaps``) (``core/stages.py``)."""

from portbench.core import stages


def read(run):
    return stages.stage_ms(run, "sp3d.backbone")
