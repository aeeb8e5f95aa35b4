"""attn_ms.<suffix>: the device ms per call of the program's span
``sp3d.attn``, the attention net on the augmented branches (``core/stages.py``)."""

from portbench.core import stages


def read(run):
    return stages.stage_ms(run, "sp3d.attn")
