"""bn_folds.<suffix>: the eval BatchNorms per call that the program applied
in its convolution's epilogue pass, with the ReLU and sum that follow, by
its counter ``bn_folds`` (``core/stages.py``); none where the program keeps
no such counter. No convolution weight is folded: the BatchNorm's running
affine is applied to the convolution's output in that pass, and the name
counts the BatchNorms folded into the epilogue."""

from portbench.core import stages


def read(run):
    try:
        from selfpose3d_tpu_torch.utils import spans
    except ImportError:
        return None
    if "bn_folds" not in spans.counters():
        return None
    return stages.counted(run, "bn_folds")
