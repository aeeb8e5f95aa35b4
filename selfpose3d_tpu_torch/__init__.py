"""selfpose3d_tpu_torch — the PyTorch/CUDA port of selfpose3d_tpu for one
NVIDIA H100.

It mirrors the JAX package's layout so each module's counterpart is easy
to find, and it imports nothing of JAX or of ``selfpose3d_tpu``:

  config.py   the same dataclass config schema (own copy)
  geometry/   camera projection, affine transforms, voxel grids
  data/       AugBranch batch structure, synthetic Panoptic-like scenes
  ops/        sampling (plain + hand-written CUDA kernels), unprojection,
              proposals, soft-argmax, Gaussian rendering
  models/     PoseResNet, V2VNet, RootNet, PoseNet, MultiPersonPoseNetSSV
  convert/    JAX parameter trees -> this package's state dicts
  csrc/       CUDA C++ sources, built with nvcc at first use

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from selfpose3d_tpu_torch.device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
