"""selfpose3d_tpu_torch — the PyTorch/CUDA port of selfpose3d_tpu for one
NVIDIA H100.

It mirrors the JAX package's layout so each module's counterpart is easy
to find, and it imports nothing of JAX or of ``selfpose3d_tpu``:

  config.py   the same dataclass config schema (own copy)
  geometry/   camera projection, affine transforms, voxel grids
  data/       AugBranch batch structure, synthetic Panoptic-like scenes,
              the Panoptic, Panoptic-SSV and Shelf/Campus datasets, the
              synthetic-scene dataset, targets, RandAugment, the loader
  ops/        sampling (plain + hand-written CUDA kernels, forward and
              adjoint), unprojection, proposals and their GT matching,
              soft-argmax, Gaussian rendering, Hungarian matching
  models/     PoseResNet, attention net, V2VNet, RootNet, PoseNet,
              MultiPersonPoseNetSSV (inference, the SSV losses and the SSL
              stage flags), MultiPersonPoseNet (the supervised baseline)
  train/      train state (Adam/SGD, frozen sub-networks), LR schedule,
              the SSV and supervised train steps, the inference step and
              the SSV debug forward; the train and validation loops,
              checkpoints, the convergence harness
  eval/       the Panoptic AP/MPJPE and Shelf/Campus PCP protocols, tracking
  utils/      image decoding, PNG writing and the affine warp (no OpenCV),
              zip URIs, flips, debug dumps, meters, logging
  pseudo_labels/  the pseudo-label pipeline (s1-s8) with pluggable models
  cli/        train_3d, evaluate (validate_3d), visualize
  convert/    JAX parameter (or gradient) trees -> this package's state dicts
  microbench/ the measurement probes (3D conv, slice-warp variants,
              primitive rates), each with its CUDA kernel
  csrc/       CUDA C++ sources, built with nvcc at first use

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from selfpose3d_tpu_torch.device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
