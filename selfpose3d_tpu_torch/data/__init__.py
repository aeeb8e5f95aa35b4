from selfpose3d_tpu_torch.data.structures import AugBranch
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch

__all__ = ["AugBranch", "make_synthetic_branch"]
