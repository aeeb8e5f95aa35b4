from selfpose3d_tpu_torch.data.loader import PrefetchLoader, collate_branch
from selfpose3d_tpu_torch.data.registry import get_dataset
from selfpose3d_tpu_torch.data.structures import AugBranch
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
from selfpose3d_tpu_torch.data.synthetic_dataset import SyntheticSceneDataset

__all__ = ["AugBranch", "PrefetchLoader", "SyntheticSceneDataset", "collate_branch",
           "get_dataset", "make_synthetic_branch"]
