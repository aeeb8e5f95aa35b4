"""Dataset registry (ref: tools/train_3d.py:93, an eval() of the name)."""

from __future__ import annotations

from selfpose3d_tpu_torch.config import Config
from selfpose3d_tpu_torch.data.synthetic_dataset import SyntheticSceneDataset

# the JAX package's real-data datasets, not yet ported
REAL_DATA = ("panoptic", "panoptic_ssv", "shelf", "campus", "shelf_ssv", "campus_ssv",
             "shelf_synthetic", "campus_synthetic")


def get_dataset(cfg: Config, name: str, image_set: str, is_train: bool):
    """The dataset ``name`` (DATASET.TRAIN_DATASET / TEST_DATASET). Only
    ``synthetic`` is ported; the real-data datasets raise
    ``NotImplementedError`` (ROADMAP Queue A item 11)."""
    if name == "synthetic":
        return SyntheticSceneDataset(cfg, image_set, is_train)
    if name in REAL_DATA:
        raise NotImplementedError(
            f"dataset {name!r} is not ported to selfpose3d_tpu_torch yet (ROADMAP "
            "Queue A item 11, the host side for real data); use 'synthetic'"
        )
    raise KeyError(f"unknown dataset {name!r}")
