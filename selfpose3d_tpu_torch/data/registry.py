"""Dataset registry (ref: tools/train_3d.py:93, an eval() of the name): every
name the JAX package's registry knows."""

from __future__ import annotations

from selfpose3d_tpu_torch.config import Config


def get_dataset(cfg: Config, name: str, image_set: str, is_train: bool):
    """The dataset ``name`` (DATASET.TRAIN_DATASET / TEST_DATASET)."""
    if name == "panoptic":
        from selfpose3d_tpu_torch.data.panoptic import PanopticDataset

        return PanopticDataset(cfg, image_set, is_train)
    if name == "panoptic_ssv":
        from selfpose3d_tpu_torch.data.panoptic_ssv import PanopticSSVDataset

        return PanopticSSVDataset(cfg, image_set, is_train)
    if name in ("shelf", "campus"):
        from selfpose3d_tpu_torch.data.shelf_campus import ShelfCampusDataset

        return ShelfCampusDataset(cfg, name, image_set, is_train)
    if name in ("shelf_ssv", "campus_ssv"):
        from selfpose3d_tpu_torch.data.panoptic_ssv import ShelfCampusSSVDataset

        return ShelfCampusSSVDataset(cfg, name.split("_")[0], image_set, is_train)
    if name in ("shelf_synthetic", "campus_synthetic"):
        from selfpose3d_tpu_torch.data.shelf_campus import SyntheticPoseDataset

        return SyntheticPoseDataset(cfg, name.split("_")[0], image_set, is_train)
    if name == "synthetic":
        from selfpose3d_tpu_torch.data.synthetic_dataset import SyntheticSceneDataset

        return SyntheticSceneDataset(cfg, image_set, is_train)
    raise KeyError(f"unknown dataset {name!r}")
