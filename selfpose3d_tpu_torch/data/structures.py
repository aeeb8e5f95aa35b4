"""Batch structure handed to the models (ref: lib/dataset/JointsDatasetSSV.py:615-640).

One augmentation branch of a multi-view batch as a dataclass of tensors,
with the layouts of ``selfpose3d_tpu.data.structures.AugBranch``:
  images      (B, V, H, W, 3)    views as an axis
  heatmaps    (B, V, Hh, Wh, J)  channel-minor
  joints      (B, V, P, J, 2)    padded to MAX_PEOPLE_NUM
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from selfpose3d_tpu_torch.geometry.cameras import CameraParams


@dataclass
class AugBranch:
    cam: CameraParams                                # batched (B, V)
    trans: torch.Tensor                              # (B, V, 3, 3) orig-image -> input
    orig_wh: torch.Tensor                            # (B, V, 2) original (width, height)
    hflip: torch.Tensor                              # (B,) bool
    views: Optional[torch.Tensor] = None             # (B, V, H, W, 3) or None
    input_heatmaps: Optional[torch.Tensor] = None    # (B, V, Hh, Wh, J)
    target_2d: Optional[torch.Tensor] = None         # (B, V, Hh, Wh, J)
    weights_2d: Optional[torch.Tensor] = None        # (B, V, J, 1)
    target_3d: Optional[torch.Tensor] = None         # (B, X, Y, Z)
    joints: Optional[torch.Tensor] = None            # (B, V, P, J, 2) pseudo 2D
    joints_vis: Optional[torch.Tensor] = None        # (B, V, P, J, 2)
    joints_3d: Optional[torch.Tensor] = None         # (B, P, J, 3)
    joints_3d_vis: Optional[torch.Tensor] = None     # (B, P, J, 3)
    roots_3d: Optional[torch.Tensor] = None          # (B, P, 3)
    num_person: Optional[torch.Tensor] = None        # (B,)

    @property
    def batch_size(self):
        return self.trans.shape[0]

    @property
    def num_views(self):
        return self.trans.shape[1]

    def to(self, device) -> "AugBranch":
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            moved[f.name] = None if v is None else v.to(device)
        return AugBranch(**moved)
