"""RootNet: whole-space person localisation (ref: lib/models/cuboid_proposal_net_soft.py).

Unproject the root heatmaps over the capture space (one ``sample_view``
kernel launch per view), V2VNet, then 3D max-pool NMS + top-K proposals.
Inference only; the synthetic-root training pass is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from selfpose3d_tpu_torch.geometry.cameras import CameraParams
from selfpose3d_tpu_torch.geometry.grid import compute_grid
from selfpose3d_tpu_torch.models.v2v_net import V2VNet
from selfpose3d_tpu_torch.ops.proposal import proposals_soft
from selfpose3d_tpu_torch.ops.unproject import unproject_heatmaps


class RootNet(nn.Module):
    """Heatmaps (B, V, H, W, Jr) -> (root_cubes (B, X, Y, Z), grid_centers (B, K, 5))."""

    def __init__(
        self,
        space_size,
        space_center,
        cube_size,
        image_wh,
        in_channels: int = 1,
        max_people: int = 10,
        threshold: float = 0.3,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.space_size = tuple(float(s) for s in space_size)
        self.space_center = tuple(float(s) for s in space_center)
        self.cube_size = tuple(int(s) for s in cube_size)
        self.image_wh = tuple(image_wh)
        self.max_people = max_people
        self.threshold = threshold
        self.v2v_net = V2VNet(in_channels, 1, dtype=dtype)

    def unproject(self, heatmaps, cam, trans, orig_wh) -> torch.Tensor:
        grid = compute_grid(
            self.space_size,
            torch.tensor(self.space_center, dtype=torch.float32, device=heatmaps.device),
            self.cube_size,
        )
        return unproject_heatmaps(
            heatmaps, grid, cam, trans, self.image_wh, orig_wh, self.cube_size
        )

    def forward(
        self,
        heatmaps: torch.Tensor,
        cam: CameraParams,
        trans: torch.Tensor,
        orig_wh: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cubes = self.unproject(heatmaps, cam, trans, orig_wh)
        root_cubes = self.v2v_net(cubes)[..., 0]  # (B, X, Y, Z)
        grid_centers = proposals_soft(
            root_cubes, self.max_people, self.threshold,
            self.space_size, self.space_center, self.cube_size,
        )
        return root_cubes, grid_centers
