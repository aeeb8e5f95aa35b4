from selfpose3d_tpu_torch.geometry.cameras import (
    CameraParams,
    affine_points,
    project_points,
    project_points_with_trans,
)
from selfpose3d_tpu_torch.geometry.grid import axis_offsets, compute_grid, grid_1d_axes
from selfpose3d_tpu_torch.geometry.transforms import (
    get_affine_transform,
    get_affine_transform_3x3,
    get_scale,
)

__all__ = [
    "CameraParams",
    "affine_points",
    "project_points",
    "project_points_with_trans",
    "axis_offsets",
    "compute_grid",
    "grid_1d_axes",
    "get_affine_transform",
    "get_affine_transform_3x3",
    "get_scale",
]
