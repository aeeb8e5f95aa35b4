"""Voxel-grid construction (ref: lib/models/project_layer.py:22-40).

X-major / Z-minor flattening (meshgrid 'ij'), the reference's order, so
proposal indices and soft-argmax expectations line up with checkpoints.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def grid_1d_axes(space_size, space_center, cube_size) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The three 1-D world-coordinate axes of a voxel grid (host numpy)."""
    return tuple(
        (
            np.linspace(-space_size[d] / 2, space_size[d] / 2, int(cube_size[d]))
            + space_center[d]
        ).astype(np.float32)
        for d in range(3)
    )


def axis_offsets(box_size, n_bins, device=None) -> Tuple[torch.Tensor, ...]:
    """Per-axis voxel-center offsets from the box center, float32."""
    return tuple(
        torch.linspace(
            -box_size[d] / 2, box_size[d] / 2, int(n_bins[d]),
            dtype=torch.float32, device=device,
        )
        for d in range(3)
    )


def compute_grid(box_size, box_center: torch.Tensor, n_bins) -> torch.Tensor:
    """Voxel-center world coordinates of boxes, x-major/z-minor.

    Args:
      box_size: static (3,) extent in mm.
      box_center: (..., 3) float32 center(s) in mm.
      n_bins: static (3,) voxel counts.
    Returns:
      (..., X*Y*Z, 3)
    """
    box_center = torch.as_tensor(box_center, dtype=torch.float32)
    gx, gy, gz = axis_offsets(box_size, n_bins, box_center.device)
    X, Y, Z = gx.numel(), gy.numel(), gz.numel()
    lead = box_center.shape[:-1]
    c = box_center.reshape(lead + (1, 1, 1, 3))
    pts = torch.stack(
        torch.broadcast_tensors(
            gx.view(X, 1, 1) + c[..., 0],
            gy.view(1, Y, 1) + c[..., 1],
            gz.view(1, 1, Z) + c[..., 2],
        ),
        dim=-1,
    )  # (..., X, Y, Z, 3)
    return pts.reshape(lead + (X * Y * Z, 3))
