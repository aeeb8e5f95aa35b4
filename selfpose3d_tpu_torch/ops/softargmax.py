"""Soft-argmax over voxel grids (ref: lib/models/pose_regression_net.py:14-28)."""

from __future__ import annotations

import torch


def soft_argmax(x: torch.Tensor, grids: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """Channel-major soft-argmax (the JAX package's ``soft_argmax``).

    Args:
      x: (..., J, N) per-joint voxel scores (N = X*Y*Z flattened).
      grids: (..., N, 3) world coordinates of each voxel, shared by the joints.
      beta: softmax temperature.
    Returns:
      (..., J, 3) expected world position per joint, float32.
    """
    w = torch.softmax(beta * x.to(torch.float32), dim=-1)
    return w @ grids.to(torch.float32)


def soft_argmax_ndhwc(x: torch.Tensor, axes, beta: float = 100.0) -> torch.Tensor:
    """Separable soft-argmax over a (B, X, Y, Z, J) score volume, float32.

    softmax(beta * x) over the voxels, then the expected world position;
    the grid is axis-separable, so E[g] is three marginal expectations.

    Args:
      x: (B, X, Y, Z, J) scores.
      axes: (gx (B, X), gy (B, Y), gz (B, Z)) world-coordinate axes.
      beta: softmax temperature.
    Returns:
      (B, J, 3) expected world position per joint.
    """
    gx, gy, gz = (a.to(torch.float32) for a in axes)
    xf = beta * x.to(torch.float32)
    m = torch.amax(xf, dim=(1, 2, 3), keepdim=True)
    e = torch.exp(xf - m)  # (B, X, Y, Z, J)
    s = e.sum(dim=(1, 2, 3))  # (B, J)
    ex = (e.sum(dim=(2, 3)) * gx[..., None]).sum(1)
    ey = (e.sum(dim=(1, 3)) * gy[..., None]).sum(1)
    ez = (e.sum(dim=(1, 2)) * gz[..., None]).sum(1)
    return torch.stack([ex, ey, ez], dim=-1) / s[..., None]
