"""Gaussian heatmap rendering (ref: lib/models/multi_person_posenet_ssv.py:416-420).

The 2D Gaussian is factored into its separable 1-D components, so the
person-summed heatmap is one (H, P) @ (P, W) product per joint. Both
renderers are differentiable in the centres. 3D target cubes for the
synthetic-root training pass composite by max across persons.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def clip01(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 1): ``clamp``'s values with ``jnp.clip``'s gradient
    (one half exactly at a bound)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def render_gaussian_heatmaps(
    centers: torch.Tensor,
    heatmap_wh: Tuple[int, int],
    sigma: float = 3.0,
    coord_scale: float = 0.25,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum-composited 2D Gaussians, clipped to [0, 1].

    Args:
      centers: (..., P, J, 2) pixel coords (x, y) in image space.
      heatmap_wh: static (W, H).
      sigma: gaussian sigma in heatmap pixels.
      coord_scale: multiplied into coords before rendering (the stride).
      mask: optional (..., P) validity; invalid persons contribute nothing.
    Returns:
      (..., J, H, W) float32 heatmaps in [0, 1].
    """
    W, H = heatmap_wh
    x = centers[..., 0] * coord_scale  # (..., P, J)
    y = centers[..., 1] * coord_scale
    xs = torch.arange(W, dtype=torch.float32, device=centers.device)
    ys = torch.arange(H, dtype=torch.float32, device=centers.device)
    gx = torch.exp(-0.5 * ((xs - x[..., None]) / sigma) ** 2)  # (..., P, J, W)
    gy = torch.exp(-0.5 * ((ys - y[..., None]) / sigma) ** 2)  # (..., P, J, H)
    if mask is not None:
        gx = gx * mask[..., None, None]
    hm = torch.einsum("...pjh,...pjw->...jhw", gy, gx)
    return clip01(hm)


def render_gaussian_cube_3d(
    roots: torch.Tensor,
    grid_x: torch.Tensor,
    grid_y: torch.Tensor,
    grid_z: torch.Tensor,
    sigma: float = 200.0,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Max-composited 3D Gaussian target cube, truncated at 3 sigma per axis:
    voxels farther than 3 sigma from the center along any axis are exactly
    zero (ref: cuboid_proposal_net_soft.py:168-203).

    Args:
      roots: (..., P, 3) root positions in world mm.
      grid_x/y/z: (X,), (Y,), (Z,) world-coordinate axes.
      mask: optional (..., P) validity mask.
    Returns:
      (..., X, Y, Z) cube in [0, 1].
    """
    inv2s2 = 1.0 / (2.0 * sigma * sigma)

    def axis_terms(g, mu):
        d = g - mu[..., None]  # (..., P, A)
        return d * d, (d.abs() <= 3.0 * sigma).to(torch.float32)

    dx2, wx = axis_terms(grid_x, roots[..., 0])
    dy2, wy = axis_terms(grid_y, roots[..., 1])
    dz2, wz = axis_terms(grid_z, roots[..., 2])
    d2 = dx2[..., :, None, None] + dy2[..., None, :, None] + dz2[..., None, None, :]
    win = wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]
    g = torch.exp(-d2 * inv2s2) * win  # (..., P, X, Y, Z)
    if mask is not None:
        g = g * mask[..., None, None, None]
    return clip01(g.amax(dim=-4))
