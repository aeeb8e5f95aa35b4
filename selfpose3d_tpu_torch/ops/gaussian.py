"""Gaussian heatmap rendering (ref: lib/models/multi_person_posenet_ssv.py:416-420).

The 2D Gaussian is factored into its separable 1-D components, so the
person-summed heatmap is one (H, P) @ (P, W) product per joint.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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
    return torch.clamp(hm, 0.0, 1.0)
