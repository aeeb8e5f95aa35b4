"""Multi-view unprojection: heatmaps -> voxel feature cubes
(ref: lib/models/project_layer.py:42-102).

  1. project every voxel center into every camera
  2. in-image bounding mask
  3. clamp -> image-space affine -> optional horizontal flip
  4. rescale to heatmap coords, normalise, clamp to +-1.1, denormalise
  5. bilinear-sample every view's heatmap (zero padding)   (CUDA kernels)
  6. bounded mean across views, nan -> 0, clamp to [0, 1]

Steps 1-4 keep the float sequence of ``selfpose3d_tpu.ops.unproject``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from selfpose3d_tpu_torch.geometry.cameras import CameraParams, affine_points, project_points
from selfpose3d_tpu_torch.ops.slicewarp import sample_view, sample_views_mean


def compute_sample_grid(
    grid: torch.Tensor,
    cam: CameraParams,
    trans: torch.Tensor,
    image_wh: Tuple[int, int],
    heatmap_wh: Tuple[int, int],
    orig_wh: torch.Tensor,
    hflip: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-view normalised sampling coords + in-image mask.

    Args:
      grid: (..., N, 3) voxel centers in world mm, broadcasting against the
        camera axes (typically (B, 1, N, 3) against cameras (B, V)).
      cam: CameraParams with leading axes (typically (B, V)).
      trans: (..., 2or3, 3) affine original image -> network input pixels.
      image_wh: static (W, H) of the network input.
      heatmap_wh: static (W, H) of the heatmaps.
      orig_wh: (..., 2) original image (width, height).
      hflip: optional (...,) flags; flip x in input-image space.
    Returns:
      sample_grid (..., N, 2) in [-1.1, 1.1]; bounding (..., N) float32.
    """
    w, h = heatmap_wh
    img_w, img_h = image_wh
    xy = project_points(grid, cam)  # (..., N, 2)

    width = orig_wh[..., 0:1]
    height = orig_wh[..., 1:2]
    bounding = (
        (xy[..., 0] >= 0) & (xy[..., 1] >= 0) & (xy[..., 0] < width) & (xy[..., 1] < height)
    ).to(torch.float32)

    max_dim = torch.maximum(width, height)[..., None]  # (..., 1, 1)
    xy = torch.minimum(torch.clamp(xy, min=-1.0), max_dim)
    xy = affine_points(xy, trans)

    if hflip is not None:
        flip = hflip.to(xy.dtype)[..., None]  # (..., 1)
        x = xy[..., 0]
        xy = torch.stack([flip * (img_w - x) + (1.0 - flip) * x, xy[..., 1]], dim=-1)

    scale_hm = torch.tensor([w / img_w, h / img_h], dtype=xy.dtype, device=xy.device)
    denom = torch.tensor([w - 1.0, h - 1.0], dtype=xy.dtype, device=xy.device)
    sample_grid = torch.clamp((xy * scale_hm) / denom * 2.0 - 1.0, -1.1, 1.1)
    return sample_grid, bounding


def to_pixels(sample_grid: torch.Tensor, heatmap_wh: Tuple[int, int]):
    """Align-corners denormalisation -> (px, py), each (..., N) contiguous."""
    W, H = heatmap_wh
    px = (sample_grid[..., 0] + 1.0) * 0.5 * (W - 1)
    py = (sample_grid[..., 1] + 1.0) * 0.5 * (H - 1)
    return px, py


def unproject_heatmaps(
    heatmaps: torch.Tensor,
    grid: torch.Tensor,
    cam: CameraParams,
    trans: torch.Tensor,
    image_wh: Tuple[int, int],
    orig_wh: torch.Tensor,
    cube_size: Sequence[int],
) -> torch.Tensor:
    """Whole-space unprojection (RootNet): one ``sample_view`` launch per
    view, bounded mean across views in float32.

    Args:
      heatmaps: (B, V, H, W, J) float32.
      grid: (N, 3) voxel centers shared by the batch, or (B, N, 3).
      cam: CameraParams (B, V); trans (B, V, 3, 3); orig_wh (B, V, 2).
      cube_size: static (X, Y, Z), N = X*Y*Z.
    Returns:
      (B, X, Y, Z, J) float32.
    """
    B, V, H, W, J = heatmaps.shape
    if grid.dim() == 2:
        grid = grid[None]
    sample_grid, bounding = compute_sample_grid(
        grid[:, None], cam, trans, image_wh, (W, H), orig_wh
    )
    px, py = to_pixels(sample_grid, (W, H))  # (B, V, N)
    wsum = None
    bsum = None
    for v in range(V):
        samp = sample_view(
            heatmaps[:, v].contiguous(), px[:, v].contiguous(), py[:, v].contiguous()
        )  # (B, N, J)
        term = samp * bounding[:, v, :, None]
        wsum = term if wsum is None else wsum + term
        bsum = bounding[:, v] if bsum is None else bsum + bounding[:, v]
    cubes = torch.nan_to_num(wsum / (bsum[..., None] + 1e-6), nan=0.0).clamp(0.0, 1.0)
    X, Y, Z = (int(s) for s in cube_size)
    return cubes.reshape(B, X, Y, Z, J)


def sample_cubes(
    heatmaps: torch.Tensor,
    grids: torch.Tensor,
    cam: CameraParams,
    trans: torch.Tensor,
    image_wh: Tuple[int, int],
    orig_wh: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-candidate cube sampling (PoseNet): one ``sample_views_mean``
    launch over all views and candidates.

    Args:
      heatmaps: (B, V, H, W, J) float32.
      grids: (B, M, 3) voxel centers, M = K*X*Y*Z, x-major within a cube.
      cam, trans, orig_wh: batched (B, V).
      out_dtype: output dtype (the model dtype).
    Returns:
      (B, M, J) in ``out_dtype`` == (B, K, X, Y, Z, J) flattened.
    """
    W, H = heatmaps.shape[3], heatmaps.shape[2]
    sample_grid, bounding = compute_sample_grid(
        grids[:, None], cam, trans, image_wh, (W, H), orig_wh
    )
    px, py = to_pixels(sample_grid, (W, H))  # (B, V, M)
    del sample_grid  # (B, V, M, 2): free it before the kernel runs
    return sample_views_mean(heatmaps.contiguous(), px, py, bounding, out_dtype)
