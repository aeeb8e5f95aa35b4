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

from selfpose3d_tpu_torch.device import device_constant
from selfpose3d_tpu_torch.geometry.cameras import CameraParams, affine_points, project_points
from selfpose3d_tpu_torch.ops.gaussian import clip01
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

    scale_hm = device_constant([w / img_w, h / img_h], xy.dtype, xy.device)
    denom = device_constant([w - 1.0, h - 1.0], xy.dtype, xy.device)
    sample_grid = torch.clamp((xy * scale_hm) / denom * 2.0 - 1.0, -1.1, 1.1)
    return sample_grid, bounding


def to_pixels(sample_grid: torch.Tensor, heatmap_wh: Tuple[int, int]):
    """Align-corners denormalisation -> (px, py), each (..., N) contiguous."""
    W, H = heatmap_wh
    px = (sample_grid[..., 0] + 1.0) * 0.5 * (W - 1)
    py = (sample_grid[..., 1] + 1.0) * 0.5 * (H - 1)
    return px, py


def hflip_views(hflip: Optional[torch.Tensor], B: int, V: int) -> Optional[torch.Tensor]:
    """(B,) per-sample flip flags -> (B, V), one per view."""
    return None if hflip is None else hflip.reshape(-1, 1).expand(B, V)


def sample_views_bounded_mean(
    heatmaps: torch.Tensor, px: torch.Tensor, py: torch.Tensor, bounding: torch.Tensor
) -> torch.Tensor:
    """One ``sample_view`` launch per view, then the bounded mean across
    views in float32, nan -> 0, clipped to [0, 1]. Autograd reaches the
    heatmaps through ``sample_view``'s adjoint.

    heatmaps (B, V, H, W, J); px, py, bounding (B, V, N) -> (B, N, J).
    """
    wsum = None
    bsum = None
    for v in range(heatmaps.shape[1]):
        samp = sample_view(
            heatmaps[:, v].contiguous(), px[:, v].contiguous(), py[:, v].contiguous()
        )  # (B, N, J)
        term = samp * bounding[:, v, :, None]
        wsum = term if wsum is None else wsum + term
        bsum = bounding[:, v] if bsum is None else bsum + bounding[:, v]
    return clip01(torch.nan_to_num(wsum / (bsum[..., None] + 1e-6), nan=0.0))


def unproject_heatmaps(
    heatmaps: torch.Tensor,
    grid: torch.Tensor,
    cam: CameraParams,
    trans: torch.Tensor,
    image_wh: Tuple[int, int],
    orig_wh: torch.Tensor,
    cube_size: Sequence[int],
    hflip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Whole-space unprojection (RootNet): one ``sample_view`` launch per
    view, bounded mean across views in float32.

    Args:
      heatmaps: (B, V, H, W, J) float32.
      grid: (N, 3) voxel centers shared by the batch, or (B, N, 3).
      cam: CameraParams (B, V); trans (B, V, 3, 3); orig_wh (B, V, 2).
      cube_size: static (X, Y, Z), N = X*Y*Z.
      hflip: optional (B,) per-sample horizontal-flip flags.
    Returns:
      (B, X, Y, Z, J) float32.
    """
    B, V, H, W, J = heatmaps.shape
    if grid.dim() == 2:
        grid = grid[None]
    with torch.no_grad():  # coordinates carry no gradient
        sample_grid, bounding = compute_sample_grid(
            grid[:, None], cam, trans, image_wh, (W, H), orig_wh,
            hflip=hflip_views(hflip, B, V),
        )
        px, py = to_pixels(sample_grid, (W, H))  # (B, V, N)
    cubes = sample_views_bounded_mean(heatmaps, px, py, bounding)
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
    hflip: Optional[torch.Tensor] = None,
    differentiable: bool = False,
) -> torch.Tensor:
    """Per-candidate cube sampling (PoseNet).

    Inference: one ``sample_views_mean`` launch over all views and
    candidates. With ``differentiable`` (training): one ``sample_view``
    launch per view and the bounded mean in torch, so that autograd reaches
    the heatmaps through the sampler's adjoint kernel; the fused kernel has
    no backward, as in the JAX package.

    Args:
      heatmaps: (B, V, H, W, J) float32.
      grids: (B, M, 3) voxel centers, M = K*X*Y*Z, x-major within a cube.
      cam, trans, orig_wh: batched (B, V).
      out_dtype: output dtype (the model dtype).
      hflip: optional (B,) per-sample horizontal-flip flags.
    Returns:
      (B, M, J) in ``out_dtype`` == (B, K, X, Y, Z, J) flattened.
    """
    B, V, H, W, _ = heatmaps.shape
    with torch.no_grad():  # coordinates carry no gradient
        sample_grid, bounding = compute_sample_grid(
            grids[:, None], cam, trans, image_wh, (W, H), orig_wh,
            hflip=hflip_views(hflip, B, V),
        )
        px, py = to_pixels(sample_grid, (W, H))  # (B, V, M)
        del sample_grid  # (B, V, M, 2): free it before the kernel runs
    if differentiable:
        return sample_views_bounded_mean(heatmaps, px, py, bounding).to(out_dtype)
    return sample_views_mean(heatmaps.contiguous(), px, py, bounding, out_dtype)
