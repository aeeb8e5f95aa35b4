"""Camera projection, voxel grids and Gaussian rendering in plain PyTorch.

The reference's own geometry, written from the published SelfPose3d and
VoxelPose code (lib/utils/cameras.py, lib/models/project_layer.py,
lib/models/multi_person_posenet_ssv.py):
  x_cam = R (x - T); y = x_cam[:2] / (x_cam[2] + 1e-5); radial and
  tangential distortion; pix = f * y + c; then the 2x3 image affine.
Sampling grids are normalised for ``F.grid_sample(align_corners=True)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def project(x: torch.Tensor, cam: dict) -> torch.Tensor:
    """World points (..., N, 3) -> pixels (..., N, 2); cam tensors broadcast
    over the leading axes: R (..., 3, 3), T (..., 3, 1), f, c (..., 2), k (..., 3), p (..., 2)."""
    d = x - cam["T"].transpose(-1, -2)
    xc = d @ cam["R"].transpose(-1, -2)
    z = xc[..., 2] + 1e-5
    y0, y1 = xc[..., 0] / z, xc[..., 1] / z
    r2 = torch.clamp(y0 * y0 + y1 * y1, max=1e10)
    k, p = cam["k"], cam["p"]
    radial = 1 + k[..., 0:1] * r2 + k[..., 1:2] * r2 ** 2 + k[..., 2:3] * r2 ** 3
    corr = radial + 2 * (p[..., 0:1] * y1 + p[..., 1:2] * y0)
    u = y0 * corr + p[..., 1:2] * r2
    v = y1 * corr + p[..., 0:1] * r2
    f, c = cam["f"], cam["c"]
    return torch.stack([f[..., 0:1] * u + c[..., 0:1], f[..., 1:2] * v + c[..., 1:2]], -1)


def affine(xy: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) through the (..., 3, 3) homogeneous affine."""
    return xy @ trans[..., :2, :2].transpose(-1, -2) + trans[..., None, :2, 2]


def grid_axes(size, n, device=None):
    """Per-axis voxel-centre offsets from a box's centre (linspace over the extent)."""
    return [torch.linspace(-size[d] / 2, size[d] / 2, int(n[d]), dtype=torch.float32,
                           device=device) for d in range(3)]


def voxel_centres(size, center: torch.Tensor, n) -> torch.Tensor:
    """(..., 3) box centres -> (..., X*Y*Z, 3) voxel centres, x-major."""
    gx, gy, gz = grid_axes(size, n, device=center.device)
    g = torch.stack(torch.meshgrid(gx, gy, gz, indexing="ij"), -1).reshape(-1, 3)
    return center[..., None, :] + g


def sample_grid(points, cam, trans, image_wh, heatmap_wh, orig_wh, hflip=None):
    """Voxel centres (B, 1, N, 3) -> normalised grid (B, V, N, 2) and the
    in-image mask (B, V, N), as the published ProjectLayer computes them."""
    xy = project(points, cam)
    w, h = orig_wh[..., 0:1], orig_wh[..., 1:2]
    inside = ((xy[..., 0] >= 0) & (xy[..., 1] >= 0) & (xy[..., 0] < w) & (xy[..., 1] < h)).float()
    xy = torch.minimum(xy.clamp(min=-1.0), torch.maximum(w, h)[..., None])
    xy = affine(xy, trans)
    if hflip is not None:
        f = hflip.float()[:, None, None]
        xy = torch.stack([f * (image_wh[0] - xy[..., 0]) + (1 - f) * xy[..., 0], xy[..., 1]], -1)
    hw, hh = heatmap_wh
    scale = torch.tensor([hw / image_wh[0], hh / image_wh[1]], device=xy.device)
    denom = torch.tensor([hw - 1.0, hh - 1.0], device=xy.device)
    return torch.clamp(xy * scale / denom * 2 - 1, -1.1, 1.1), inside


def gaussian_heatmaps(centres, heatmap_wh, sigma, mask=None):
    """Sum of 2D Gaussians at ``centres`` (..., P, J, 2) image pixels (x, y),
    drawn at a quarter of the pixel scale, clipped to [0, 1] -> (..., J, H, W)."""
    W, H = heatmap_wh
    x, y = centres[..., 0] * 0.25, centres[..., 1] * 0.25
    xs = torch.arange(W, dtype=torch.float32, device=centres.device)
    ys = torch.arange(H, dtype=torch.float32, device=centres.device)
    gx = torch.exp(-0.5 * ((xs - x[..., None]) / sigma) ** 2)
    gy = torch.exp(-0.5 * ((ys - y[..., None]) / sigma) ** 2)
    if mask is not None:
        gx = gx * mask[..., None, None]
    hm = (gy[..., :, None] * gx[..., None, :]).sum(-4)  # over persons
    return torch.minimum(torch.maximum(hm, hm.new_zeros(())), hm.new_ones(()))


# ---- host-side camera rig and image affine (numpy) ----

def look_at(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    z = target - pos
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 0.0, 1.0]) if abs(z[2]) < 0.9 else np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], axis=0)


def image_affine(center, scale, rot_deg, out_wh) -> np.ndarray:
    """The published get_affine_transform (scale in 200 px units) as a 3x3."""
    scale = np.asarray(scale, np.float64) * 200.0
    rot = math.pi * rot_deg / 180.0
    sn, cs = math.sin(rot), math.cos(rot)
    if scale[0] >= scale[1]:
        p = (0.0, scale[0] * -0.5)
        dst_dir = np.array([0.0, out_wh[0] * -0.5])
    else:
        p = (scale[1] * -0.5, 0.0)
        dst_dir = np.array([out_wh[1] * -0.5, 0.0])
    src_dir = np.array([p[0] * cs - p[1] * sn, p[0] * sn + p[1] * cs])
    src = np.zeros((3, 2))
    dst = np.zeros((3, 2))
    src[0], src[1] = center, np.asarray(center) + src_dir
    dst[0] = [out_wh[0] * 0.5, out_wh[1] * 0.5]
    dst[1] = dst[0] + dst_dir
    for a in (src, dst):
        d = a[0] - a[1]
        a[2] = a[1] + np.array([-d[1], d[0]])
    m = np.linalg.solve(np.concatenate([src, np.ones((3, 1))], 1), dst).T
    out = np.eye(3, dtype=np.float32)
    out[:2] = m
    return out


def pad_scale(image_wh, resized_wh) -> np.ndarray:
    """Aspect-preserving scale (200 px units) of the published get_scale."""
    w, h = float(image_wh[0]), float(image_wh[1])
    rw, rh = float(resized_wh[0]), float(resized_wh[1])
    if w / rw < h / rh:
        w = h / rh * rw
    else:
        h = w / rw * rh
    return np.array([w / 200.0, h / 200.0], np.float32)
