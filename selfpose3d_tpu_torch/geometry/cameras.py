"""Pinhole camera with radial/tangential distortion (ref: lib/utils/cameras.py:27-151).

Conventions (identical to the reference and to ``selfpose3d_tpu``):
  x_cam = R @ (x_world^T - T)           R: (3,3), T: (3,1), world units mm
  y     = x_cam[:2] / (x_cam[2] + 1e-5)
  radial:  1 + k1 r^2 + k2 r^4 + k3 r^6, r^2 clipped at 1e10
  tangent: 2*(p0*y1 + p1*y0); additive term [p1, p0] * r^2
  pix   = f * y_distorted + c

Every function broadcasts over shared leading axes (batch, views). The
rotation is written out as three-term sums, not a matmul, so it stays in
full float32 whatever the TF32 settings.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class CameraParams:
    """Batched camera parameters, struct-of-tensors with matching leading
    axes, e.g. (B, V):
      R: (..., 3, 3)   rotation world->camera
      T: (..., 3, 1)   camera position in world coords
      f: (..., 2)      focal lengths (fx, fy)
      c: (..., 2)      principal point (cx, cy)
      k: (..., 3)      radial distortion k1, k2, k3
      p: (..., 2)      tangential distortion p1, p2
    """

    R: torch.Tensor
    T: torch.Tensor
    f: torch.Tensor
    c: torch.Tensor
    k: torch.Tensor
    p: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.R.shape[:-2])

    def to(self, device, non_blocking: bool = False) -> "CameraParams":
        return CameraParams(**{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in dataclasses.fields(self)
        })


def _project_core(x, R, T, f, c, k, p):
    """Project (..., N, 3) world points with (...)-batched camera params
    (the float sequence of ``selfpose3d_tpu.geometry.cameras._project_core``)."""
    d = x - T.transpose(-1, -2)  # (..., N, 3)
    Rn = R.unsqueeze(-3)  # (..., 1, 3, 3) broadcasts over N

    def row(i):
        return (
            Rn[..., i, 0] * d[..., 0]
            + Rn[..., i, 1] * d[..., 1]
            + Rn[..., i, 2] * d[..., 2]
        )

    z = row(2) + 1e-5
    y0 = row(0) / z
    y1 = row(1) / z

    r2 = torch.clamp(y0 * y0 + y1 * y1, max=1e10)  # (..., N)
    k0, k1, k2 = (k[..., i : i + 1] for i in range(3))
    p0, p1 = p[..., 0:1], p[..., 1:2]
    radial = 1.0 + k0 * r2 + k1 * r2 * r2 + k2 * r2 * r2 * r2
    corr = radial + 2.0 * (p0 * y1 + p1 * y0)
    # additive tangential term: [p1, p0] * r^2 (the reference's torch.ger)
    u = y0 * corr + p1 * r2
    v = y1 * corr + p0 * r2
    return torch.stack(
        [f[..., 0:1] * u + c[..., 0:1], f[..., 1:2] * v + c[..., 1:2]], dim=-1
    )


def project_points(x: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """World points (..., N, 3) -> pixel coords (..., N, 2)."""
    return _project_core(x, cam.R, cam.T, cam.f, cam.c, cam.k, cam.p)


def affine_points(xy: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) points through a (..., 2or3, 3) affine (homogeneous)."""
    a = trans[..., :2, :2].unsqueeze(-3)  # (..., 1, 2, 2)
    b = trans[..., :2, 2].unsqueeze(-2)  # (..., 1, 2)
    x = a[..., 0, 0] * xy[..., 0] + a[..., 0, 1] * xy[..., 1] + b[..., 0]
    y = a[..., 1, 0] * xy[..., 0] + a[..., 1, 1] * xy[..., 1] + b[..., 1]
    return torch.stack([x, y], dim=-1)


def project_points_with_trans(
    x: torch.Tensor, cam: CameraParams, trans: torch.Tensor
) -> torch.Tensor:
    """Project, then apply the image-space affine ``trans`` (..., 2or3, 3)
    (ref: lib/utils/cameras.py:58-108) -> (..., N, 2)."""
    return affine_points(project_points(x, cam), trans)


def world_to_camera_frame(x: torch.Tensor, R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) world -> camera (ref: lib/utils/cameras.py:121-134)."""
    return torch.einsum("...ij,...nj->...ni", R, x - T.transpose(-1, -2))


def camera_to_world_frame(x: torch.Tensor, R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) camera -> world (ref: lib/utils/cameras.py:137-151)."""
    return torch.einsum("...ji,...nj->...ni", R, x) + T.transpose(-1, -2)
