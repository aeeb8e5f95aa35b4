"""NumPy twin of the camera model for host-side dataset building
(ref: lib/utils/cameras_cpu.py:24-82); the float sequence of
``selfpose3d_tpu.geometry.cameras_np``."""

from __future__ import annotations

import numpy as np


def project_point_radial_np(x, R, T, f, c, k, p) -> np.ndarray:
    """x: (N, 3) world -> (N, 2) pixels."""
    n = x.shape[0]
    xcam = R.dot(x.T - T)
    y = xcam[:2] / (xcam[2] + 1e-5)
    r2 = np.sum(y ** 2, axis=0)
    radial = 1 + np.einsum(
        "ij,ij->j", np.tile(k, (1, n)), np.array([r2, r2 ** 2, r2 ** 3])
    )
    tan = p[0] * y[1] + p[1] * y[0]
    y = y * np.tile(radial + 2 * tan, (2, 1)) + np.outer(
        np.array([p[1], p[0]]).reshape(-1), r2
    )
    return (np.multiply(f, y) + c).T


def _unfold(camera):
    R = np.asarray(camera["R"], dtype=np.float64)
    T = np.asarray(camera["T"], dtype=np.float64).reshape(3, 1)
    f = np.array([[float(np.asarray(camera["fx"]))], [float(np.asarray(camera["fy"]))]])
    c = np.array([[float(np.asarray(camera["cx"]))], [float(np.asarray(camera["cy"]))]])
    k = np.asarray(camera["k"], dtype=np.float64).reshape(3, 1)
    p = np.asarray(camera["p"], dtype=np.float64).reshape(2, 1)
    return R, T, f, c, k, p


def project_pose_np(x, camera) -> np.ndarray:
    """(N, 3) world points through the camera dict {R, T, fx, fy, cx, cy,
    k, p} -> (N, 2) pixels, in float64."""
    R, T, f, c, k, p = _unfold(camera)
    return project_point_radial_np(np.asarray(x, np.float64), R, T, f, c, k, p)
