"""2D affine-transform utilities (ref: lib/utils/transforms.py): host numpy,
and ``affine_transform_points`` on tensors (``cameras.affine_points``, ref:
lib/utils/transforms.py:119-123).

Center/scale(x200 px)/rotation parameterisation of the reference; the
3-point solve is a plain linear solve instead of cv2.getAffineTransform.
"""

from __future__ import annotations

import numpy as np

from selfpose3d_tpu_torch.geometry.cameras import affine_points as affine_transform_points  # noqa: F401


def _get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array(
        [src_point[0] * cs - src_point[1] * sn, src_point[0] * sn + src_point[1] * cs],
        dtype=np.float64,
    )


def _get_3rd_point(a, b):
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float64)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 2x3 affine mapping 3 src points onto 3 dst points."""
    A = np.concatenate([src, np.ones((3, 1))], axis=1)  # (3, 3)
    M = np.linalg.solve(A, dst)  # (3, 2): [x y 1] @ M = [x' y']
    return M.T.astype(np.float64)  # (2, 3)


def get_affine_transform(center, scale, rot, output_size, shift=(0.0, 0.0), inv=0):
    """Center/scale(x200)/rotation -> 2x3 affine (ref: lib/utils/transforms.py:61-103).

    Maps original-image pixel coords to output_size (W, H) pixel coords
    (or the inverse when inv=1).
    """
    center = np.asarray(center, dtype=np.float64)
    scale = np.asarray(scale, dtype=np.float64)
    if scale.ndim == 0:
        scale = np.array([scale, scale], dtype=np.float64)
    shift = np.asarray(shift, dtype=np.float64)

    scale_tmp = scale * 200.0
    src_w, src_h = scale_tmp[0], scale_tmp[1]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * float(rot) / 180.0
    if src_w >= src_h:
        src_dir = _get_dir([0.0, src_w * -0.5], rot_rad)
        dst_dir = np.array([0.0, dst_w * -0.5], dtype=np.float64)
    else:
        src_dir = _get_dir([src_h * -0.5, 0.0], rot_rad)
        dst_dir = np.array([dst_h * -0.5, 0.0], dtype=np.float64)

    src = np.zeros((3, 2), dtype=np.float64)
    dst = np.zeros((3, 2), dtype=np.float64)
    src[0] = center + scale_tmp * shift
    src[1] = center + src_dir + scale_tmp * shift
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2] = _get_3rd_point(src[0], src[1])
    dst[2] = _get_3rd_point(dst[0], dst[1])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def get_affine_transform_3x3(center, scale, rot, output_size, shift=(0.0, 0.0), inv=0):
    """3x3 homogeneous version, float32."""
    M = np.eye(3, dtype=np.float32)
    M[:2] = get_affine_transform(center, scale, rot, output_size, shift, inv)
    return M


def get_scale(image_size, resized_size) -> np.ndarray:
    """Aspect-preserving pad scale in 200px units (ref: lib/utils/transforms.py:151-162)."""
    w, h = float(image_size[0]), float(image_size[1])
    w_resized, h_resized = float(resized_size[0]), float(resized_size[1])
    if w / w_resized < h / h_resized:
        w_pad = h / h_resized * w_resized
        h_pad = h
    else:
        w_pad = w
        h_pad = w / w_resized * h_resized
    return np.array([w_pad / 200.0, h_pad / 200.0], dtype=np.float32)


def affine_transform_point_np(pt, t) -> np.ndarray:
    """Single-point host version (ref: lib/utils/transforms.py:106-109)."""
    p = np.array([pt[0], pt[1], 1.0])
    return (np.asarray(t) @ p)[:2]


def rotate_points(points: np.ndarray, center: np.ndarray, rot_deg: float) -> np.ndarray:
    """Rotate N*2 points about center (ref: lib/utils/transforms.py:193-207)."""
    rot_rad = rot_deg * np.pi / 180.0
    R = np.array(
        [[np.cos(rot_rad), -np.sin(rot_rad)], [np.sin(rot_rad), np.cos(rot_rad)]]
    )
    center = np.asarray(center).reshape(2, 1)
    return (R @ (points.T - center) + center).T


def project_points_opencv(X, K, R, t, Kd):
    """OpenCV-convention projection used for Panoptic GT prep.

    X: (3, N); K: (3,3); R: (3,3); t: (3,1); Kd: [k1,k2,p1,p2,k3].
    Reproduces the reference's sequential in-place update semantics
    (ref: lib/utils/transforms.py:165-190): the second row's tangential
    term uses the already-updated first row, and the K application feeds
    row 0's updated value into row 1.
    """
    X = np.asarray(X, dtype=np.float64)
    x = R @ X + t
    x = x.copy()
    x[0:2] = x[0:2] / (x[2] + 1e-5)

    r = x[0] * x[0] + x[1] * x[1]
    radial = 1 + Kd[0] * r + Kd[1] * r * r + Kd[4] * r * r * r
    x0 = x[0] * radial + 2 * Kd[2] * x[0] * x[1] + Kd[3] * (r + 2 * x[0] * x[0])
    x1 = x[1] * radial + 2 * Kd[3] * x0 * x[1] + Kd[2] * (r + 2 * x[1] * x[1])
    x[0], x[1] = x0, x1
    x0p = K[0, 0] * x[0] + K[0, 1] * x[1] + K[0, 2]
    x1p = K[1, 0] * x0p + K[1, 1] * x[1] + K[1, 2]
    x[0], x[1] = x0p, x1p
    return x


def compute_similarity_transform(X, Y, compute_optimal_scale=False):
    """Procrustes alignment of Y onto X (ref: lib/utils/transforms.py:210-269)
    -> (d, Z, T, b, c)."""
    muX, muY = X.mean(0), Y.mean(0)
    X0, Y0 = X - muX, Y - muY
    ssX = (X0 ** 2.0).sum()
    ssY = (Y0 ** 2.0).sum()
    normX, normY = np.sqrt(ssX), np.sqrt(ssY)
    X0, Y0 = X0 / normX, Y0 / normY

    A = X0.T @ Y0
    U, s, Vt = np.linalg.svd(A, full_matrices=False)
    V = Vt.T
    T = V @ U.T
    detT = np.linalg.det(T)
    V[:, -1] *= np.sign(detT)
    s[-1] *= np.sign(detT)
    T = V @ U.T
    traceTA = s.sum()

    if compute_optimal_scale:
        b = traceTA * normX / normY
        d = 1 - traceTA ** 2
        Z = normX * traceTA * (Y0 @ T) + muX
    else:
        b = 1
        d = 1 + ssY / ssX - 2 * traceTA * normY / normX
        Z = normY * (Y0 @ T) + muX
    c = muX - b * (muY @ T)
    return d, Z, T, b, c


def procrustes_transform(target_pose, from_pose):
    """``from_pose`` aligned onto ``target_pose`` (similarity, optimal scale)."""
    _, Z, rot, s, t = compute_similarity_transform(
        target_pose, from_pose, compute_optimal_scale=True
    )
    return s * from_pose.dot(rot) + t
