"""2D affine-transform utilities (host numpy; ref: lib/utils/transforms.py).

Center/scale(x200 px)/rotation parameterisation of the reference; the
3-point solve is a plain linear solve instead of cv2.getAffineTransform.
"""

from __future__ import annotations

import numpy as np


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
