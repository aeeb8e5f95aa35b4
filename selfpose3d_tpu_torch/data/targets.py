"""Host-side numpy target generation for the input pipeline (the port's
own copy of ``selfpose3d_tpu/data/targets.py``).

Exact ports of the dataset-side target generators
(ref: lib/dataset/JointsDataset.py:237-408): per-joint truncated Gaussians at
integer heatmap coords, max-composited across persons, plus the 3D root cube
and confidence-scaled input heatmaps used by Shelf/Campus.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def compute_human_scale(pose: np.ndarray, joints_vis: np.ndarray) -> float:
    """(ref: JointsDataset.py:227-235)."""
    idx = joints_vis[:, 0] == 1
    if np.sum(idx) == 0:
        return 0.0
    minx, maxx = np.min(pose[idx, 0]), np.max(pose[idx, 0])
    miny, maxy = np.min(pose[idx, 1]), np.max(pose[idx, 1])
    return float(
        np.clip(np.maximum(maxy - miny, maxx - minx) ** 2, 96 ** 2 / 4.0, 4 * 96 ** 2)
    )


def _splat_gaussian(target_j, mu_x, mu_y, sigma, hm_w, hm_h, max_value=1.0):
    tmp_size = sigma * 3
    ul = [int(mu_x - tmp_size), int(mu_y - tmp_size)]
    br = [int(mu_x + tmp_size + 1), int(mu_y + tmp_size + 1)]
    if ul[0] >= hm_w or ul[1] >= hm_h or br[0] < 0 or br[1] < 0:
        return
    size = int(2 * tmp_size + 1)
    x = np.arange(0, size, 1, np.float32)
    y = x[:, np.newaxis]
    x0 = y0 = size // 2
    g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2)) * max_value
    g_x = max(0, -ul[0]), min(br[0], hm_w) - ul[0]
    g_y = max(0, -ul[1]), min(br[1], hm_h) - ul[1]
    img_x = max(0, ul[0]), min(br[0], hm_w)
    img_y = max(0, ul[1]), min(br[1], hm_h)
    target_j[img_y[0]:img_y[1], img_x[0]:img_x[1]] = np.maximum(
        target_j[img_y[0]:img_y[1], img_x[0]:img_x[1]],
        g[g_y[0]:g_y[1], g_x[0]:g_x[1]],
    )


def generate_target_heatmap(
    joints: Sequence[np.ndarray],
    joints_vis: Sequence[np.ndarray],
    image_size: Tuple[int, int],
    heatmap_size: Tuple[int, int],
    sigma: float,
    num_joints: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """(ref: JointsDataset.py:237-302). joints in input-image pixels.

    Returns (target (J, Hh, Wh), target_weight (J, 1))."""
    nposes = len(joints)
    hm_w, hm_h = int(heatmap_size[0]), int(heatmap_size[1])
    feat_stride = np.array(image_size, np.float64) / np.array(heatmap_size, np.float64)

    target_weight = np.zeros((num_joints, 1), dtype=np.float32)
    for i in range(num_joints):
        for n in range(nposes):
            if joints_vis[n][i, 0] == 1:
                target_weight[i, 0] = 1

    target = np.zeros((num_joints, hm_h, hm_w), dtype=np.float32)
    for n in range(nposes):
        scale = 2 * compute_human_scale(
            np.asarray(joints[n])[:, :2] / feat_stride, np.asarray(joints_vis[n])
        )
        if scale == 0:
            continue
        for j in range(num_joints):
            if joints_vis[n][j, 0] == 0:
                continue
            mu_x = int(joints[n][j][0] / feat_stride[0])
            mu_y = int(joints[n][j][1] / feat_stride[1])
            _splat_gaussian(target[j], mu_x, mu_y, sigma, hm_w, hm_h)
        target = np.clip(target, 0, 1)
    return target, target_weight


def generate_input_heatmap(
    joints: Sequence[np.ndarray],
    image_size: Tuple[int, int],
    heatmap_size: Tuple[int, int],
    sigma: float,
    use_confidence: bool = True,
) -> np.ndarray:
    """Input heatmaps from predicted 2D poses, confidence-scaled
    (ref: JointsDataset.py:343-408); drives the image-free Shelf/Campus path."""
    nposes = len(joints)
    num_joints = joints[0].shape[0]
    hm_w, hm_h = int(heatmap_size[0]), int(heatmap_size[1])
    feat_stride = np.array(image_size, np.float64) / np.array(heatmap_size, np.float64)

    target = np.zeros((num_joints, hm_h, hm_w), dtype=np.float32)
    for n in range(nposes):
        scale = 2 * compute_human_scale(
            np.asarray(joints[n])[:, :2] / feat_stride, np.ones((num_joints, 1))
        )
        if scale == 0:
            continue
        for j in range(num_joints):
            mu_x = int(joints[n][j][0] / feat_stride[0])
            mu_y = int(joints[n][j][1] / feat_stride[1])
            max_value = (
                float(joints[n][j][2])
                if (use_confidence and joints[n].shape[1] == 3)
                else 1.0
            )
            _splat_gaussian(target[j], mu_x, mu_y, sigma, hm_w, hm_h, max_value)
        target = np.clip(target, 0, 1)
    return target


def generate_3d_target(
    roots: Sequence[np.ndarray],
    space_size,
    space_center,
    cube_size,
    sigma: float = 200.0,
) -> np.ndarray:
    """3D Gaussian cube at person roots (ref: JointsDataset.py:304-341)."""
    gx = np.linspace(-space_size[0] / 2, space_size[0] / 2, int(cube_size[0])) + space_center[0]
    gy = np.linspace(-space_size[1] / 2, space_size[1] / 2, int(cube_size[1])) + space_center[1]
    gz = np.linspace(-space_size[2] / 2, space_size[2] / 2, int(cube_size[2])) + space_center[2]
    target = np.zeros((int(cube_size[0]), int(cube_size[1]), int(cube_size[2])), np.float32)
    for mu in roots:
        i_x = [np.searchsorted(gx, mu[0] - 3 * sigma), np.searchsorted(gx, mu[0] + 3 * sigma, "right")]
        i_y = [np.searchsorted(gy, mu[1] - 3 * sigma), np.searchsorted(gy, mu[1] + 3 * sigma, "right")]
        i_z = [np.searchsorted(gz, mu[2] - 3 * sigma), np.searchsorted(gz, mu[2] + 3 * sigma, "right")]
        if i_x[0] >= i_x[1] or i_y[0] >= i_y[1] or i_z[0] >= i_z[1]:
            continue
        gxx, gyy, gzz = np.meshgrid(
            gx[i_x[0]:i_x[1]], gy[i_y[0]:i_y[1]], gz[i_z[0]:i_z[1]], indexing="ij"
        )
        g = np.exp(
            -((gxx - mu[0]) ** 2 + (gyy - mu[1]) ** 2 + (gzz - mu[2]) ** 2)
            / (2 * sigma ** 2)
        )
        target[i_x[0]:i_x[1], i_y[0]:i_y[1], i_z[0]:i_z[1]] = np.maximum(
            target[i_x[0]:i_x[1], i_y[0]:i_y[1], i_z[0]:i_z[1]], g
        )
    return np.clip(target, 0, 1)
