"""Synthetic multi-view scenes (CMU Panoptic configuration).

Cameras on a ring around the capture space looking inward, Panoptic
15-joint skeleton scale, space (8000, 8000, 2000) mm centered
(0, -500, 800). The numpy random streams are seeded exactly as in
``selfpose3d_tpu.data.synthetic``, so one seed gives the same cameras,
poses and images in both packages, and the same heatmaps to float32
round-off.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from selfpose3d_tpu_torch.config import Config
from selfpose3d_tpu_torch.data.structures import AugBranch
from selfpose3d_tpu_torch.device import resolve_device
from selfpose3d_tpu_torch.geometry.cameras import (
    CameraParams,
    project_points_with_trans,
)
from selfpose3d_tpu_torch.geometry.transforms import (
    get_affine_transform_3x3,
    get_scale,
)
from selfpose3d_tpu_torch.geometry.grid import grid_1d_axes
from selfpose3d_tpu_torch.ops.gaussian import render_gaussian_cube_3d, render_gaussian_heatmaps


def _look_at_rotation(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    z = target - cam_pos
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 0.0, 1.0]) if abs(z[2]) < 0.9 else np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


def ring_cameras(
    num_views: int = 5,
    radius: float = 4800.0,
    height: float = 1600.0,
    image_wh: Tuple[int, int] = (1920, 1080),
    focal: float = 1500.0,
    seed: int = 0,
) -> CameraParams:
    """Panoptic-like inward-looking camera ring, batched (1, V), on the CPU."""
    rs = np.random.RandomState(seed)
    Rs, Ts = [], []
    target = np.array([0.0, -500.0, 800.0])
    for i in range(num_views):
        ang = 2 * np.pi * i / num_views + rs.uniform(-0.15, 0.15)
        pos = np.array(
            [radius * np.cos(ang), radius * np.sin(ang), height + rs.uniform(-200, 200)]
        )
        Rs.append(_look_at_rotation(pos, target))
        Ts.append(pos.reshape(3, 1))
    W, H = image_wh
    return CameraParams(
        R=torch.from_numpy(np.stack(Rs)[None].astype(np.float32)),
        T=torch.from_numpy(np.stack(Ts)[None].astype(np.float32)),
        f=torch.full((1, num_views, 2), focal, dtype=torch.float32),
        c=torch.from_numpy(np.tile([W / 2.0, H / 2.0], (1, num_views, 1)).astype(np.float32)),
        k=torch.zeros((1, num_views, 3), dtype=torch.float32),
        p=torch.zeros((1, num_views, 2), dtype=torch.float32),
    )


def random_poses(
    num_person: int,
    num_joints: int = 15,
    seed: int = 0,
    root_idx: int = 2,
) -> np.ndarray:
    """Random plausible skeletons (P, J, 3) in world mm."""
    rs = np.random.RandomState(seed)
    roots = np.stack(
        [
            rs.uniform(-2000, 2000, num_person),
            rs.uniform(-2500, 1500, num_person),
            rs.uniform(700, 1100, num_person),
        ],
        axis=-1,
    )
    offsets = rs.randn(num_person, num_joints, 3) * np.array([220.0, 220.0, 320.0])
    poses = roots[:, None, :] + offsets
    poses[:, root_idx] = roots
    return poses.astype(np.float32)


def make_synthetic_branch(
    cfg: Config,
    batch_size: int = 1,
    num_person: int = 3,
    seed: int = 0,
    with_images: bool = True,
    rot_deg: float = 0.0,
    scale_aug: float = 1.0,
    hflip: bool = False,
    device="cuda",
) -> Tuple[AugBranch, np.ndarray]:
    """A fully populated AugBranch for a synthetic scene, on ``device``.

    Returns (branch, gt_poses (B, P, J, 3)). Images are uniform noise;
    target heatmaps are rendered from the GT joints (sum -> clip
    composite); ``target_3d`` is the GT roots' 3D Gaussian cube over the
    root space (MULTI_PERSON.INITIAL_CUBE_SIZE).
    """
    dev = resolve_device(device)
    V = cfg.DATASET.CAMERA_NUM
    J = cfg.NETWORK.NUM_JOINTS
    P = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
    img_w, img_h = cfg.NETWORK.IMAGE_SIZE
    hm_w, hm_h = cfg.NETWORK.HEATMAP_SIZE
    orig_w, orig_h = cfg.NETWORK.IMAGE_SIZE_ORIG
    B = batch_size

    cam1 = ring_cameras(V, image_wh=(orig_w, orig_h), seed=seed)
    cam = CameraParams(
        *(t.expand((B,) + tuple(t.shape[1:])).contiguous() for t in (
            cam1.R, cam1.T, cam1.f, cam1.c, cam1.k, cam1.p
        ))
    ).to(dev)

    center = np.array([orig_w / 2.0, orig_h / 2.0])
    scale = get_scale((orig_w, orig_h), (img_w, img_h)) * scale_aug
    trans = get_affine_transform_3x3(center, scale, rot_deg, (img_w, img_h))
    trans_bv = torch.from_numpy(np.tile(trans.astype(np.float32), (B, V, 1, 1))).to(dev)
    orig_wh = torch.from_numpy(
        np.tile([orig_w, orig_h], (B, V, 1)).astype(np.float32)
    ).to(dev)

    rs = np.random.RandomState(seed + 1)
    poses = np.stack(
        [random_poses(num_person, J, seed=seed + 10 + b) for b in range(B)]
    )  # (B, P_real, J, 3)
    roots = poses[:, :, cfg.DATASET.ROOTIDX]  # (B, P_real, 3)

    pix = project_points_with_trans(
        torch.from_numpy(poses.reshape(B, 1, num_person * J, 3)).to(dev),
        cam, trans_bv,
    ).reshape(B, V, num_person, J, 2)
    hm = render_gaussian_heatmaps(
        pix, (hm_w, hm_h), sigma=float(cfg.NETWORK.SIGMA), coord_scale=0.25
    )  # (B, V, J, H, W)
    target_2d = hm.permute(0, 1, 3, 4, 2).contiguous()

    axes = grid_1d_axes(
        cfg.MULTI_PERSON.SPACE_SIZE, cfg.MULTI_PERSON.SPACE_CENTER,
        cfg.MULTI_PERSON.INITIAL_CUBE_SIZE,
    )
    target_3d = render_gaussian_cube_3d(
        torch.from_numpy(roots).to(dev), *(torch.from_numpy(a).to(dev) for a in axes)
    )  # (B, X, Y, Z)

    joints = torch.zeros((B, V, P, J, 2), dtype=torch.float32, device=dev)
    joints[:, :, :num_person] = pix
    joints_vis = torch.zeros((B, V, P, J, 2), dtype=torch.float32, device=dev)
    joints_vis[:, :, :num_person] = 1.0
    roots_pad = np.zeros((B, P, 3), np.float32)
    roots_pad[:, :num_person] = roots
    joints_3d = np.zeros((B, P, J, 3), np.float32)
    joints_3d[:, :num_person] = poses
    joints_3d_vis = np.zeros((B, P, J, 3), np.float32)
    joints_3d_vis[:, :num_person] = 1.0

    views = None
    if with_images:
        views = torch.from_numpy(
            rs.rand(B, V, img_h, img_w, 3).astype(np.float32)
        ).to(dev)

    branch = AugBranch(
        cam=cam,
        trans=trans_bv,
        orig_wh=orig_wh,
        hflip=torch.full((B,), hflip, dtype=torch.bool, device=dev),
        views=views,
        input_heatmaps=None if with_images else target_2d,
        target_2d=target_2d,
        weights_2d=torch.ones((B, V, J, 1), dtype=torch.float32, device=dev),
        target_3d=target_3d,
        joints=joints,
        joints_vis=joints_vis,
        joints_3d=torch.from_numpy(joints_3d).to(dev),
        joints_3d_vis=torch.from_numpy(joints_3d_vis).to(dev),
        roots_3d=torch.from_numpy(roots_pad).to(dev),
        num_person=torch.full((B,), num_person, dtype=torch.int32, device=dev),
    )
    return branch, poses
