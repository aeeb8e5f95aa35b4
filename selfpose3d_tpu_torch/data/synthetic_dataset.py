"""Synthetic-scene dataset: the train and validation pipeline with no files.

Deterministic random multi-person scenes with the Panoptic camera geometry
(``data/synthetic.py``), served through the frame / SSV-frame interface
of the Panoptic datasets; ``evaluate`` is the Panoptic AP protocol. The
numpy random streams are those of
``selfpose3d_tpu.data.synthetic_dataset``: one seed gives the same
scenes, augmentations, targets and noise images in both packages.

``DATASET.SYNTH_IMAGE_MODE: render`` draws stick figures with this
module's own rasteriser (``draw_disc``, ``draw_capsule``): anti-aliased
discs at the joints and capsules along the limbs, each computed only
inside its own bounding box, blended over the same noise floor with the
same colours, radius and thickness as the JAX package's OpenCV drawing.
OpenCV draws float32 images without anti-aliasing whatever ``lineType``
says, so the two images differ at the shapes' edges.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np

from selfpose3d_tpu_torch.config import Config
from selfpose3d_tpu_torch.data.skeleton import PANOPTIC_LIMBS
from selfpose3d_tpu_torch.data.synthetic import random_poses, ring_cameras
from selfpose3d_tpu_torch.data.targets import generate_3d_target, generate_target_heatmap
from selfpose3d_tpu_torch.geometry.cameras_np import project_pose_np
from selfpose3d_tpu_torch.geometry.transforms import (
    affine_transform_point_np,
    get_affine_transform_3x3,
    get_scale,
)


@functools.lru_cache(maxsize=None)
def joint_colors(J: int) -> np.ndarray:
    """Distinct fixed hues per joint type (HSV at s = v = 1, floor 0.15), so
    the backbone can tell joints apart by colour."""
    hues = np.linspace(0.0, 1.0, J, endpoint=False)
    i = (hues * 6).astype(int) % 6
    f = hues * 6 - np.floor(hues * 6)
    rgb = np.zeros((J, 3), np.float32)
    for j in range(J):
        p, q, t = 0.15, 1 - f[j] * 0.85, 0.15 + f[j] * 0.85
        rgb[j] = [
            (1, q, p, p, t, 1)[i[j]],
            (t, 1, 1, q, p, p)[i[j]],
            (p, p, t, 1, 1, q)[i[j]],
        ]
    rgb.flags.writeable = False
    return rgb


def _blend(img: np.ndarray, x0: int, y0: int, cover: np.ndarray, color) -> None:
    """img[y0:, x0:] += cover * (color - img) over ``cover``'s window."""
    h, w = cover.shape
    win = img[y0 : y0 + h, x0 : x0 + w]
    win += cover[..., None] * (np.asarray(color, np.float32) - win)


_STRIP = 16  # rows a strip of draw_capsule


def _window(img, lo_x, hi_x, lo_y, hi_y):
    """The integer pixel window [lo, hi] clipped to the image, or None."""
    H, W = img.shape[:2]
    x0, x1 = max(int(np.floor(lo_x)), 0), min(int(np.ceil(hi_x)), W - 1)
    y0, y1 = max(int(np.floor(lo_y)), 0), min(int(np.ceil(hi_y)), H - 1)
    if x0 > x1 or y0 > y1:
        return None
    return x0, x1, y0, y1


def draw_disc(img: np.ndarray, cx: float, cy: float, radius: float, color) -> None:
    """An anti-aliased filled disc of ``radius`` px at pixel (cx, cy),
    blended in place: a pixel's cover is clip(radius + 0.5 - d, 0, 1) for
    its centre's distance d, computed only inside the disc's box."""
    win = _window(img, cx - radius - 1, cx + radius + 1, cy - radius - 1, cy + radius + 1)
    if win is None:
        return
    x0, x1, y0, y1 = win
    xs = np.arange(x0, x1 + 1, dtype=np.float32) - cx
    ys = np.arange(y0, y1 + 1, dtype=np.float32)[:, None] - cy
    d = np.sqrt(xs * xs + ys * ys)
    _blend(img, x0, y0, np.clip(radius + 0.5 - d, 0.0, 1.0), color)


def draw_ring(img: np.ndarray, cx: float, cy: float, radius: float, thickness: float,
              color) -> None:
    """An anti-aliased circle of ``radius`` px and line width ``thickness``
    at pixel (cx, cy), blended in place: cover clip(thickness / 2 + 0.5 -
    |d - radius|, 0, 1), computed only inside the circle's box."""
    r = radius + thickness / 2.0
    win = _window(img, cx - r - 1, cx + r + 1, cy - r - 1, cy + r + 1)
    if win is None:
        return
    x0, x1, y0, y1 = win
    xs = np.arange(x0, x1 + 1, dtype=np.float32) - cx
    ys = np.arange(y0, y1 + 1, dtype=np.float32)[:, None] - cy
    d = np.abs(np.sqrt(xs * xs + ys * ys) - radius)
    _blend(img, x0, y0, np.clip(thickness / 2.0 + 0.5 - d, 0.0, 1.0), color)


def draw_capsule(img: np.ndarray, a, b, thickness: float, color) -> None:
    """An anti-aliased segment a -> b, ``thickness`` px wide with round
    caps, blended in place: cover clip(thickness / 2 + 0.5 - d, 0, 1) for
    a pixel centre's distance d to the segment, inside the capsule's box.
    The box is covered in strips of _STRIP rows, each over the columns
    that the segment's points within reach of its rows can ink: a long
    slanted limb inks a thin band of its box."""
    (ax, ay), (bx, by) = a, b
    r = thickness / 2.0
    win = _window(img, min(ax, bx) - r - 1, max(ax, bx) + r + 1,
                  min(ay, by) - r - 1, max(ay, by) + r + 1)
    if win is None:
        return
    x0, x1, y0, y1 = win
    dx, dy = float(bx - ax), float(by - ay)
    len2 = dx * dx + dy * dy
    reach = r + 1.0  # past the last inked pixel (cover 0 from r + 0.5)
    for s0 in range(y0, y1 + 1, _STRIP):
        s1 = min(s0 + _STRIP - 1, y1)
        # the segment's parameters t whose point lies within reach of the rows
        if dy != 0:
            t0, t1 = sorted(((s0 - reach - ay) / dy, (s1 + reach - ay) / dy))
            t0, t1 = max(t0, 0.0), min(t1, 1.0)
            if t0 > t1:
                continue
        elif s0 - reach <= ay <= s1 + reach:
            t0, t1 = 0.0, 1.0
        else:
            continue
        xa, xb = sorted((ax + t0 * dx, ax + t1 * dx))
        c0, c1 = max(x0, int(np.floor(xa - reach))), min(x1, int(np.ceil(xb + reach)))
        if c0 > c1:
            continue
        px = np.arange(c0, c1 + 1, dtype=np.float32) - ax
        py = np.arange(s0, s1 + 1, dtype=np.float32)[:, None] - ay
        t = (np.clip((px * dx + py * dy) / len2, 0.0, 1.0) if len2 > 0
             else np.zeros_like(px + py))
        d = np.sqrt((px - t * dx) ** 2 + (py - t * dy) ** 2)
        _blend(img, c0, s0, np.clip(r + 0.5 - d, 0.0, 1.0), color)


def render_stick_figures(joints, joints_vis, img_wh, rs, num_joints: int) -> np.ndarray:
    """Stick figures at the augmented projected joints over a noise floor
    (``rs.rand(h, w, 3) * 0.08``, the one draw from ``rs``): per person
    the limbs between visible joints in the mean of their joints' colours
    times 0.6, then each visible joint's disc in its colour; clipped to
    [0, 1]. Radius max(1, round(min(w, h) / 48)), limb thickness
    max(1, round(min(w, h) / 96)); joints are drawn at rounded pixels."""
    w, h = img_wh
    img = rs.rand(h, w, 3).astype(np.float32) * 0.08
    colors = joint_colors(num_joints)
    rad = max(1, round(min(w, h) / 48))
    thick = max(1, round(min(w, h) / 96))
    for jp, jv in zip(joints, joints_vis):
        pix = [(int(round(x)), int(round(y))) for x, y in jp]
        for a, b in PANOPTIC_LIMBS:
            if a < num_joints and b < num_joints and jv[a, 0] > 0 and jv[b, 0] > 0:
                draw_capsule(img, pix[a], pix[b], thick, (colors[a] + colors[b]) / 2 * 0.6)
        for j in range(len(jp)):
            if jv[j, 0] > 0:
                draw_disc(img, pix[j][0], pix[j][1], rad, colors[j])
    return np.clip(img, 0.0, 1.0)


class SyntheticSceneDataset:
    """``num_frames`` scenes of 1 + idx % 3 people; the train and the
    validation set draw their poses from disjoint seeds."""

    def __init__(self, cfg: Config, image_set: str = "train", is_train: bool = True,
                 num_frames: int = 64):
        self.cfg = cfg
        self.is_train = is_train
        self.num_frames = num_frames
        self.root_id = cfg.DATASET.ROOTIDX
        self.num_joints = cfg.NETWORK.NUM_JOINTS
        self.max_people = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
        self.seed_base = 0 if image_set == "train" else 10_000

        V = cfg.DATASET.CAMERA_NUM
        ow, oh = cfg.NETWORK.IMAGE_SIZE_ORIG
        cam = ring_cameras(V, image_wh=(ow, oh), seed=7)
        self._cams = [
            {
                "R": cam.R[0, v].numpy(),
                "T": cam.T[0, v].numpy(),
                "fx": cam.f[0, v, 0].numpy(),
                "fy": cam.f[0, v, 1].numpy(),
                "cx": cam.c[0, v, 0].numpy(),
                "cy": cam.c[0, v, 1].numpy(),
                "k": np.zeros((3, 1), np.float32),
                "p": np.zeros((2, 1), np.float32),
            }
            for v in range(V)
        ]

    def __len__(self):
        return self.num_frames

    def _frame_poses(self, idx: int) -> np.ndarray:
        n = 1 + (idx % 3)
        return random_poses(n, self.num_joints, seed=self.seed_base + idx,
                            root_idx=self.root_id)

    def _project(self, poses: np.ndarray, v: int) -> np.ndarray:
        P, J, _ = poses.shape
        pix = project_pose_np(poses.reshape(P * J, 3), self._cams[v])
        return np.asarray(pix, np.float32).reshape(P, J, 2)

    def _build_view(self, poses, v, rot, scale_aug, hflip, with_image, rs) -> Dict:
        cfg = self.cfg
        img_w, img_h = cfg.NETWORK.IMAGE_SIZE
        ow, oh = cfg.NETWORK.IMAGE_SIZE_ORIG
        c = np.array([ow / 2.0, oh / 2.0])
        s = get_scale((ow, oh), (img_w, img_h)) * scale_aug
        trans3 = get_affine_transform_3x3(c, s, rot, (img_w, img_h))

        pix = self._project(poses, v)
        P_real, J = pix.shape[:2]
        joints, joints_vis = [], []
        for p in range(P_real):
            jp = np.zeros((J, 2), np.float32)
            jv = np.ones((J, 2), np.float32)
            for j in range(J):
                x, y = affine_transform_point_np(pix[p, j], trans3[:2])
                if hflip:
                    x = img_w - x - 1
                jp[j] = (x, y)
                if not (0 <= x < img_w and 0 <= y < img_h):
                    jv[j] = 0
            joints.append(jp)
            joints_vis.append(jv)

        target, weight = generate_target_heatmap(
            joints, joints_vis, (img_w, img_h), cfg.NETWORK.HEATMAP_SIZE,
            float(cfg.NETWORK.SIGMA), J,
        )
        target_3d = generate_3d_target(
            poses[:, self.root_id],
            cfg.MULTI_PERSON.SPACE_SIZE,
            cfg.MULTI_PERSON.SPACE_CENTER,
            cfg.MULTI_PERSON.INITIAL_CUBE_SIZE,
        )

        P = self.max_people
        joints_u = np.zeros((P, J, 2), np.float32)
        joints_vis_u = np.zeros((P, J, 2), np.float32)
        roots_u = np.zeros((P, 3), np.float32)
        j3_u = np.zeros((P, J, 3), np.float32)
        j3v_u = np.zeros((P, J, 3), np.float32)
        for p in range(P_real):
            joints_u[p] = joints[p]
            joints_vis_u[p] = joints_vis[p]
            roots_u[p] = poses[p, self.root_id]
            j3_u[p] = poses[p]
            j3v_u[p] = 1.0

        image = None
        if with_image:
            if cfg.DATASET.SYNTH_IMAGE_MODE == "render":
                image = render_stick_figures(joints, joints_vis, (img_w, img_h), rs, J)
            else:
                image = rs.rand(img_h, img_w, 3).astype(np.float32)

        return {
            "image": image,
            "target_2d": target.transpose(1, 2, 0),
            "weights_2d": weight,
            "target_3d": target_3d,
            "trans": trans3.astype(np.float32),
            "orig_wh": np.array([ow, oh], np.float32),
            "camera": self._cams[v],
            "joints": joints_u,
            "joints_vis": joints_vis_u,
            "joints_3d": j3_u,
            "joints_3d_vis": j3v_u,
            "roots_3d": roots_u,
            "num_person": P_real,
            "hflip": hflip,
        }

    def get_frame(self, idx: int, load_images: bool = True, seed: int = 0) -> Dict:
        """{"views": one item per camera, unaugmented; "frame_idx": idx}."""
        poses = self._frame_poses(idx)
        rs = np.random.RandomState(seed * 99991 + idx)
        views = [
            self._build_view(poses, v, 0.0, 1.0, False, load_images, rs)
            for v in range(self.cfg.DATASET.CAMERA_NUM)
        ]
        return {"views": views, "frame_idx": idx}

    def get_ssv_frame(self, idx: int, seed: int = 0, load_images: bool = True):
        """Three augmentation branches of frame ``idx`` (lists of view
        items): two with random rotation, scale and flip, the third plain."""
        poses = self._frame_poses(idx)
        rs = np.random.RandomState(seed * 99991 + idx)
        c = self.cfg

        def branch(rot_factor, scale_factor, allow_flip):
            rot = rs.uniform(-rot_factor, rot_factor) if rot_factor else 0.0
            sc = 1.0 + (rs.uniform(-scale_factor, scale_factor) if scale_factor else 0.0)
            fl = bool(allow_flip and c.DATASET.FLIP and rs.rand() < 0.5)
            return [
                self._build_view(poses, v, rot, sc, fl, load_images, rs)
                for v in range(c.DATASET.CAMERA_NUM)
            ]

        b1 = branch(c.DATASET.ROT_FACTOR1, c.DATASET.SCALE_FACTOR1, True)
        b2 = branch(c.DATASET.ROT_FACTOR2, c.DATASET.SCALE_FACTOR2, True)
        b3 = branch(0.0, 0.0, False)
        return b1, b2, b3

    def evaluate(self, preds, roots=None, output_dir: str = ""):
        """The Panoptic AP / MPJPE / recall report of ``preds`` (frame i's
        (K, J, 5) at position i) and of the root proposals ``roots``."""
        from selfpose3d_tpu_torch.eval.metrics import panoptic_metrics

        gt_poses, gt_vis, gt_roots, gt_rv = [], [], [], []
        for i in range(len(preds)):
            poses = self._frame_poses(i)
            gt_poses.append([p for p in poses])
            gt_vis.append([np.ones((self.num_joints, 3)) for _ in poses])
            gt_roots.append([p[self.root_id] for p in poses])
            gt_rv.append([1.0 for _ in poses])
        return panoptic_metrics(
            preds, gt_poses, gt_vis, roots=roots, gt_roots=gt_roots, gt_root_vis=gt_rv
        )
