"""Panoptic SSV training dataset: pseudo-label DB + 3 augmentation branches.

Re-design of JointsDatasetSSV/panopticSSV (ref: lib/dataset/JointsDatasetSSV.py,
lib/dataset/panoptic_ssv.py): one index = one multi-view frame; produces three
branches — aug1/aug2 with random rotation/scale/hflip, branch3 un-augmented —
each with warped images, pseudo-label target heatmaps, and meta arrays. The
reference's rejection-resampling loop (every person's root visible in
>= MIN_VIEWS_CHECK views under both augs, ref: JointsDatasetSSV.py:168-340)
is kept, bounded by a retry cap. The port's copy of
``selfpose3d_tpu/data/panoptic_ssv.py``: images are read, converted and
warped with ``utils/image_io`` (numpy) where the JAX package calls OpenCV.
"""

from __future__ import annotations

import copy
import json
import logging
import os.path as osp
import pickle
from typing import List, Tuple

import numpy as np

from selfpose3d_tpu_torch.config import Config
from selfpose3d_tpu_torch.data import skeleton
from selfpose3d_tpu_torch.data.panoptic import PanopticDataset
from selfpose3d_tpu_torch.data.randaugment import RandAugmentCutout
from selfpose3d_tpu_torch.data.targets import (
    generate_3d_target,
    generate_target_heatmap,
)
from selfpose3d_tpu_torch.geometry.transforms import (
    get_affine_transform,
    get_affine_transform_3x3,
    get_scale,
    affine_transform_point_np,
)
from selfpose3d_tpu_torch.utils.image_io import bgr_to_rgb, warp_affine
from selfpose3d_tpu_torch.utils.zipreader import imread_any

logger = logging.getLogger(__name__)


class PanopticSSVDataset(PanopticDataset):
    """SSV train dataset over pseudo-label pickles
    (ref: lib/dataset/panoptic_ssv.py:82-280)."""

    #: original camera image size; overridden by Shelf/Campus variants
    orig_wh = (1920, 1080)

    def __init__(self, cfg: Config, image_set: str = "train", is_train: bool = True):
        super().__init__(cfg, image_set, is_train)
        self.min_views_check = cfg.MIN_VIEWS_CHECK
        self.rot1 = cfg.DATASET.ROT_FACTOR1
        self.rot2 = cfg.DATASET.ROT_FACTOR2
        self.scale1 = cfg.DATASET.SCALE_FACTOR1
        self.scale2 = cfg.DATASET.SCALE_FACTOR2
        self.flip = cfg.DATASET.FLIP
        self.apply_randaug = cfg.DATASET.APPLY_RANDAUG
        self.apply_cutout = cfg.DATASET.APPLY_CUTOUT
        self._randaug = None
        if self.apply_randaug or self.apply_cutout:
            self._randaug = RandAugmentCutout(
                use_randaug=self.apply_randaug, use_cutout=self.apply_cutout
            )

    def _aug_params(self, rs: np.random.RandomState, rot_factor, scale_factor):
        rot = rs.uniform(-rot_factor, rot_factor) if rot_factor else 0.0
        scale = 1.0 + (rs.uniform(-scale_factor, scale_factor) if scale_factor else 0.0)
        hflip = bool(self.flip and rs.rand() < 0.5)
        return rot, scale, hflip

    def _roots_visible(self, rec_views: List[dict], trans, hflip) -> bool:
        """Check every person's root lands inside the input image in
        >= min_views_check views (ref: JointsDatasetSSV.py:242-340)."""
        img_w, img_h = self.cfg.NETWORK.IMAGE_SIZE
        n_persons = len(rec_views[0]["joints_2d"])
        if n_persons == 0:
            return False
        counts = np.zeros(n_persons, np.int32)
        for rec in rec_views:
            for p in range(min(n_persons, len(rec["joints_2d"]))):
                pt = rec["joints_2d"][p][self.root_id, :2]
                x, y = affine_transform_point_np(pt, trans[:2])
                if hflip:
                    x = img_w - x
                if 0 <= x < img_w and 0 <= y < img_h:
                    counts[p] += 1
        return bool(np.all(counts >= self.min_views_check))

    def _build_branch(
        self,
        frame_idx: int,
        rot: float,
        scale_aug: float,
        hflip: bool,
        rs: np.random.RandomState,
        load_images: bool,
    ) -> List[dict]:
        """Per-view items for one augmentation branch."""
        cfg = self.cfg
        img_w, img_h = cfg.NETWORK.IMAGE_SIZE
        items = []
        for cam_slot in self.cameras_sel:
            rec = copy.deepcopy(self.get_view_record(frame_idx, cam_slot))
            width, height = self.orig_wh
            c = np.array([width / 2.0, height / 2.0])
            s = get_scale((width, height), (img_w, img_h)) * scale_aug
            trans = get_affine_transform(c, s, rot, (img_w, img_h))
            trans3 = get_affine_transform_3x3(c, s, rot, (img_w, img_h))

            image = None
            if load_images:
                # plain files or `archive.zip@member` URIs
                # (ref: lib/dataset/JointsDataset.py:106-112)
                img = imread_any(rec["image"])
                if img is not None:
                    if cfg.DATASET.COLOR_RGB:
                        img = bgr_to_rgb(img)
                    image = warp_affine(img, trans, (img_w, img_h))
                    if hflip:
                        image = image[:, ::-1].copy()
                    if self._randaug is not None:
                        image = self._randaug(image, rs)
                    image = image.astype(np.float32) / 255.0

            joints = [
                np.asarray(j, np.float32)[:, :2].copy()
                for j in rec["joints_2d"]
            ][: self.max_people]
            # released shelf/campus mmpose pickles carry (J, 3) visibility
            # columns; panoptic pickles carry (J, 2) — normalize to 2
            joints_vis = [
                np.asarray(v, np.float32)[:, :2].copy()
                for v in rec["joints_2d_vis"]
            ][: self.max_people]
            nposes = len(joints)
            for n in range(nposes):
                for i in range(len(joints[n])):
                    if joints_vis[n][i, 0] > 0:
                        joints[n][i, :2] = affine_transform_point_np(
                            joints[n][i, :2], trans
                        )
                        if hflip:
                            joints[n][i, 0] = img_w - joints[n][i, 0] - 1
                        if (
                            np.min(joints[n][i, :2]) < 0
                            or joints[n][i, 0] >= img_w
                            or joints[n][i, 1] >= img_h
                        ):
                            joints_vis[n][i, :] = 0
            if hflip:
                # swap left/right joints (ref: JointsDatasetSSV.py:404-418)
                order = skeleton.FLIP_LR_JOINTS15
                joints = [j[order] for j in joints]
                joints_vis = [v[order] for v in joints_vis]

            target, weight = generate_target_heatmap(
                joints, joints_vis, (img_w, img_h), cfg.NETWORK.HEATMAP_SIZE,
                float(cfg.NETWORK.SIGMA), self.num_joints,
            )

            joints_3d = rec.get("joints_3d", [])[: self.max_people]
            target_3d = generate_3d_target(
                [j[self.root_id] for j in joints_3d],
                cfg.MULTI_PERSON.SPACE_SIZE,
                cfg.MULTI_PERSON.SPACE_CENTER,
                cfg.MULTI_PERSON.INITIAL_CUBE_SIZE,
            ) if joints_3d else np.zeros(
                tuple(int(x) for x in cfg.MULTI_PERSON.INITIAL_CUBE_SIZE), np.float32
            )

            P, J = self.max_people, self.num_joints
            joints_u = np.zeros((P, J, 2), np.float32)
            joints_vis_u = np.zeros((P, J, 2), np.float32)
            roots_u = np.zeros((P, 3), np.float32)
            for i in range(nposes):
                joints_u[i] = joints[i]
                joints_vis_u[i] = joints_vis[i]
            for i, j3 in enumerate(joints_3d):
                roots_u[i] = j3[self.root_id, :3]

            items.append(
                {
                    "image": image,
                    "target_2d": target.transpose(1, 2, 0),
                    "weights_2d": weight,
                    "target_3d": target_3d,
                    "trans": trans3.astype(np.float32),
                    "orig_wh": np.array([width, height], np.float32),
                    "camera": self.get_camera(rec, cam_slot),
                    "joints": joints_u,
                    "joints_vis": joints_vis_u,
                    "roots_3d": roots_u,
                    "num_person": nposes,
                    "hflip": hflip,
                }
            )
        return items

    def get_ssv_frame(
        self, frame_idx: int, seed: int = 0, load_images: bool = True,
        max_retries: int = 200,
    ) -> Tuple[List[dict], List[dict], List[dict]]:
        """Three augmentation branches with rejection resampling.

        The reference resamples (aug params, frame) indefinitely until every
        person's root is visible in >= MIN_VIEWS_CHECK views under both augs
        (ref: JointsDatasetSSV.py:168-340, mis_count at :337-340). Here the
        loop is bounded but convergence is forced by *progressively damping*
        the rotation/scale magnitude every 25 failures (damped draws keep
        roots visible whenever the un-augmented frame is valid) while also
        resampling frames. The fallback can never emit identical branches:
        worst case, two micro-jittered distinct augmentations are built.
        """
        rs = np.random.RandomState(seed * 100003 + frame_idx)
        idx = frame_idx
        img_w, img_h = self.cfg.NETWORK.IMAGE_SIZE
        width, height = self.orig_wh
        c = np.array([width / 2.0, height / 2.0])
        mis_count = 0
        for attempt in range(max_retries):
            damp = 0.5 ** (attempt // 25)
            rot1, s1, f1 = self._aug_params(rs, self.rot1 * damp, self.scale1 * damp)
            rot2, s2, f2 = self._aug_params(rs, self.rot2 * damp, self.scale2 * damp)

            recs = [
                self.get_view_record(idx, cs) for cs in self.cameras_sel
            ]
            ok = True
            for rot, sc, fl in ((rot1, s1, f1), (rot2, s2, f2)):
                s = get_scale((width, height), (img_w, img_h)) * sc
                t3 = get_affine_transform_3x3(c, s, rot, (img_w, img_h))
                if not self._roots_visible(recs, t3, fl):
                    ok = False
                    break
            if ok:
                if mis_count:
                    logger.info(
                        "ssv frame %d: %d rejected augmentation draws",
                        frame_idx, mis_count,
                    )
                b1 = self._build_branch(idx, rot1, s1, f1, rs, load_images)
                b2 = self._build_branch(idx, rot2, s2, f2, rs, load_images)
                b3 = self._build_branch(idx, 0.0, 1.0, False, rs, load_images)
                return b1, b2, b3
            mis_count += 1
            if attempt % 2 == 1:
                idx = int(rs.randint(0, len(self)))  # resample another frame
        # pathological DB (no frame has visible roots even un-augmented):
        # emit two *distinct* micro-jittered augmentations — never b1==b2==b3,
        # which would trivially satisfy the consistency losses.
        logger.warning(
            "ssv frame %d: rejection resampling exhausted %d retries "
            "(mis_count=%d); falling back to micro-jittered augmentations",
            frame_idx, max_retries, mis_count,
        )
        b1 = self._build_branch(frame_idx, 1.0, 1.01, False, rs, load_images)
        b2 = self._build_branch(frame_idx, -1.0, 0.99, False, rs, load_images)
        b3 = self._build_branch(frame_idx, 0.0, 1.0, False, rs, load_images)
        return b1, b2, b3

    def evaluate(self, preds, roots=None, output_dir: str = ""):
        """Pose-only AP protocol for the SSV train split: the reference's
        panoptic_ssv.evaluate computes pose AP/MPJPE only, never root
        metrics (ref: lib/dataset/panoptic_ssv.py:282-335), so any roots
        passed by a shared caller are dropped here."""
        return super().evaluate(preds, None, output_dir)

    def get_camera(self, rec: dict, cam_slot: int) -> dict:
        return rec["camera"]


class ShelfCampusSSVDataset(PanopticSSVDataset):
    """SSL training datasets for Shelf/Campus over mmpose 2D-prediction
    pickles (ref: lib/dataset/shelf_ssv.py, campus_ssv.py — near-copies of
    JointsDatasetSSV over a different DB; here one subclass)."""

    def __init__(self, cfg: Config, name: str, image_set: str = "train",
                 is_train: bool = True):
        # bypass PanopticDataset.__init__: different DB + calibration source
        self.cfg = cfg
        self.name = name
        self.image_set = image_set
        self.is_train = is_train
        self.root_id = cfg.DATASET.ROOTIDX
        self.num_joints = cfg.NETWORK.NUM_JOINTS
        self.max_people = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
        self.dataset_root = osp.join(cfg.DATA_DIR, cfg.DATASET.ROOT)
        self.camera_num_total = cfg.DATASET.CAMERA_NUM_TOTAL
        self.cameras_sel = list(cfg.DATASET.CAMERAS)[: cfg.DATASET.CAMERA_NUM]
        self.orig_wh = tuple(int(x) for x in cfg.NETWORK.IMAGE_SIZE_ORIG)

        db_file = osp.join(self.dataset_root, f"{name}_mmpose.pkl")
        with open(db_file, "rb") as f:
            info = pickle.load(f)
        self.db = info["db"]
        self.db_size = len(self.db)

        with open(osp.join(self.dataset_root, f"calibration_{name}.json")) as f:
            calib = json.load(f)
        self._cams = {
            cid: {k: np.asarray(v) for k, v in cam.items()}
            for cid, cam in calib.items()
        }
        self._cam_ids = sorted(self._cams)

        self.min_views_check = cfg.MIN_VIEWS_CHECK
        self.rot1 = cfg.DATASET.ROT_FACTOR1
        self.rot2 = cfg.DATASET.ROT_FACTOR2
        self.scale1 = cfg.DATASET.SCALE_FACTOR1
        self.scale2 = cfg.DATASET.SCALE_FACTOR2
        self.flip = cfg.DATASET.FLIP
        self.apply_randaug = cfg.DATASET.APPLY_RANDAUG
        self.apply_cutout = cfg.DATASET.APPLY_CUTOUT
        self._randaug = None
        if self.apply_randaug or self.apply_cutout:
            self._randaug = RandAugmentCutout(
                use_randaug=self.apply_randaug, use_cutout=self.apply_cutout
            )

    def get_camera(self, rec: dict, cam_slot: int) -> dict:
        return self._cams[self._cam_ids[cam_slot]]
