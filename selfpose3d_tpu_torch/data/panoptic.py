"""CMU Panoptic dataset (evaluation / supervised training).

Reads the reference's cached DB pickles (``group_{set}_cam{N}_{suffix}.pkl``)
or rebuilds them from the panoptic-toolbox layout
(``hdPose3d_stage1_coco19`` JSON + ``calibration_*.json``), with the same
axes-swap and cm->mm conventions (ref: lib/dataset/panoptic.py:111-265).

One dataset index = one multi-view frame; the camera loop lives in the
collate stage, not the model. The port's copy of
``selfpose3d_tpu/data/panoptic.py``: images are read, converted and
warped with ``utils/image_io`` (numpy) where the JAX package calls OpenCV.
"""

from __future__ import annotations

import copy
import glob
import json
import logging
import os
import os.path as osp
import pickle
from typing import Dict, List

import numpy as np

from selfpose3d_tpu_torch.config import Config
from selfpose3d_tpu_torch.data import skeleton
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
    project_points_opencv,
)
from selfpose3d_tpu_torch.utils.image_io import bgr_to_rgb, warp_affine
from selfpose3d_tpu_torch.utils.zipreader import imread_any

logger = logging.getLogger(__name__)

M_AXES = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])


def parse_panoptic_sequence(
    dataset_root: str,
    seq: str,
    cam_list,
    interval: int,
    num_joints: int = 15,
    root_id: int = 2,
) -> List[dict]:
    """Build per-(frame, camera) records from panoptic-toolbox files
    (ref: panoptic.py:138-247)."""
    width, height = 1920, 1080
    cameras = {}
    cam_file = osp.join(dataset_root, seq, f"calibration_{seq}.json")
    with open(cam_file) as f:
        calib = json.load(f)
    for cam in calib["cameras"]:
        if (cam["panel"], cam["node"]) in cam_list:
            cameras[(cam["panel"], cam["node"])] = {
                "K": np.array(cam["K"]),
                "distCoef": np.array(cam["distCoef"]),
                "R": np.array(cam["R"]).dot(M_AXES),
                "t": np.array(cam["t"]).reshape(3, 1),
            }

    db = []
    anno_files = sorted(glob.iglob(f"{osp.join(dataset_root, seq, 'hdPose3d_stage1_coco19')}/*.json"))
    for i, fname in enumerate(anno_files):
        if i % interval != 0:
            continue
        with open(fname) as f:
            bodies = json.load(f)["bodies"]
        if len(bodies) == 0:
            continue
        for ck in cam_list:
            if ck not in cameras:
                continue
            v = cameras[ck]
            postfix = osp.basename(fname).replace("body3DScene", "")
            prefix = f"{ck[0]:02d}_{ck[1]:02d}"
            image = osp.join(seq, "hdImgs", prefix, prefix + postfix).replace(
                "json", "jpg"
            )
            all_p3, all_pv3, all_p2, all_pv2 = [], [], [], []
            for body in bodies:
                pose3d = np.array(body["joints19"]).reshape(-1, 4)[:num_joints]
                joints_vis = pose3d[:, -1] > 0.1
                if not joints_vis[root_id]:
                    continue
                pose3d = pose3d.copy()
                pose3d[:, :3] = pose3d[:, :3] @ M_AXES
                all_p3.append(pose3d[:, :3] * 10.0)
                all_pv3.append(np.repeat(joints_vis.reshape(-1, 1), 3, axis=1))
                pose2d = project_points_opencv(
                    pose3d[:, :3].T, v["K"], v["R"], v["t"], v["distCoef"]
                ).T[:, :2]
                ok = (
                    (pose2d[:, 0] >= 0)
                    & (pose2d[:, 0] <= width - 1)
                    & (pose2d[:, 1] >= 0)
                    & (pose2d[:, 1] <= height - 1)
                )
                jv = joints_vis.copy()
                jv[~ok] = 0
                all_p2.append(pose2d)
                all_pv2.append(np.repeat(jv.reshape(-1, 1), 2, axis=1))
            if all_p3:
                db.append(
                    {
                        "key": f"{seq}_{prefix}{postfix.split('.')[0]}",
                        "image": osp.join(dataset_root, image),
                        "joints_3d": all_p3,
                        "joints_3d_vis": all_pv3,
                        "joints_2d": all_p2,
                        "joints_2d_vis": all_pv2,
                        "camera": {
                            "R": v["R"],
                            "T": -v["R"].T @ v["t"] * 10.0,
                            "fx": np.array(v["K"][0, 0]),
                            "fy": np.array(v["K"][1, 1]),
                            "cx": np.array(v["K"][0, 2]),
                            "cy": np.array(v["K"][1, 2]),
                            "k": v["distCoef"][[0, 1, 4]].reshape(3, 1),
                            "p": v["distCoef"][[2, 3]].reshape(2, 1),
                        },
                    }
                )
    return db


class PanopticDataset:
    """Frame-level Panoptic dataset (ref: lib/dataset/panoptic.py:80-291)."""

    def __init__(self, cfg: Config, image_set: str, is_train: bool):
        self.cfg = cfg
        self.image_set = image_set
        self.is_train = is_train
        self.root_id = cfg.DATASET.ROOTIDX
        self.num_joints = cfg.NETWORK.NUM_JOINTS
        self.max_people = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
        self.dataset_root = osp.join(cfg.DATA_DIR, cfg.DATASET.ROOT)
        self.camera_num_total = cfg.DATASET.CAMERA_NUM_TOTAL
        self.cameras_sel = list(cfg.DATASET.CAMERAS)[: cfg.DATASET.CAMERA_NUM]
        suffix = cfg.DATASET.SUFFIX if is_train else "sub"

        if image_set == "train":
            self.sequence_list = skeleton.PANOPTIC_TRAIN_LIST
            self._interval = 3
        else:
            self.sequence_list = skeleton.PANOPTIC_VAL_LIST
            self._interval = 12

        # RandAugment/Cutout on the supervised path, training only
        # (ref: lib/dataset/JointsDataset.py:79-84,147-148)
        self._randaug = None
        if is_train and cfg.DATASET.APPLY_RANDAUG:
            self._randaug = RandAugmentCutout(
                use_randaug=True, use_cutout=cfg.DATASET.APPLY_CUTOUT
            )
        # RandAugment draws use a per-(frame, cam) RandomState derived in
        # _build_view_item: a single shared RandomState is not thread-safe
        # under the prefetch loader and its stream depends on worker
        # interleaving (non-reproducible), mirroring PanopticSSVDataset's
        # per-sample seeding (panoptic_ssv.py get_ssv_frame).
        self._aug_seed = 20260816
        self.cam_list = [skeleton.PANOPTIC_CAM_LIST[i] for i in self.cameras_sel]

        db_file = osp.join(
            self.dataset_root,
            f"group_{image_set}_cam{self.camera_num_total}_{suffix}.pkl",
        )
        if osp.exists(db_file):
            logger.info("loading db pickle %s", db_file)
            with open(db_file, "rb") as f:
                info = pickle.load(f)
            assert info["interval"] == self._interval
            self.db = info["db"]
        else:
            self.db = []
            for seq in self.sequence_list:
                self.db.extend(
                    parse_panoptic_sequence(
                        self.dataset_root, seq, self.cam_list, self._interval,
                        self.num_joints, self.root_id,
                    )
                )
            if self.db:
                os.makedirs(osp.dirname(db_file), exist_ok=True)
                with open(db_file, "wb") as f:
                    pickle.dump(
                        {
                            "sequence_list": self.sequence_list,
                            "interval": self._interval,
                            "cam_list": self.cam_list,
                            "db": self.db,
                        },
                        f,
                    )
        self.db_size = len(self.db)

    def __len__(self):
        return self.db_size // self.camera_num_total

    def get_view_record(self, frame_idx: int, cam_slot: int) -> dict:
        return self.db[self.camera_num_total * frame_idx + cam_slot]

    def get_frame(
        self, frame_idx: int, load_images: bool = True, seed: int = 0
    ) -> Dict:
        """One multi-view frame as numpy arrays (base-view items only;
        augmentation/collate handled by the loader).

        ``seed`` (the epoch on the train path) is mixed into the per-(frame,
        cam) RandomState so RandAugment draws differ across epochs, matching
        the reference's fresh global-RNG draws per call
        (ref: lib/dataset/JointsDataset.py:147-148)."""
        cfg = self.cfg
        img_w, img_h = cfg.NETWORK.IMAGE_SIZE
        views = []
        for cam_slot in self.cameras_sel:
            rec = copy.deepcopy(self.get_view_record(frame_idx, cam_slot))
            item = self._build_view_item(
                rec, load_images,
                aug_key=(seed * 100003 + frame_idx) * self.camera_num_total
                + cam_slot,
            )
            views.append(item)
        return {"views": views, "frame_idx": frame_idx}

    def _build_view_item(
        self, rec: dict, load_images: bool, aug_key: int = 0
    ) -> dict:
        cfg = self.cfg
        img_w, img_h = cfg.NETWORK.IMAGE_SIZE

        image = None
        width, height = 1920, 1080
        if load_images:
            # plain files or `archive.zip@member` URIs
            # (ref: lib/dataset/JointsDataset.py:106-112)
            img = imread_any(rec["image"])
            if img is not None:
                height, width = img.shape[:2]
                if cfg.DATASET.COLOR_RGB:
                    img = bgr_to_rgb(img)
                c = np.array([width / 2.0, height / 2.0])
                s = get_scale((width, height), (img_w, img_h))
                trans = get_affine_transform(c, s, 0, (img_w, img_h))
                warped = warp_affine(img, trans, (img_w, img_h))
                if self._randaug is not None:
                    # (ref: lib/dataset/JointsDataset.py:147-148)
                    rs = np.random.RandomState(
                        (self._aug_seed + aug_key) % (2**31 - 1)
                    )
                    warped = self._randaug(warped, rs)
                image = warped.astype(np.float32) / 255.0

        c = np.array([width / 2.0, height / 2.0])
        s = get_scale((width, height), (img_w, img_h))
        trans3 = get_affine_transform_3x3(c, s, 0, (img_w, img_h))

        joints = [j.copy() for j in rec["joints_2d"]][: self.max_people]
        joints_vis = [v.copy() for v in rec["joints_2d_vis"]][: self.max_people]
        nposes = len(joints)
        for n in range(nposes):
            for i in range(len(joints[n])):
                if joints_vis[n][i, 0] > 0:
                    joints[n][i, :2] = affine_transform_point_np(
                        joints[n][i, :2], trans3[:2]
                    )
                    if (
                        np.min(joints[n][i, :2]) < 0
                        or joints[n][i, 0] >= img_w
                        or joints[n][i, 1] >= img_h
                    ):
                        joints_vis[n][i, :] = 0

        target, weight = generate_target_heatmap(
            joints, joints_vis, (img_w, img_h), cfg.NETWORK.HEATMAP_SIZE,
            float(cfg.NETWORK.SIGMA), self.num_joints,
        )
        joints_3d = rec["joints_3d"][: self.max_people]
        target_3d = generate_3d_target(
            [j[self.root_id] for j in joints_3d],
            cfg.MULTI_PERSON.SPACE_SIZE,
            cfg.MULTI_PERSON.SPACE_CENTER,
            cfg.MULTI_PERSON.INITIAL_CUBE_SIZE,
        )

        P, J = self.max_people, self.num_joints
        joints_u = np.zeros((P, J, 2), np.float32)
        joints_vis_u = np.zeros((P, J, 2), np.float32)
        joints_3d_u = np.zeros((P, J, 3), np.float32)
        joints_3d_vis_u = np.zeros((P, J, 3), np.float32)
        for i in range(nposes):
            joints_u[i] = joints[i]
            joints_vis_u[i] = joints_vis[i]
            joints_3d_u[i] = joints_3d[i][:, :3]
            joints_3d_vis_u[i] = rec["joints_3d_vis"][i][:, :3]

        return {
            "image": image,
            "target_2d": target.transpose(1, 2, 0),  # (Hh, Wh, J)
            "weights_2d": weight,
            "target_3d": target_3d,
            "trans": trans3.astype(np.float32),
            "orig_wh": np.array([width, height], np.float32),
            "camera": rec["camera"],
            "joints": joints_u,
            "joints_vis": joints_vis_u,
            "joints_3d": joints_3d_u,
            "joints_3d_vis": joints_3d_vis_u,
            "roots_3d": joints_3d_u[:, self.root_id],
            "num_person": nposes,
        }

    # ------------------------------------------------------------- evaluate
    def evaluate(self, preds, roots=None, output_dir: str = ""):
        """Reference evaluation protocol (ref: panoptic.py:293-390)."""
        from selfpose3d_tpu_torch.eval.metrics import panoptic_metrics

        gt_num = self.db_size // self.camera_num_total
        assert len(preds) == gt_num, "number mismatch"
        gt_poses, gt_vis, gt_roots, gt_root_vis = [], [], [], []
        for i in range(gt_num):
            rec = self.db[self.camera_num_total * i]
            gt_poses.append(rec["joints_3d"])
            gt_vis.append(rec["joints_3d_vis"])
            gt_roots.append([a[self.root_id] for a in rec["joints_3d"]])
            gt_root_vis.append(
                [a[self.root_id][0] for a in rec["joints_3d_vis"]]
            )
        m = panoptic_metrics(
            preds, gt_poses, gt_vis,
            roots=roots, gt_roots=gt_roots, gt_root_vis=gt_root_vis,
        )
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            out_file = osp.join(output_dir, "predictions_dump.pkl")
            dump = [dict(self.db[self.camera_num_total * i]) for i in range(gt_num)]
            for i in range(gt_num):
                dump[i]["preds_3d"] = np.asarray(preds[i])
                if roots is not None:
                    dump[i]["roots_3d_pred"] = np.asarray(roots[i])
                # per-view image paths + cameras for the scene renderer
                # (sp3d-visualize --scene; ref tools/visualize.py:544-546
                # reads per-(frame, cam) records)
                dump[i]["views_meta"] = [
                    {
                        "image": self.db[self.camera_num_total * i + c].get("image"),
                        "camera": self.db[self.camera_num_total * i + c].get("camera"),
                    }
                    for c in range(self.camera_num_total)
                ]
            with open(out_file, "wb") as f:
                pickle.dump(dump, f)
        return m
