"""Shelf / Campus evaluation datasets and their synthetic training twins.

ShelfCampusDataset (ref: lib/dataset/shelf.py:59-240, campus.py:56-235):
GT from actorsGT.mat, pre-computed 2D predictions drive image-free
input heatmaps, PCP@0.5 evaluation.

SyntheticPoseDataset (ref: lib/dataset/shelf_synthetic.py, campus_synthetic.py):
VoxelPose-style synthetic training — sample 1..max poses from a Panoptic
3D-pose bank, randomly rotate/place them with bbox collision checks, project
to each camera, and emit input heatmaps (no images). The port's copy of
``selfpose3d_tpu/data/shelf_campus.py``.
"""

from __future__ import annotations

import json
import os.path as osp
import pickle
from typing import Dict

import numpy as np

from selfpose3d_tpu_torch.config import Config
from selfpose3d_tpu_torch.data import skeleton
from selfpose3d_tpu_torch.data.targets import (
    generate_3d_target,
    generate_input_heatmap,
)
from selfpose3d_tpu_torch.geometry.cameras_np import project_pose_np
from selfpose3d_tpu_torch.geometry.transforms import (
    get_affine_transform_3x3,
    get_scale,
    affine_transform_point_np,
    rotate_points,
)

_DATASET_SPEC = {
    "shelf": {
        "width": 1032,
        "height": 776,
        "cam_list": ["0", "1", "2", "3", "4"],
        "frame_range": list(range(300, 601)),
        "pred_file": "pred_shelf_maskrcnn_hrnet_coco.pkl",
        "image_fmt": lambda k, i: osp.join(f"Camera{k}", f"img_{i:06d}.png"),
        "calib": "calibration_shelf.json",
    },
    "campus": {
        "width": 360,
        "height": 288,
        "cam_list": ["0", "1", "2"],
        "frame_range": list(range(350, 471)) + list(range(650, 751)),
        "pred_file": "pred_campus_maskrcnn_hrnet_coco.pkl",
        "image_fmt": lambda k, i: osp.join(f"Camera{k}", f"campus4-c{k}-{i:05d}.png"),
        "calib": "calibration_campus.json",
    },
}


class ShelfCampusDataset:
    def __init__(self, cfg: Config, name: str, image_set: str, is_train: bool):
        self.cfg = cfg
        self.name = name
        spec = _DATASET_SPEC[name]
        self.width, self.height = spec["width"], spec["height"]
        self.cam_ids = spec["cam_list"][: cfg.DATASET.CAMERA_NUM or None]
        self.frame_range = spec["frame_range"]
        self.num_joints = cfg.NETWORK.NUM_JOINTS
        self.max_people = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
        self.root_id = cfg.DATASET.ROOTIDX
        self.train_pseudo_gt3d = cfg.DATASET.TRAIN_PSEUDO_GT3D
        self.dataset_root = osp.join(cfg.DATA_DIR, cfg.DATASET.ROOT)

        self.cameras = self._get_cam(spec["calib"])
        self.pred_pose2d = self._get_pred_pose2d(spec["pred_file"])
        self.actor_3d = self._load_actors()
        self.image_fmt = spec["image_fmt"]

    def _get_cam(self, calib_name):
        cam_file = osp.join(self.dataset_root, calib_name)
        with open(cam_file) as f:
            cameras = json.load(f)
        return {
            cid: {k: np.array(v) for k, v in cam.items()}
            for cid, cam in cameras.items()
            if cid in self.cam_ids
        }

    def _get_pred_pose2d(self, pred_name):
        path = osp.join(self.dataset_root, pred_name)
        with open(path, "rb") as f:
            return pickle.load(f)

    def _load_actors(self):
        import scipy.io as scio

        data = scio.loadmat(osp.join(self.dataset_root, "actorsGT.mat"))
        return np.array(
            np.array(data["actor3D"].tolist()).tolist(), dtype="object"
        ).squeeze()

    def __len__(self):
        return len(self.frame_range)

    def get_frame(
        self, idx: int, load_images: bool = False, seed: int = 0
    ) -> Dict:
        """One multi-view frame; heatmaps come from the 2D predictions
        (image-free path, ref: JointsDataset.py:343 + multi_person usage).
        ``seed`` is accepted for loader-API uniformity; this eval dataset
        is deterministic."""
        del seed
        cfg = self.cfg
        fi = self.frame_range[idx]
        img_w, img_h = cfg.NETWORK.IMAGE_SIZE
        views = []
        for cid in self.cam_ids:
            cam = self.cameras[cid]
            c = np.array([self.width / 2.0, self.height / 2.0])
            s = get_scale((self.width, self.height), (img_w, img_h))
            trans3 = get_affine_transform_3x3(c, s, 0, (img_w, img_h))

            preds = self.pred_pose2d.get(f"{cid}_{fi}", [])
            pred_kps = [np.array(p["pred"]) for p in preds]
            if self.train_pseudo_gt3d:
                pred_kps = [skeleton.coco_to_panoptic(p) for p in pred_kps]
            # transform predicted 2D into the input frame
            warped = []
            for kp in pred_kps:
                kp = kp.copy().astype(np.float64)
                for j in range(kp.shape[0]):
                    kp[j, :2] = affine_transform_point_np(kp[j, :2], trans3[:2])
                warped.append(kp)
            if warped:
                input_heatmap = generate_input_heatmap(
                    warped, (img_w, img_h), cfg.NETWORK.HEATMAP_SIZE,
                    float(cfg.NETWORK.SIGMA),
                    use_confidence=("campus" not in self.name),
                ).transpose(1, 2, 0)
            else:
                hm_w, hm_h = cfg.NETWORK.HEATMAP_SIZE
                input_heatmap = np.zeros((hm_h, hm_w, self.num_joints), np.float32)

            # GT (for target generation and num_person)
            gt_poses = []
            for person in range(len(self.actor_3d)):
                gt = self.actor_3d[person][fi] * 1000.0
                if len(gt[0]) > 0:
                    gt_poses.append(np.asarray(gt))
            nposes = len(gt_poses)

            J = self.num_joints
            P = self.max_people
            joints_u = np.zeros((P, J, 2), np.float32)
            joints_vis_u = np.zeros((P, J, 2), np.float32)
            roots_u = np.zeros((P, 3), np.float32)
            # roots from GT via shelf hip midpoint (index 2,3 hips)
            for i, gt in enumerate(gt_poses[:P]):
                roots_u[i] = (gt[2] + gt[3]) / 2.0

            target_3d = generate_3d_target(
                [r for r in roots_u[:nposes]],
                cfg.MULTI_PERSON.SPACE_SIZE,
                cfg.MULTI_PERSON.SPACE_CENTER,
                cfg.MULTI_PERSON.INITIAL_CUBE_SIZE,
            )

            cam_dict = {
                "R": cam["R"], "T": cam["T"],
                "fx": cam["fx"], "fy": cam["fy"],
                "cx": cam["cx"], "cy": cam["cy"],
                "k": cam["k"], "p": cam["p"],
            }
            views.append(
                {
                    "image": None,
                    "input_heatmap": input_heatmap.astype(np.float32),
                    "target_2d": input_heatmap.astype(np.float32),
                    "weights_2d": np.ones((J, 1), np.float32),
                    "target_3d": target_3d,
                    "trans": trans3.astype(np.float32),
                    "orig_wh": np.array([self.width, self.height], np.float32),
                    "camera": cam_dict,
                    "joints": joints_u,
                    "joints_vis": joints_vis_u,
                    "roots_3d": roots_u,
                    "num_person": nposes,
                    "hflip": False,
                }
            )
        return {"views": views, "frame_idx": idx}

    def evaluate(self, preds, roots=None, output_dir: str = ""):
        """PCP protocol (ref: shelf.py:172-240). preds are (K, J, 5) panoptic
        or coco joints; converted to shelf order here."""
        from selfpose3d_tpu_torch.eval.metrics import pcp_evaluate

        shelf_preds = []
        for pred in preds:
            pred = np.asarray(pred)
            pred = pred[pred[:, 0, 3] >= 0][:, :, :3]
            if pred.shape[0] == 0:
                shelf_preds.append(np.zeros((0, 14, 3)))
                continue
            if self.train_pseudo_gt3d or pred.shape[1] == 15:
                conv = [skeleton.panoptic_to_shelf_3d(p) for p in pred]
            else:
                conv = [skeleton.coco_to_shelf_3d(p) for p in pred]
            shelf_preds.append(np.stack(conv))

        actor_frames = []
        for person in range(len(self.actor_3d)):
            actor_frames.append(
                [self.actor_3d[person][fi] * 1000.0 for fi in self.frame_range]
            )
        m = pcp_evaluate(shelf_preds, actor_frames)
        m["aps"] = None  # selection metric is avg_pcp for these datasets
        return m


class SyntheticPoseDataset:
    """Synthetic multi-person training scenes for Shelf/Campus VoxelPose
    training (ref: lib/dataset/shelf_synthetic.py:119-310)."""

    def __init__(self, cfg: Config, name: str, image_set: str = "train",
                 is_train: bool = True, epoch_length: int = 3000):
        self.cfg = cfg
        self.name = name
        spec = _DATASET_SPEC[name]
        self.width, self.height = spec["width"], spec["height"]
        self.cam_ids = spec["cam_list"]
        self.num_joints = cfg.NETWORK.NUM_JOINTS
        self.max_people = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
        self.root_id = cfg.DATASET.ROOTIDX
        self.dataset_root = osp.join(cfg.DATA_DIR, cfg.DATASET.ROOT)
        self.epoch_length = epoch_length

        self.cameras = self._get_cam(spec["calib"])
        gt3d_file = osp.join(self.dataset_root, cfg.DATASET.GT_3D_FILE)
        with open(gt3d_file, "rb") as f:
            self.pose_bank = pickle.load(f)  # list of (J, 3) poses in mm

    _get_cam = ShelfCampusDataset._get_cam

    def __len__(self):
        return self.epoch_length

    @staticmethod
    def isvalid(bbox, bbox_list) -> bool:
        """bbox collision check (ref: shelf_synthetic.py:535-556)."""
        if len(bbox_list) == 0:
            return True
        x0, y0, x1, y1 = bbox
        for b in bbox_list:
            ix = max(0, min(x1, b[2]) - max(x0, b[0]))
            iy = max(0, min(y1, b[3]) - max(y0, b[1]))
            inter = ix * iy
            area_a = (x1 - x0) * (y1 - y0)
            area_b = (b[2] - b[0]) * (b[3] - b[1])
            iou = inter / (area_a + area_b - inter + 1e-8)
            if iou > 0.1:
                return False
        return True

    def get_frame(
        self, idx: int, load_images: bool = False, seed: int = 0
    ) -> Dict:
        cfg = self.cfg
        rs = np.random.RandomState(seed * 99991 + idx)
        img_w, img_h = cfg.NETWORK.IMAGE_SIZE

        nposes = rs.randint(1, min(6, self.max_people + 1))
        space = cfg.MULTI_PERSON.SPACE_SIZE
        center = cfg.MULTI_PERSON.SPACE_CENTER

        poses, bboxes = [], []
        for _ in range(nposes):
            for _try in range(100):
                bank_pose = np.asarray(
                    self.pose_bank[rs.randint(len(self.pose_bank))], np.float64
                )[: self.num_joints, :3].copy()
                rot = rs.uniform(-180, 180)
                new_center = np.array(
                    [
                        rs.uniform(center[0] - space[0] / 3, center[0] + space[0] / 3),
                        rs.uniform(center[1] - space[1] / 3, center[1] + space[1] / 3),
                    ]
                )
                cur_center = bank_pose[self.root_id, :2]
                bank_pose[:, :2] = rotate_points(
                    bank_pose[:, :2], cur_center, rot
                ) - cur_center + new_center
                bb = (
                    bank_pose[:, 0].min(), bank_pose[:, 1].min(),
                    bank_pose[:, 0].max(), bank_pose[:, 1].max(),
                )
                if self.isvalid(bb, bboxes):
                    poses.append(bank_pose)
                    bboxes.append(bb)
                    break
            else:
                break
        nposes = len(poses)

        views = []
        for cid in self.cam_ids:
            cam = self.cameras[cid]
            c = np.array([self.width / 2.0, self.height / 2.0])
            s = get_scale((self.width, self.height), (img_w, img_h))
            trans3 = get_affine_transform_3x3(c, s, 0, (img_w, img_h))

            kps = []
            for pose in poses:
                kp = project_pose_np(pose, cam)
                for j in range(kp.shape[0]):
                    kp[j] = affine_transform_point_np(kp[j], trans3[:2])
                kps.append(kp)
            input_heatmap = (
                generate_input_heatmap(
                    kps, (img_w, img_h), cfg.NETWORK.HEATMAP_SIZE,
                    float(cfg.NETWORK.SIGMA), use_confidence=False,
                ).transpose(1, 2, 0)
                if kps
                else np.zeros(
                    (cfg.NETWORK.HEATMAP_SIZE[1], cfg.NETWORK.HEATMAP_SIZE[0], self.num_joints),
                    np.float32,
                )
            )

            J, P = self.num_joints, self.max_people
            joints_u = np.zeros((P, J, 2), np.float32)
            joints_vis_u = np.zeros((P, J, 2), np.float32)
            roots_u = np.zeros((P, 3), np.float32)
            j3_u = np.zeros((P, J, 3), np.float32)
            j3v_u = np.zeros((P, J, 3), np.float32)
            for i, (pose, kp) in enumerate(zip(poses, kps)):
                joints_u[i] = kp[:J]
                joints_vis_u[i] = 1.0
                roots_u[i] = pose[self.root_id]
                j3_u[i] = pose[:J]
                j3v_u[i] = 1.0

            target_3d = generate_3d_target(
                [p[self.root_id] for p in poses],
                cfg.MULTI_PERSON.SPACE_SIZE,
                cfg.MULTI_PERSON.SPACE_CENTER,
                cfg.MULTI_PERSON.INITIAL_CUBE_SIZE,
            )

            cam_dict = {
                "R": cam["R"], "T": cam["T"],
                "fx": cam["fx"], "fy": cam["fy"],
                "cx": cam["cx"], "cy": cam["cy"],
                "k": cam["k"], "p": cam["p"],
            }
            views.append(
                {
                    "image": None,
                    "input_heatmap": input_heatmap.astype(np.float32),
                    "target_2d": input_heatmap.astype(np.float32),
                    "weights_2d": np.ones((J, 1), np.float32),
                    "target_3d": target_3d,
                    "trans": trans3.astype(np.float32),
                    "orig_wh": np.array([self.width, self.height], np.float32),
                    "camera": cam_dict,
                    "joints": joints_u,
                    "joints_vis": joints_vis_u,
                    "joints_3d": j3_u,
                    "joints_3d_vis": j3v_u,
                    "roots_3d": roots_u,
                    "num_person": nposes,
                    "hflip": False,
                }
            )
        return {"views": views, "frame_idx": idx}
