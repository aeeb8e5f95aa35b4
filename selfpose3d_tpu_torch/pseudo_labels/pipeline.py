"""Offline pseudo-2D-label generation pipeline.

Re-implementation of the reference's 8-stage pipeline
(ref: pseudo_2d_labels_generation/s1..s8):

  s1 create_image_list       train DB pickle -> COCO-format image list
  s2 (external)              person-detector inference (Keypoint-RCNN X-101)
  s3 create_pseudo_bboxes    filter detections -> pseudo-bbox COCO json
  s4 (external)              top-down 2D pose inference (HRNet-W48 384x288)
  s5 merge_keypoints         merge HRNet kps into anns with thresholds
  s6 visualize               overlay pseudo 2D poses (utils/vis.py)
  s7 create_db_pickles       COCO-17 -> Panoptic-15, 4 DB pickles
                             (hrnet/krcnn x hard/soft)
  s8 compare vs GT           visualization (utils/vis.py)

The external inference stages (s2/s4) depend on detectron2/HRNet models that
live outside this framework; they are consumed through their standard COCO
result-json formats, so any detector/pose model producing those files plugs
in. All transformation stages here are pure python/numpy. The port's copy
of ``selfpose3d_tpu/pseudo_labels/pipeline.py``; image sizes are read with
``utils/zipreader.imread_any`` where the JAX package calls ``cv2.imread``.
"""

from __future__ import annotations

import json
import os
import pickle
from copy import deepcopy
from typing import Dict, List, Optional, Tuple

import numpy as np

from selfpose3d_tpu_torch.utils.zipreader import imread_any

COCO_KEYPOINT_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]
PANOPTIC_JOINT_NAMES = [
    "neck", "nose", "mid-hip",
    "l-shoulder", "l-elbow", "l-wrist", "l-hip", "l-knee", "l-ankle",
    "r-shoulder", "r-elbow", "r-wrist", "r-hip", "r-knee", "r-ankle",
]
_PAN2COCO_NAME = {
    "nose": "nose",
    "l-shoulder": "left_shoulder", "l-elbow": "left_elbow", "l-wrist": "left_wrist",
    "l-hip": "left_hip", "l-knee": "left_knee", "l-ankle": "left_ankle",
    "r-shoulder": "right_shoulder", "r-elbow": "right_elbow", "r-wrist": "right_wrist",
    "r-hip": "right_hip", "r-knee": "right_knee", "r-ankle": "right_ankle",
}


def create_image_list(train_db_path: str, out_file: str, image_sizes: Optional[Dict[str, Tuple[int, int]]] = None):
    """s1: DB pickle -> COCO image-info json (ref: s1_create_json.py:18-74).

    ``image_sizes`` maps image path -> (height, width); when omitted, images
    are read from disk (1080 x 1920 for an unreadable one).
    """
    with open(train_db_path, "rb") as f:
        data = pickle.load(f)["db"]
    out = {"annotations": [], "images": [], "categories": []}
    for ii, d in enumerate(data):
        if image_sizes and d["image"] in image_sizes:
            height, width = image_sizes[d["image"]]
        else:
            img = imread_any(d["image"])
            height, width = (img.shape[:2] if img is not None else (1080, 1920))
        out["images"].append(
            {
                "file_name": d["image"], "id": ii, "height": height,
                "width": width, "key": d["key"], "url": d["image"],
            }
        )
        out["annotations"].append(
            {
                "id": ii, "image_id": ii, "category_id": 1, "score": 1,
                "keypoints": [0] * 51, "iscrowd": 0, "area": 0, "bbox": [0] * 4,
            }
        )
    out["categories"].append(
        {"supercategory": "person", "id": 1, "name": "person",
         "keypoints": COCO_KEYPOINT_NAMES}
    )
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    with open(out_file, "w") as f:
        json.dump(out, f)
    return out


def create_pseudo_bboxes(
    image_list_json: str, detections_json: str, out_file: str,
    score_threshold: float = 0.7,
):
    """s3: filter person detections into pseudo-bbox anns
    (ref: s3_create_pseudo_bboxes.py:17-56)."""
    with open(image_list_json) as f:
        gt = json.load(f)
    with open(detections_json) as f:
        dets = json.load(f)
    dets = [d for d in dets if d["category_id"] == 1 and d["score"] > score_threshold]
    for index, ann in enumerate(dets):
        ann["id"] = index + 1
        ann["num_keypoints"] = 0
        ann["keypoints_krcnn"] = deepcopy(ann.get("keypoints", [0] * 51))
        ann["keypoints"] = [0] * 51
        ann["area"] = ann["bbox"][2] * ann["bbox"][3]
        ann["iscrowd"] = 0
    gt["annotations"] = dets
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    with open(out_file, "w") as f:
        json.dump(gt, f)
    return gt


def _filter_kps_in_bbox(kpts, x1, y1, x2, y2, thresh=0.05):
    """Per-keypoint score threshold + in-bbox check
    (ref: s5_create_pseudo_kpt2d.py:17-43)."""
    pose = np.array(kpts).reshape(-1, 3)
    score = np.where(pose[:, 2] < thresh, 0, 2)
    num_kps = int(np.sum(score == 2))
    f_kps: List[float] = []
    count = 0
    if num_kps > 3:
        for p in range(pose.shape[0]):
            if score[p] == 2:
                xx, yy = float(pose[p, 0]), float(pose[p, 1])
                if x1 <= xx <= x2 and y1 <= yy <= y2:
                    f_kps += [xx, yy, 2.0]
                    count += 1
                else:
                    f_kps += [0.0, 0.0, 0.0]
            else:
                f_kps += [0.0, 0.0, 0.0]
    return f_kps, count


def merge_keypoints(
    pseudo_bboxes_json: str, keypoints_json: str, out_file: str,
    kp_threshold: float = 0.05, min_kps: int = 3,
):
    """s5: merge top-down keypoints into the pseudo anns
    (ref: s5_create_pseudo_kpt2d.py:48-113)."""
    with open(keypoints_json) as f:
        kpt = {a["original_id"]: a for a in json.load(f)}
    with open(pseudo_bboxes_json) as f:
        gt = json.load(f)
    id2im = {k["id"]: k for k in gt["images"]}

    for ann in gt["annotations"]:
        if ann["id"] not in kpt:
            ann["delete"] = 1
            continue
        im = id2im[ann["image_id"]]
        x, y, w, h = ann["bbox"]
        x1, y1 = max(0, x), max(0, y)
        x2 = min(im["width"] - 1, x1 + max(0, w - 1))
        y2 = min(im["height"] - 1, y1 + max(0, h - 1))
        kp = kpt[ann["id"]]
        if ann["area"] > 0 and x2 >= x1 and y2 >= y1:
            ann["bbox"] = [float(x), float(y), float(w), float(h)]
            ann["delete"] = 0
            ann["keypoints_soft"] = kp["keypoints"]
            ann["center"] = kp.get("center")
            ann["scale"] = kp.get("scale")
            ann["keypoints_krcnn_soft"] = deepcopy(ann["keypoints_krcnn"])
            f_kps, n = _filter_kps_in_bbox(kp["keypoints"], x1, y1, x2, y2, kp_threshold)
            f_krc, n_k = _filter_kps_in_bbox(ann["keypoints_krcnn"], x1, y1, x2, y2, kp_threshold)
            if n >= min_kps:
                ann["keypoints"], ann["num_keypoints"] = f_kps, n
            else:
                ann["keypoints"], ann["num_keypoints"] = [0] * 51, 0
            if n_k >= min_kps:
                ann["keypoints_krcnn"], ann["num_keypoints_krcnn"] = f_krc, n_k
            else:
                ann["keypoints_krcnn"], ann["num_keypoints_krcnn"] = [0] * 51, 0
        else:
            ann["delete"] = 1

    gt["annotations"] = [a for a in gt["annotations"] if a.get("delete") == 0]
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    with open(out_file, "w") as f:
        json.dump(gt, f)
    return gt


def _coco_to_panoptic_ann(kp, mapping):
    """COCO-17 (x,y,s)*17 -> Panoptic-15 2D + vis, synthesizing neck/mid-hip
    from whichever side is visible (ref: s7:69-108)."""
    kp_np = np.array(kp, dtype=np.float64).reshape(-1, 3)

    def midpoint(a_name, b_name):
        a = kp_np[COCO_KEYPOINT_NAMES.index(a_name)]
        b = kp_np[COCO_KEYPOINT_NAMES.index(b_name)]
        if a[2] > 0 and b[2] > 0:
            m = (a + b) / 2.0
            m[2] = 2.0
            return m
        if a[2] > 0:
            out = a.copy()
            out[2] = 2.0
            return out
        if b[2] > 0:
            out = b.copy()
            out[2] = 2.0
            return out
        return np.zeros(3)

    rows = []
    for name in PANOPTIC_JOINT_NAMES:
        if name == "neck":
            rows.append(midpoint("left_shoulder", "right_shoulder"))
        elif name == "mid-hip":
            rows.append(midpoint("left_hip", "right_hip"))
        else:
            rows.append(kp_np[COCO_KEYPOINT_NAMES.index(_PAN2COCO_NAME[name])])
    kp_po = np.stack(rows)
    joints_2d = kp_po[:, :2]
    vis = (kp_po[:, 2:] > 0)
    return joints_2d, np.concatenate([vis, vis], axis=1)


def create_db_pickles(
    train_db_path: str, pseudo_json: str, out_dir: str,
    suffix: str = "9videos",
):
    """s7: emit the 4 pseudo-label DB pickles
    (ref: s7_create_pseudo_kpt2d_dbpickle.py:137-198)."""
    with open(train_db_path, "rb") as f:
        gt_data = pickle.load(f)
    with open(pseudo_json) as f:
        pseudo = json.load(f)
    dets: Dict[int, list] = {k["id"]: [] for k in pseudo["images"]}
    for d in pseudo["annotations"]:
        dets[d["image_id"]].append(d)

    variants = {
        "hrnet_hard": "keypoints",
        "hrnet_soft": "keypoints_soft",
        "krcnn_hard": "keypoints_krcnn",
        "krcnn_soft": "keypoints_krcnn_soft",
    }
    outs = {
        v: {
            "interval": gt_data["interval"],
            "cam_list": gt_data["cam_list"],
            "sequence_list": gt_data["sequence_list"],
            "db": [],
        }
        for v in variants
    }

    for ii, ds in enumerate(gt_data["db"]):
        key = ds["key"]
        assert key == pseudo["images"][ii]["key"]
        anns = dets[pseudo["images"][ii]["id"]]
        shared = {
            "bboxes": [a["bbox"] for a in anns],
            "scores": [a["score"] for a in anns],
            "centers": [a.get("center") for a in anns],
            "scales": [a.get("scale") for a in anns],
        }
        for variant, kp_key in variants.items():
            j2d, j2dv = [], []
            for a in anns:
                jj, vv = _coco_to_panoptic_ann(a[kp_key], None)
                j2d.append(jj)
                j2dv.append(vv)
            outs[variant]["db"].append(
                {
                    "key": key,
                    "image": pseudo["images"][ii]["file_name"],
                    "height": pseudo["images"][ii]["height"],
                    "width": pseudo["images"][ii]["width"],
                    "camera": ds["camera"],
                    "joints_2d": j2d,
                    "joints_2d_vis": j2dv,
                    **shared,
                }
            )

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for variant in variants:
        path = os.path.join(
            out_dir, f"group_train_cam5_pseudo_{variant}_{suffix}.pkl"
        )
        with open(path, "wb") as f:
            pickle.dump(outs[variant], f)
        paths[variant] = path
    return paths
