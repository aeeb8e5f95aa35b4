"""Skeleton definitions and joint-format converters (the port's own copy
of ``selfpose3d_tpu/data/skeleton.py``, numpy).

Panoptic 15-joint skeleton (ref: lib/dataset/panoptic.py:39-77), Shelf/Campus
14-joint skeleton, and COCO-17 conversions used by the pseudo-label pipeline
(ref: pseudo_2d_labels_generation/s7_create_pseudo_kpt2d_dbpickle.py:69-108,
lib/dataset/shelf.py:242-330).
"""

from __future__ import annotations

import numpy as np

PANOPTIC_JOINTS = {
    "neck": 0, "nose": 1, "mid-hip": 2,
    "l-shoulder": 3, "l-elbow": 4, "l-wrist": 5,
    "l-hip": 6, "l-knee": 7, "l-ankle": 8,
    "r-shoulder": 9, "r-elbow": 10, "r-wrist": 11,
    "r-hip": 12, "r-knee": 13, "r-ankle": 14,
}
NUM_PANOPTIC_JOINTS = 15
FLIP_LR_JOINTS15 = [0, 1, 2, 9, 10, 11, 12, 13, 14, 3, 4, 5, 6, 7, 8]

PANOPTIC_LIMBS = [
    [0, 1], [0, 2], [0, 3], [3, 4], [4, 5], [0, 9], [9, 10], [10, 11],
    [2, 6], [2, 12], [6, 7], [7, 8], [12, 13], [13, 14],
]

PANOPTIC_TRAIN_LIST = [
    "160422_ultimatum1", "160224_haggling1", "160226_haggling1",
    "161202_haggling1", "160906_ian1", "160906_ian2", "160906_ian3",
    "160906_band1", "160906_band2",
]
PANOPTIC_VAL_LIST = [
    "160906_pizza1", "160422_haggling1", "160906_ian5", "160906_band4",
]
PANOPTIC_CAM_LIST = [(0, 3), (0, 6), (0, 12), (0, 13), (0, 23)]

# COCO keypoint order (detectron/HRNet outputs)
COCO_JOINTS = [
    "nose", "l-eye", "r-eye", "l-ear", "r-ear",
    "l-shoulder", "r-shoulder", "l-elbow", "r-elbow",
    "l-wrist", "r-wrist", "l-hip", "r-hip",
    "l-knee", "r-knee", "l-ankle", "r-ankle",
]

# Shelf/Campus 14-joint order: r-ankle..l-hip legs then arms then neck/head
SHELF_JOINTS = [
    "r-ankle", "r-knee", "r-hip", "l-hip", "l-knee", "l-ankle",
    "r-wrist", "r-elbow", "r-shoulder", "l-shoulder", "l-elbow", "l-wrist",
    "bottom-head", "top-head",
]
SHELF_LIMBS = [
    [0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [7, 8],
    [9, 10], [10, 11], [12, 13],
]


def coco_to_panoptic(coco_kps: np.ndarray) -> np.ndarray:
    """COCO-17 (J, >=2) -> Panoptic-15, synthesizing neck and mid-hip
    (ref: s7_create_pseudo_kpt2d_dbpickle.py:69-108)."""
    coco = np.asarray(coco_kps, dtype=np.float32)
    out = np.zeros((15,) + coco.shape[1:], dtype=np.float32)
    # direct mappings
    mapping = {
        1: 0,  # nose
        3: 5, 4: 7, 5: 9,       # left arm
        6: 11, 7: 13, 8: 15,    # left leg
        9: 6, 10: 8, 11: 10,    # right arm
        12: 12, 13: 14, 14: 16, # right leg
    }
    for pan, coco_i in mapping.items():
        out[pan] = coco[coco_i]
    out[0] = 0.5 * (coco[5] + coco[6])  # neck = mid shoulders
    out[2] = 0.5 * (coco[11] + coco[12])  # mid-hip
    return out


def _shelf_head_interp(shelf: np.ndarray, nose: np.ndarray,
                       mid_sho: np.ndarray, head_center: np.ndarray) -> np.ndarray:
    """Shared head-joint interpolation (ref: lib/dataset/shelf.py:258-270)."""
    head_bottom = (mid_sho + head_center) / 2.0
    head_top = head_bottom + (head_center - head_bottom) * 2.0
    shelf[12] = (shelf[8] + shelf[9]) / 2.0
    shelf[13] = nose
    shelf[13] = shelf[12] + (shelf[13] - shelf[12]) * np.array([0.75, 0.75, 1.5])
    shelf[12] = shelf[12] + (nose - shelf[12]) * np.array([0.5, 0.5, 0.5])
    alpha = 0.75
    shelf[13] = shelf[13] * alpha + head_top * (1 - alpha)
    shelf[12] = shelf[12] * alpha + head_bottom * (1 - alpha)
    return shelf


def coco_to_shelf_3d(coco_pose: np.ndarray) -> np.ndarray:
    """COCO-17 3D pose -> Shelf-14 with head interpolation
    (ref: lib/dataset/shelf.py:242-271)."""
    coco = np.asarray(coco_pose, dtype=np.float64)
    shelf = np.zeros((14, 3), dtype=np.float64)
    order = [16, 14, 12, 11, 13, 15, 10, 8, 6, 5, 7, 9]
    shelf[:12] = coco[order]
    mid_sho = (coco[5] + coco[6]) / 2.0
    head_center = (coco[3] + coco[4]) / 2.0
    return _shelf_head_interp(shelf, coco[0], mid_sho, head_center)


def panoptic_to_shelf_3d(pan_pose: np.ndarray) -> np.ndarray:
    """Panoptic-15 3D pose -> Shelf-14 (ref: lib/dataset/shelf.py:273-303)."""
    pan = np.asarray(pan_pose, dtype=np.float64)
    shelf = np.zeros((14, 3), dtype=np.float64)
    order = [14, 13, 12, 6, 7, 8, 11, 10, 9, 3, 4, 5]
    shelf[:12] = pan[order]
    mid_sho = (pan[3] + pan[9]) / 2.0
    head_center = pan[1]  # nose
    return _shelf_head_interp(shelf, pan[1], mid_sho, head_center)
