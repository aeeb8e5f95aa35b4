"""Runnable s2/s4 pseudo-label inference drivers.

The reference runs these two stages with external repos: s2 is a detectron2
Keypoint-RCNN X-101 driver (ref: pseudo_2d_labels_generation/
s2_det2_bbox_inference.py:127-179, producing a COCO detection-results json
via COCOEvaluator) and s4 launches the HRNet repo's top-down test script
over the pseudo-bboxes (ref: s4_hrnet_kpt2d_inference.sh:17-23). This module
makes both stages runnable from here:

  * the DRIVERS own the dataset walk, the top-down crop protocol
    (bbox -> center/scale -> affine crop -> coords mapped back), and the
    exact result-json contracts s3/s5 consume;
  * the MODELS are pluggable callables, with optional-dependency default
    backends (detectron2 / torchvision Keypoint-RCNN for s2; mmpose for s4).
    Any detector/pose model matching the callable signature plugs in —
    including the fakes used by tests/test_data.py's contract tests.

CLI: ``python -m selfpose3d_tpu_torch.pseudo_labels.inference s2|s4 ...``
(see ``main``): the default models run on the card unless ``--device cpu``,
and load their weights from the local file of ``--detector-weights`` /
``--pose-weights`` (nothing is downloaded). The port's copy of
``selfpose3d_tpu/pseudo_labels/inference.py``: images are read and crops
warped with ``utils/image_io`` where the JAX package calls OpenCV.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from selfpose3d_tpu_torch.device import resolve_device
from selfpose3d_tpu_torch.geometry.transforms import (
    affine_transform_point_np,
    get_affine_transform_3x3,
)
from selfpose3d_tpu_torch.utils.image_io import bgr_to_rgb, warp_affine
from selfpose3d_tpu_torch.utils.zipreader import imread_any

# COCO 17-keypoint order; results carry 51 floats (x, y, score) per person
NUM_COCO_KPS = 17


# ---------------------------------------------------------------------------
# default model backends (optional dependencies)
# ---------------------------------------------------------------------------


def _require_weights(path: str, flag: str, what: str) -> None:
    """The default backends load their weights from a local file only: the
    repository holds none, and the port downloads nothing."""
    if not path or not os.path.isfile(path):
        raise FileNotFoundError(
            f"{what} needs its weights as a local file ({flag}; got {path!r}): "
            "the repository holds none and nothing is downloaded. Pass the "
            "file, or pass model=callable to the stage's function."
        )


def _default_detector(device="cuda", weights: str = "") -> Callable:
    """Keypoint-RCNN person detector on ``device``: detectron2 (the
    reference's backend, X-101 FPN) if importable, with its checkpoint at
    ``weights``; else torchvision's keypointrcnn_resnet50_fpn with its
    state dict at ``weights``.

    Returns callable(img_rgb uint8 HxWx3) -> {"boxes" (N,4) xyxy,
    "scores" (N,), "keypoints" (N,17,3)}.
    """
    dev = resolve_device(device)
    _require_weights(weights, "--detector-weights", "s2's default detector")
    try:
        from detectron2 import model_zoo  # type: ignore
        from detectron2.config import get_cfg  # type: ignore
        from detectron2.engine import DefaultPredictor  # type: ignore

        cfg = get_cfg()
        cfg_file = "COCO-Keypoints/keypoint_rcnn_X_101_32x8d_FPN_3x.yaml"
        cfg.merge_from_file(model_zoo.get_config_file(cfg_file))
        cfg.MODEL.WEIGHTS = weights
        cfg.MODEL.DEVICE = str(dev)
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
        pred = DefaultPredictor(cfg)

        def run(img):
            inst = pred(img[:, :, ::-1])["instances"].to("cpu")  # BGR in
            kps = (
                inst.pred_keypoints.numpy()
                if inst.has("pred_keypoints")
                else np.zeros((len(inst), NUM_COCO_KPS, 3), np.float32)
            )
            return {
                "boxes": inst.pred_boxes.tensor.numpy(),
                "scores": inst.scores.numpy(),
                "keypoints": kps,
            }

        return run
    except ImportError:
        pass
    try:
        from torchvision.models.detection import (  # type: ignore
            keypointrcnn_resnet50_fpn,
        )
    except ImportError:
        raise ImportError(
            "s2 needs a detector: install detectron2 or torchvision, or pass "
            "model=callable(img)->{'boxes','scores','keypoints'}"
        )
    model = keypointrcnn_resnet50_fpn(weights=None, weights_backbone=None)
    model.load_state_dict(torch.load(weights, map_location="cpu"))
    model = model.to(dev).eval()

    def run(img):
        with torch.no_grad():
            t = torch.from_numpy(img.astype(np.float32).transpose(2, 0, 1) / 255.0)
            out = {k: v.cpu() for k, v in model([t.to(dev)])[0].items()}
        kp = out["keypoints"].numpy()  # (N, 17, 3) with vis flag
        kp[..., 2] = out["keypoints_scores"].numpy()
        return {
            "boxes": out["boxes"].numpy(),
            "scores": out["scores"].numpy(),
            "keypoints": kp,
        }

    return run


def _default_pose_model(input_wh=(288, 384), device="cuda", weights: str = "") -> Callable:
    """HRNet-style top-down pose model via mmpose, if importable, on
    ``device`` with its checkpoint at ``weights``. Each crop is one
    person's box, so mmpose runs no detector of its own ("whole_image").

    Returns callable(crop_rgb uint8 HxWx3) -> (17, 3) keypoints in CROP
    pixel coordinates with scores.
    """
    dev = resolve_device(device)
    _require_weights(weights, "--pose-weights", "s4's default pose model")
    try:
        from mmpose.apis import MMPoseInferencer  # type: ignore
    except ImportError:
        raise ImportError(
            "s4 needs a top-down pose model: install mmpose, or pass "
            "model=callable(crop)->(17,3)"
        )
    inf = MMPoseInferencer("human", pose2d_weights=weights, det_model="whole_image",
                           device=str(dev))

    def run(crop):
        res = next(inf(crop, return_datasamples=True))
        pred = res["predictions"][0].pred_instances
        kp = np.asarray(pred.keypoints[0])
        sc = np.asarray(pred.keypoint_scores[0])[:, None]
        return np.concatenate([kp, sc], axis=1)

    return run


# ---------------------------------------------------------------------------
# s2: person detection over the s1 image list
# ---------------------------------------------------------------------------


def run_person_detector(
    image_list_json: str,
    image_root: str,
    out_json: str,
    model: Optional[Callable] = None,
    score_floor: float = 0.05,
) -> List[Dict]:
    """s2: detect persons on every s1-listed image -> COCO result json.

    Output contract (what s3 ``create_pseudo_bboxes`` consumes): a LIST of
    ``{"image_id", "category_id": 1, "bbox": [x, y, w, h], "score",
    "keypoints": [51]}`` — the format detectron2's COCOEvaluator writes as
    coco_instances_results.json (ref: s2_det2_bbox_inference.py:85,127).
    """
    if model is None:
        model = _default_detector()
    with open(image_list_json) as f:
        gt = json.load(f)
    results: List[Dict] = []
    for im in gt["images"]:
        path = os.path.join(image_root, im["file_name"])
        img = imread_any(path)
        if img is None:
            continue
        det = model(bgr_to_rgb(img))
        boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(det["scores"], np.float64).reshape(-1)
        kps = np.asarray(det.get("keypoints", np.zeros((len(boxes), NUM_COCO_KPS, 3))),
                         np.float64).reshape(-1, NUM_COCO_KPS, 3)
        for b, s, k in zip(boxes, scores, kps):
            if s < score_floor:
                continue
            x1, y1, x2, y2 = (float(v) for v in b)
            results.append({
                "image_id": im["id"],
                "category_id": 1,
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "score": float(s),
                "keypoints": [float(v) for v in k.reshape(-1)],
            })
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(results, f)
    return results


# ---------------------------------------------------------------------------
# s4: top-down keypoint inference on the pseudo bboxes
# ---------------------------------------------------------------------------


def bbox_center_scale(bbox, aspect_ratio: float, pixel_std: float = 200.0):
    """COCO top-down center/scale convention (the HRNet test pipeline's
    _box2cs; scale carries the 1.25 context padding)."""
    x, y, w, h = (float(v) for v in bbox)
    center = np.array([x + w * 0.5, y + h * 0.5], np.float32)
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    else:
        w = h * aspect_ratio
    scale = np.array([w / pixel_std, h / pixel_std], np.float32) * 1.25
    return center, scale


def run_topdown_keypoints(
    pseudo_bboxes_json: str,
    image_root: str,
    out_json: str,
    model: Optional[Callable] = None,
    input_wh=(288, 384),
) -> List[Dict]:
    """s4: per-pseudo-bbox top-down 2D pose inference -> keypoint json.

    Owns the HRNet test-time crop protocol (USE_GT_BBOX=True path of
    s4_hrnet_kpt2d_inference.sh): bbox -> center/scale -> affine crop to
    ``input_wh`` -> model -> crop coords mapped back to image pixels.

    Output contract (what s5 ``merge_keypoints`` consumes): a LIST of
    ``{"original_id": <ann id>, "keypoints": [51], "center", "scale"}``.
    """
    if model is None:
        model = _default_pose_model(input_wh)
    with open(pseudo_bboxes_json) as f:
        gt = json.load(f)
    id2im = {im["id"]: im for im in gt["images"]}
    in_w, in_h = input_wh
    aspect = in_w / in_h

    cache_path, cache_img = None, None
    results: List[Dict] = []
    for ann in gt["annotations"]:
        im = id2im[ann["image_id"]]
        path = os.path.join(image_root, im["file_name"])
        if path != cache_path:
            img = imread_any(path)
            cache_path, cache_img = path, (None if img is None else bgr_to_rgb(img))
        if cache_img is None:
            continue
        center, scale = bbox_center_scale(ann["bbox"], aspect)
        trans = get_affine_transform_3x3(center, scale, 0, (in_w, in_h))
        crop = warp_affine(cache_img, trans[:2], (in_w, in_h))
        kp = np.asarray(model(crop), np.float64).reshape(NUM_COCO_KPS, 3)
        inv = get_affine_transform_3x3(center, scale, 0, (in_w, in_h), inv=1)
        out_kp = kp.copy()
        for j in range(NUM_COCO_KPS):
            out_kp[j, :2] = affine_transform_point_np(kp[j, :2], inv[:2])
        results.append({
            "original_id": ann["id"],
            "keypoints": [float(v) for v in out_kp.reshape(-1)],
            "center": [float(center[0]), float(center[1])],
            "scale": [float(scale[0]), float(scale[1])],
        })
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(results, f)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="s2/s4 pseudo-label inference")
    sub = p.add_subparsers(dest="stage", required=True)
    s2 = sub.add_parser("s2", help="person detection over the s1 image list")
    s2.add_argument("--image-list", required=True)
    s2.add_argument("--image-root", required=True)
    s2.add_argument("--out", required=True)
    s2.add_argument("--detector-weights", default="",
                    help="the detector's weights: a detectron2 checkpoint where "
                         "detectron2 is installed, else a torchvision "
                         "keypointrcnn_resnet50_fpn state dict")
    s4 = sub.add_parser("s4", help="top-down keypoints on pseudo bboxes")
    s4.add_argument("--pseudo-bboxes", required=True)
    s4.add_argument("--image-root", required=True)
    s4.add_argument("--out", required=True)
    s4.add_argument("--pose-weights", default="", help="the mmpose model's checkpoint")
    for s in (s2, s4):
        s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.stage == "s2":
        model = _default_detector(args.device, args.detector_weights)
        run_person_detector(args.image_list, args.image_root, args.out, model=model)
    else:
        model = _default_pose_model(device=args.device, weights=args.pose_weights)
        run_topdown_keypoints(args.pseudo_bboxes, args.image_root, args.out, model=model)


if __name__ == "__main__":
    main()
