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
  * the MODELS are pluggable callables. s2's default backends are optional
    dependencies (detectron2 / torchvision Keypoint-RCNN); s4's default is
    the port's own HRNet-W48 (``models/pose_hrnet.py``), run in batches on
    the device by ``topdown_keypoints`` (crops, network with the flip test,
    decode). Any detector/pose model matching the callable signature plugs
    in, including the fakes used by tests/test_data.py's contract tests.

CLI: ``python -m selfpose3d_tpu_torch.pseudo_labels.inference s2|s4 ...``
(see ``main``): the default models run on the card unless ``--device cpu``,
and load their weights from the local file of ``--detector-weights`` /
``--pose-weights`` (nothing is downloaded). The port's copy of
``selfpose3d_tpu/pseudo_labels/inference.py``: images are read and crops
warped with ``utils/image_io`` where the JAX package calls OpenCV; s4's
default model and its batched path are the port's own.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from selfpose3d_tpu_torch.device import device_constant, resolve_device
from selfpose3d_tpu_torch.geometry.transforms import (
    affine_transform_point_np,
    get_affine_transform_3x3,
)
from selfpose3d_tpu_torch.utils import graphs, spans
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


# ImageNet statistics the HRNet test pipeline normalises the RGB crops with
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def s4_config(overrides: Optional[dict] = None):
    """The configuration of s4's model: HRNet-W48 at 384x288 with the
    published test flags (experiments/coco/hrnet/w48_384x288_adam_lr1e-3.yaml:
    FLIP_TEST, SHIFT_HEATMAP, POST_PROCESS), ``overrides`` laid over it."""
    from selfpose3d_tpu_torch.config import load_config
    from selfpose3d_tpu_torch.models.pose_hrnet import W48_EXTRA

    base = {
        "BACKBONE_MODEL": "pose_hrnet",
        "MODEL": "pose_hrnet",
        "MODEL_EXTRA": W48_EXTRA,
        "NETWORK": {"NUM_JOINTS": NUM_COCO_KPS, "IMAGE_SIZE": [288, 384],
                    "HEATMAP_SIZE": [72, 96], "SIGMA": 3},
        "TEST": {"FLIP_TEST": True, "SHIFT_HEATMAP": True, "POST_PROCESS": True,
                 "USE_GT_BBOX": True},
        "DATASET": {"COLOR_RGB": True},
    }
    for k, v in (overrides or {}).items():
        base[k] = {**base[k], **v} if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return load_config(overrides=base)


def default_pose_model(cfg=None, device="cuda", weights: str = ""):
    """The port's HRNet (``cfg``, default ``s4_config()``) on ``device``, in
    eval mode, with its weights from ``weights``, a checkpoint in the HRNet
    repository's layout (``train/checkpoint.py:load_pose_hrnet``); the
    random initialisation of ``get_model`` where no file is given."""
    from selfpose3d_tpu_torch.models import get_model
    from selfpose3d_tpu_torch.train.checkpoint import load_pose_hrnet

    model = get_model(cfg or s4_config(), device=device)
    if weights:
        load_pose_hrnet(model, weights)
    return model


def box_center_scale(boxes: torch.Tensor, aspect_ratio: float, pixel_std: float = 200.0):
    """``bbox_center_scale`` of (N, 4) xywh boxes on their device -> center
    (N, 2), scale (N, 2), float32."""
    boxes = boxes.float()
    x, y, w, h = boxes.unbind(-1)
    center = torch.stack([x + w * 0.5, y + h * 0.5], -1)
    wide = w > aspect_ratio * h
    w, h = torch.where(wide, w, h * aspect_ratio), torch.where(wide, w / aspect_ratio, h)
    return center, torch.stack([w / pixel_std, h / pixel_std], -1) * 1.25


def _pixel_ratio(scale: torch.Tensor, out_wh) -> torch.Tensor:
    """Source pixels an output pixel spans under ``get_affine_transform`` at
    rotation 0 (its wider side sets it), float64 (N,)."""
    src = scale.double() * 200.0
    return torch.where(src[:, 0] >= src[:, 1], src[:, 0] / out_wh[0], src[:, 1] / out_wh[1])


def crop_levels(frames: torch.Tensor, frame_of: torch.Tensor, center: torch.Tensor,
                scale: torch.Tensor, out_wh) -> torch.Tensor:
    """The crops of s4's protocol on the frames' device: output pixel (u, v)
    of crop n samples frame ``frame_of[n]`` (uint8 (F, H, W, C)) bilinearly at
    the inverse of ``get_affine_transform(center[n], scale[n], 0, out_wh)``,
    a tap outside the frame counting as 0, the blend rounded half to even
    as ``utils/image_io.warp_affine`` does -> (N, h, w, C) float32 levels.
    At rotation 0 the map is separable: coordinates are (N, w) and (N, h)
    vectors, in float64 as ``warp_affine``'s."""
    w, h = out_wh
    _, H, W, C = frames.shape
    N = center.shape[0]
    r = _pixel_ratio(scale, out_wh)[:, None]
    dev = frames.device
    sx = center[:, :1].double() + (torch.arange(w, device=dev, dtype=torch.float64) - w / 2) * r
    sy = center[:, 1:].double() + (torch.arange(h, device=dev, dtype=torch.float64) - h / 2) * r
    x0, y0 = sx.floor(), sy.floor()
    fx = (sx - x0).float()[:, None, :, None]
    fy = (sy - y0).float()[:, :, None, None]
    x0, y0 = x0.long(), y0.long()
    flat = frames.reshape(-1, C)
    rows = frame_of.long()[:, None] * H

    def tap(dy: int, dx: int) -> torch.Tensor:
        xs, ys = x0 + dx, y0 + dy
        ok = ((ys >= 0) & (ys < H))[:, :, None] & ((xs >= 0) & (xs < W))[:, None, :]
        idx = ((rows + ys.clamp(0, H - 1)) * W)[:, :, None] + xs.clamp(0, W - 1)[:, None, :]
        return flat[idx.reshape(-1)].view(N, h, w, C).float() * ok[..., None]

    v00, v01, v10, v11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    return torch.round(top + fy * (bot - top)).clamp_(0.0, 255.0)


def normalize_crops(levels: torch.Tensor) -> torch.Tensor:
    """/255, then the ImageNet mean and std of the RGB channels."""
    mean = device_constant(IMAGENET_MEAN, torch.float32, levels.device)
    std = device_constant(IMAGENET_STD, torch.float32, levels.device)
    return (levels / 255.0 - mean) / std


def flip_permutation(num_joints: int) -> List[int]:
    """The joint each flipped heatmap channel holds: COCO's left/right pairs swapped."""
    from selfpose3d_tpu_torch.models.pose_hrnet import COCO_FLIP_PAIRS

    if num_joints != NUM_COCO_KPS:
        raise ValueError(f"the flip test knows COCO's {NUM_COCO_KPS} joints, not {num_joints}")
    perm = list(range(num_joints))
    for a, b in COCO_FLIP_PAIRS:
        perm[a], perm[b] = b, a
    return perm


def _flip_test_heatmaps(model, crops: torch.Tensor, flip: bool, shift: bool) -> torch.Tensor:
    """The network on (N, h, w, 3) crops -> (N, h/4, w/4, J) heatmaps; with
    ``flip`` the published flip test: the mirrored crops in the same batch,
    their heatmaps mirrored back with the left/right joints swapped (and,
    with ``shift``, moved one column right, column 0 kept), averaged with
    the others."""
    if not flip:
        return model(crops)
    n = crops.shape[0]
    hm = model(torch.cat([crops, crops.flip(2)]))
    perm = device_constant(flip_permutation(hm.shape[-1]), torch.long, hm.device)
    back = hm[n:].flip(2).index_select(3, perm)
    if shift:
        back = torch.cat([back[:, :, :1], back[:, :, :-1]], dim=2)
    return (hm[:n] + back) * 0.5


def decode_heatmaps(hm: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
                    post: bool = True) -> torch.Tensor:
    """HRNet's ``get_final_preds`` on the heatmaps' device: (N, H, W, J)
    heatmaps -> (N, J, 3) image-pixel keypoints with their maxima. The first
    maximum's pixel (the origin where the maximum is not positive); with
    ``post`` a quarter pixel toward the larger neighbour of each axis where
    the pixel lies inside the border; mapped to the image through the
    inverse affine of the heatmap's size."""
    N, H, W, J = hm.shape
    flat = hm.permute(0, 3, 1, 2).reshape(N, J, H * W)
    maxval, idx = flat.max(dim=-1)
    pos = (maxval > 0).float()
    x = (idx % W).float() * pos
    y = torch.div(idx, W, rounding_mode="floor").float() * pos
    if post:
        px, py = torch.floor(x + 0.5).long(), torch.floor(y + 0.5).long()
        inside = (px > 1) & (px < W - 1) & (py > 1) & (py < H - 1)
        at = py.clamp(1, H - 2) * W + px.clamp(1, W - 2)

        def step(off: int) -> torch.Tensor:
            d = flat.gather(-1, (at + off)[..., None]) - flat.gather(-1, (at - off)[..., None])
            return torch.where(inside, torch.sign(d[..., 0]) * 0.25, torch.zeros_like(x))

        x, y = x + step(1), y + step(W)
    r = _pixel_ratio(scale, (W, H)).float()[:, None]
    xi = center[:, :1] + (x - W / 2) * r
    yi = center[:, 1:] + (y - H / 2) * r
    return torch.stack([xi, yi, maxval], -1)


@spans.span("sp3d.infer")
def topdown_keypoints(model, frames: torch.Tensor, boxes: torch.Tensor, frame_of: torch.Tensor,
                      flip: bool = True, shift: bool = True, post: bool = True,
                      keep: bool = False):
    """s4 on the card for a batch: ``frames`` (F, H, W, 3) uint8 RGB, ``boxes``
    (N, 4) xywh pseudo-boxes, ``frame_of`` (N,) the frame of each box (host
    tensors, pinned for an asynchronous copy, or on the model's device) ->
    (N, 17, 3) keypoints in image pixels with scores, on the host.

    One call: the copies to the device, each box cropped there to the
    model's input (``sp3d.crops``: ``box_center_scale``, ``crop_levels``,
    ``normalize_crops``), the network with the flip test (``sp3d.hrnet``,
    replayed as a CUDA graph from a crop count's third call on,
    ``utils/graphs.py``), the decode (``sp3d.keypoints``), and one copy of
    the keypoints to the host, which ends the call; the host waits for the
    device nowhere else. ``keep`` also returns the normalized crops and the
    averaged heatmaps, on the device."""
    dev = next(model.parameters()).device
    in_h, in_w = model.input_hw
    graphs.set_training(model, False)
    with torch.no_grad(), graphs.entry(model):
        with spans.span("sp3d.crops"):
            frames = frames.to(dev, non_blocking=True)
            boxes = boxes.to(dev, non_blocking=True)
            frame_of = frame_of.to(dev, non_blocking=True)
            center, scale = box_center_scale(boxes, in_w / in_h)
            crops = normalize_crops(crop_levels(frames, frame_of, center, scale, (in_w, in_h)))
        with spans.span("sp3d.hrnet"):
            hm = graphs.run("hrnet", model, _flip_test_heatmaps, crops, flip, shift)
        with spans.span("sp3d.keypoints"):
            kp = decode_heatmaps(hm, center, scale, post).to("cpu")
    return (kp, crops, hm) if keep else kp


def run_topdown_keypoints(
    pseudo_bboxes_json: str,
    image_root: str,
    out_json: str,
    model: Optional[Callable] = None,
    input_wh=(288, 384),
    cfg=None,
    device="cuda",
    weights: str = "",
) -> List[Dict]:
    """s4: per-pseudo-bbox top-down 2D pose inference -> keypoint json.

    Owns the HRNet test-time crop protocol (USE_GT_BBOX=True path of
    s4_hrnet_kpt2d_inference.sh): bbox -> center/scale -> affine crop to
    ``input_wh`` -> model -> crop coords mapped back to image pixels.

    ``model=None`` runs the port's HRNet (``default_pose_model(cfg, device,
    weights)``, ``cfg`` default ``s4_config()``; its IMAGE_SIZE sets the
    crop) through ``topdown_keypoints``, the images read in annotation order
    and grouped into calls by ``topdown_calls``. The test flags of ``cfg`` (FLIP_TEST, SHIFT_HEATMAP, POST_PROCESS) steer
    it. A callable ``model(crop_rgb uint8) -> (17, 3)`` keypoints in crop
    pixels runs one crop at a time, warped on the host (``utils/image_io``).

    Output contract (what s5 ``merge_keypoints`` consumes): a LIST of
    ``{"original_id": <ann id>, "keypoints": [51], "center", "scale"}``.
    """
    with open(pseudo_bboxes_json) as f:
        gt = json.load(f)
    if model is None:
        cfg = cfg or s4_config()
        net = default_pose_model(cfg, device, weights)
        return _run_batched(gt, image_root, out_json, net, cfg)
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
        results.append(_result(ann, out_kp, center, scale))
    _write_json(out_json, results)
    return results


def _result(ann: dict, kp: np.ndarray, center, scale) -> Dict:
    return {
        "original_id": ann["id"],
        "keypoints": [float(v) for v in np.asarray(kp, np.float64).reshape(-1)],
        "center": [float(center[0]), float(center[1])],
        "scale": [float(scale[0]), float(scale[1])],
    }


def _write_json(out_json: str, results: List[Dict]) -> None:
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(results, f)


# images a call of the batched s4 path: 8 frame sets of 5 HD views, the
# batch the benchmark's s4 cell measures
IMAGES_PER_CALL = 40
# a call's crop count is padded up to a multiple of this: few counts recur
# (each captures a graph of its own), and a call computes at most
# CROP_STEP - 1 crops for nothing
CROP_STEP = 8


def topdown_calls(images: Iterable[Tuple[np.ndarray, Sequence, Sequence]]
                  ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, list]]:
    """The calls of the batched s4 path: ``(image (H, W, 3) uint8 RGB, boxes
    (k, 4) xywh, keys (k,))`` items, in their order, grouped into
    ``IMAGES_PER_CALL`` images of one size a call -> ``(frames (F, H, W, 3)
    uint8, boxes (n, 4) float32, frame_of (n,) int64, keys)`` host tensors,
    pinned where CUDA is available, for ``topdown_keypoints``. The boxes are
    padded up to a multiple of ``CROP_STEP`` with unit boxes on frame 0,
    whose keypoints are computed and dropped: the call's first
    ``len(keys)`` keypoints are those of ``keys``."""
    pin = torch.cuda.is_available()
    frames: List[torch.Tensor] = []
    boxes: List[list] = []
    frame_of: List[int] = []
    keys: list = []

    def call():
        n = -(-len(keys) // CROP_STEP) * CROP_STEP
        out = torch.empty((len(frames), *frames[0].shape), dtype=torch.uint8, pin_memory=pin)
        torch.stack(frames, out=out)
        b = torch.zeros((n, 4), dtype=torch.float32, pin_memory=pin)
        b[:, 2:] = 1.0
        b[: len(keys)] = torch.tensor(boxes, dtype=torch.float32).reshape(-1, 4)
        f = torch.zeros(n, dtype=torch.int64, pin_memory=pin)
        f[: len(keys)] = torch.tensor(frame_of, dtype=torch.int64)
        return out, b, f, list(keys)

    for image, image_boxes, image_keys in images:
        image = torch.as_tensor(image)
        if frames and (image.shape != frames[0].shape or len(frames) == IMAGES_PER_CALL):
            if keys:
                yield call()
            frames, boxes, frame_of, keys = [], [], [], []
        frames.append(image)
        boxes.extend([float(v) for v in b] for b in image_boxes)
        frame_of.extend([len(frames) - 1] * len(image_keys))
        keys.extend(image_keys)
    if keys:
        yield call()


def _run_batched(gt: dict, image_root: str, out_json: str, net, cfg) -> List[Dict]:
    """``run_topdown_keypoints`` through ``topdown_calls`` and ``topdown_keypoints``."""
    in_w, in_h = cfg.NETWORK.IMAGE_SIZE
    id2im = {im["id"]: im for im in gt["images"]}
    by_image: Dict = {}
    for ann in gt["annotations"]:
        by_image.setdefault(ann["image_id"], []).append(ann)

    def images():
        for image_id, group in by_image.items():
            img = imread_any(os.path.join(image_root, id2im[image_id]["file_name"]))
            if img is not None:
                yield bgr_to_rgb(img), [a["bbox"] for a in group], [a["id"] for a in group]

    found = {}
    for frames, boxes, frame_of, keys in topdown_calls(images()):
        kp = topdown_keypoints(net, frames, boxes, frame_of, flip=cfg.TEST.FLIP_TEST,
                               shift=cfg.TEST.SHIFT_HEATMAP, post=cfg.TEST.POST_PROCESS)
        found.update(zip(keys, kp[: len(keys)].numpy()))
    results = []
    for ann in gt["annotations"]:  # in the annotations' order, as the per-crop path
        if ann["id"] in found:
            center, scale = bbox_center_scale(ann["bbox"], in_w / in_h)
            results.append(_result(ann, found[ann["id"]], center, scale))
    _write_json(out_json, results)
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
    s4 = sub.add_parser("s4", help="top-down keypoints on pseudo bboxes (the port's HRNet-W48)")
    s4.add_argument("--pseudo-bboxes", required=True)
    s4.add_argument("--image-root", required=True)
    s4.add_argument("--out", required=True)
    s4.add_argument("--pose-weights", default="",
                    help="HRNet-W48 384x288 weights in the HRNet repository's layout "
                         "(pose_hrnet_w48_384x288.pth)")
    for s in (s2, s4):
        s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.stage == "s2":
        model = _default_detector(args.device, args.detector_weights)
        run_person_detector(args.image_list, args.image_root, args.out, model=model)
    else:
        _require_weights(args.pose_weights, "--pose-weights", "s4's HRNet-W48")
        run_topdown_keypoints(args.pseudo_bboxes, args.image_root, args.out, device=args.device,
                              weights=args.pose_weights)


if __name__ == "__main__":
    main()
