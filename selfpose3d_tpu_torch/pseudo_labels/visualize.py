"""Pseudo-label visualization stages s6/s8: overlay + GT-compare dumps.

Headless (file-writing) equivalents of the reference's interactive viewers
(ref: pseudo_2d_labels_generation/s6_vis_pseudo_kpt2d.py,
s8_vis_compare_pseudo_kpt2d.py): s6 draws the COCO-17 pseudo 2D keypoints
from the merged annotation json onto their images; s8 draws the Panoptic-15
joints of a GT db pickle and a pseudo-label db pickle side by side for the
same frames, completing the pipeline's visual QA loop.

The port's copy of ``selfpose3d_tpu/pseudo_labels/visualize.py``: lines
and circles are drawn anti-aliased by the port's rasteriser
(``data/synthetic_dataset.py``) where the JAX package calls ``cv2.line``
and ``cv2.circle`` with LINE_AA; the overlays are written as ``.jpg`` by
``utils/image_io.imwrite`` (the port's JPEG encoder).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle
import random
from typing import List, Optional, Sequence

import numpy as np

from selfpose3d_tpu_torch.data.synthetic_dataset import draw_capsule, draw_ring
from selfpose3d_tpu_torch.utils.image_io import imwrite
from selfpose3d_tpu_torch.utils.zipreader import imread_any

# COCO-17 skeleton pairs (ref: s6_vis_pseudo_kpt2d.py:55-75)
COCO_PAIRS = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]

# Panoptic-15 limb pairs (matches data/skeleton.py PANOPTIC_LIMBS)
PANOPTIC_PAIRS = [
    (0, 1), (0, 2), (0, 3), (3, 4), (4, 5), (0, 9), (9, 10), (10, 11),
    (2, 6), (2, 12), (6, 7), (7, 8), (12, 13), (13, 14),
]

# per-person bright colors (BGR); cycled past 20 persons
_PERSON_COLORS = [
    (73, 73, 230), (75, 180, 60), (25, 225, 255), (200, 130, 0),
    (48, 130, 245), (180, 30, 145), (240, 240, 70), (230, 50, 240),
    (60, 245, 210), (190, 190, 250), (128, 128, 0), (255, 190, 230),
    (40, 110, 170), (200, 250, 255), (0, 0, 128), (195, 255, 170),
    (0, 128, 128), (255, 128, 128), (128, 0, 0), (128, 192, 255),
]


def aa_width(thickness: int) -> float:
    """The width OpenCV's anti-aliased lines and circles of ``thickness``
    ink across (measured on its output): the pixels within (t + 1) // 2 px
    of the centre line solid and a 0.2 px fringe each side for t > 1; 1.35
    px for t = 1."""
    return 2 * ((thickness + 1) // 2) + 1.4 if thickness > 1 else 1.35


# how far past a joint's pixel draw_skeleton_2d can ink: the outer ring's
# radius 5, half its width and the one-pixel margin of the drawing windows
_INK_REACH = int(np.ceil(5 + aa_width(1) / 2 + 1))


def draw_skeleton_2d(
    image: np.ndarray,
    kpts: np.ndarray,
    pairs: Sequence,
    color,
    vis_thresh: float = 0.0,
) -> np.ndarray:
    """Draw one person's 2D keypoints + limbs in place on a uint8 image, at
    rounded pixels: limbs of thickness 3, each joint a ring of radius 4 and
    thickness 2 inside a black ring of radius 5 and thickness 1, anti-aliased
    with OpenCV's widths (``aa_width``; ``cv2.line`` / ``cv2.circle`` with
    LINE_AA in the JAX package).

    kpts: (J, 3) [x, y, conf/vis] — joints with third column <= vis_thresh
    are skipped (ref: s8 draw_2d_keypoints semantics).

    Only the person's window is converted to float and written back: the
    visible joints' box grown by ``_INK_REACH``, clipped to the image.
    """
    J = kpts.shape[0]
    shown = [j for j in range(J) if kpts[j, 2] > vis_thresh]
    if not shown:
        return image
    pix = {j: (int(round(kpts[j, 0])), int(round(kpts[j, 1]))) for j in shown}
    H, W = image.shape[:2]
    xs, ys = [p[0] for p in pix.values()], [p[1] for p in pix.values()]
    x0, x1 = max(min(xs) - _INK_REACH, 0), min(max(xs) + _INK_REACH + 1, W)
    y0, y1 = max(min(ys) - _INK_REACH, 0), min(max(ys) + _INK_REACH + 1, H)
    if x0 >= x1 or y0 >= y1:
        return image
    canvas = image[y0:y1, x0:x1].astype(np.float32)
    pix = {j: (x - x0, y - y0) for j, (x, y) in pix.items()}
    color = np.asarray(color, np.float32)
    for a, b in pairs:
        if a in pix and b in pix:
            draw_capsule(canvas, pix[a], pix[b], aa_width(3), color)
    for x, y in pix.values():
        draw_ring(canvas, x, y, 4, aa_width(2), color)
        draw_ring(canvas, x, y, 5, aa_width(1), (0.0, 0.0, 0.0))
    image[y0:y1, x0:x1] = np.clip(np.rint(canvas), 0, 255).astype(image.dtype)
    return image


def _load_image(path: str, width: int, height: int) -> np.ndarray:
    """Image or, when unavailable, a black canvas of the annotated size."""
    img = imread_any(path) if path else None
    if img is None:
        img = np.zeros((int(height), int(width), 3), np.uint8)
    return img


def vis_pseudo_kpt2d(
    pseudo_json: str,
    img_dir: str,
    out_dir: str,
    num_samples: int = 50,
    seed: int = 0,
    kp_key: str = "keypoints",
) -> List[str]:
    """s6: overlay the merged COCO-17 pseudo keypoints on their images
    (ref: s6_vis_pseudo_kpt2d.py — batch, headless)."""
    with open(pseudo_json) as f:
        data = json.load(f)
    by_image = {im["id"]: [] for im in data["images"]}
    for ann in data["annotations"]:
        if kp_key in ann:
            by_image[ann["image_id"]].append(ann)
    images = {im["id"]: im for im in data["images"]}

    rng = random.Random(seed)
    ids = list(images.keys())
    rng.shuffle(ids)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for image_id in ids[:num_samples]:
        im = images[image_id]
        img = _load_image(
            osp.join(img_dir, im["file_name"]), im["width"], im["height"]
        )
        for pi, ann in enumerate(by_image[image_id]):
            kp = np.asarray(ann[kp_key], np.float32).reshape(-1, 3)
            draw_skeleton_2d(
                img, kp, COCO_PAIRS,
                _PERSON_COLORS[pi % len(_PERSON_COLORS)], vis_thresh=0.05,
            )
        out = osp.join(out_dir, f"pseudo_{image_id}.jpg")
        imwrite(out, img)
        written.append(out)
    return written


def vis_compare_pseudo_kpt2d(
    gt_pkl: str,
    pseudo_pkl: str,
    img_dir: str,
    out_dir: str,
    num_samples: int = 50,
    seed: int = 0,
) -> List[str]:
    """s8: GT vs pseudo Panoptic-15 overlays for the same frames, written as
    side-by-side composites (ref: s8_vis_compare_pseudo_kpt2d.py:266-320,
    headless: every sampled frame is saved instead of keyboard-gated)."""
    with open(gt_pkl, "rb") as f:
        gt = {r["key"]: r for r in pickle.load(f)["db"]}
    with open(pseudo_pkl, "rb") as f:
        pseudo = {r["key"]: r for r in pickle.load(f)["db"]}
    keys = [k for k in gt.keys() if k in pseudo]

    rng = random.Random(seed)
    rng.shuffle(keys)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for key in keys[:num_samples]:
        panels = []
        for rec in (gt[key], pseudo[key]):
            img = _load_image(
                osp.join(img_dir, rec["image"]),
                rec.get("width", 1920), rec.get("height", 1080),
            )
            persons = []
            for kp, vis in zip(rec["joints_2d"], rec["joints_2d_vis"]):
                kp = np.asarray(kp, np.float32)
                vis = np.asarray(vis, np.float32)
                persons.append(np.concatenate([kp[:, :2], vis[:, 1:2]], 1))
            # stable person-color pairing across the two panels: sort by the
            # x of joint 2 (mid-hip), like the reference (ref: s8 :296-297)
            persons.sort(key=lambda k: float(k[2, 0]))
            for pi, kp in enumerate(persons):
                draw_skeleton_2d(
                    img, kp, PANOPTIC_PAIRS,
                    _PERSON_COLORS[pi % len(_PERSON_COLORS)],
                )
            panels.append(img)
        h = min(p.shape[0] for p in panels)
        panels = [p[:h] for p in panels]
        composite = np.concatenate(panels, axis=1)
        out = osp.join(out_dir, f"compare_{key}.jpg")
        imwrite(out, composite)
        written.append(out)
    return written


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="pseudo-label visualization (s6 overlay / s8 compare)"
    )
    sub = ap.add_subparsers(dest="stage", required=True)
    p6 = sub.add_parser("s6", help="overlay pseudo COCO keypoints")
    p6.add_argument("--pseudo-json", required=True)
    p6.add_argument("--img-dir", default=".")
    p6.add_argument("--out-dir", required=True)
    p6.add_argument("--num", type=int, default=50)
    p6.add_argument("--kp-key", default="keypoints")
    p8 = sub.add_parser("s8", help="compare GT vs pseudo db pickles")
    p8.add_argument("--gt-pkl", required=True)
    p8.add_argument("--pseudo-pkl", required=True)
    p8.add_argument("--img-dir", default=".")
    p8.add_argument("--out-dir", required=True)
    p8.add_argument("--num", type=int, default=50)
    args = ap.parse_args(argv)

    if args.stage == "s6":
        out = vis_pseudo_kpt2d(
            args.pseudo_json, args.img_dir, args.out_dir,
            num_samples=args.num, kp_key=args.kp_key,
        )
    else:
        out = vis_compare_pseudo_kpt2d(
            args.gt_pkl, args.pseudo_pkl, args.img_dir, args.out_dir,
            num_samples=args.num,
        )
    print(f"wrote {len(out)} images to {osp.dirname(out[0]) if out else '-'}")


if __name__ == "__main__":
    main()
