"""Offline prediction renderer (ref: tools/visualize.py).

Loads a ``predictions_dump.pkl`` (written by evaluate), runs greedy 3D track
association, and renders per-frame 3D skeleton images (+ optional ffmpeg
video). The reference uses vedo+SMPL meshes; this renders matplotlib skeleton
plots — same tracking and sequencing logic, dependency-light. The port's
copy of ``selfpose3d_tpu/cli/visualize.py``: images are read and resized
with ``utils/image_io`` where the JAX package calls OpenCV; the renders
need matplotlib, the video ``ffmpeg``.

    python -m selfpose3d_tpu_torch.cli.visualize --dump predictions_dump.pkl --out-dir vis_out
"""

from __future__ import annotations

import argparse
import os
import pickle
import subprocess

import numpy as np

from selfpose3d_tpu_torch.eval.tracking import track_sequence
from selfpose3d_tpu_torch.utils.image_io import bgr_to_rgb, resize
from selfpose3d_tpu_torch.utils.vis import load_obj_mesh, save_3d_poses, save_scene_render
from selfpose3d_tpu_torch.utils.zipreader import imread_any


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Render 3D pose predictions")
    p.add_argument("--dump", required=True, help="predictions_dump.pkl path")
    p.add_argument("--out-dir", default="./vis_out")
    p.add_argument("--sequence", default="", help="filter by sequence key")
    p.add_argument("--score-threshold", type=float, default=0.2)
    p.add_argument("--video", action="store_true", help="ffmpeg mp4 render")
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--scene", action="store_true",
                   help="3D scene composite: camera-image billboards around "
                        "the skeletons with an orbiting virtual camera (the "
                        "headless equivalent of the reference's vedo render, "
                        "ref tools/visualize.py:250-268,493-600); falls back "
                        "to plain skeleton plots when images are missing")
    p.add_argument("--mesh-dir", default="",
                   help="optional SMPL fit-mesh root for --scene: per frame "
                        "a subdirectory <mesh-dir>/<frame key> (or zero-"
                        "padded frame index) holding per-person .obj meshes "
                        "(SMPL convention: meters, y-down — rotated x180 and "
                        "scaled x1000 like the reference, ref "
                        "tools/visualize.py:312). Frames without a mesh dir "
                        "render skeleton-only.")
    return p.parse_args(argv)


def _frame_meshes(mesh_dir: str, rec, frame_idx: int, order):
    """Load + transform this frame's per-person meshes, track-ordered.
    Returns [] when assets are absent (clean skip)."""
    if not mesh_dir:
        return []
    candidates = [os.path.join(mesh_dir, f"{frame_idx:06d}")]
    key = rec.get("key")
    if key:
        candidates.insert(0, os.path.join(mesh_dir, str(key)))
    d = next((c for c in candidates if os.path.isdir(c)), None)
    if d is None:
        return []
    objs = sorted(p for p in os.listdir(d) if p.endswith(".obj"))
    meshes = []
    for p in objs:
        try:
            v, f = load_obj_mesh(os.path.join(d, p))
        except (OSError, ValueError):
            continue
        if len(v) == 0 or len(f) == 0:
            continue
        # reference transform: Mesh(...).rotateX(180).scale(1000)
        v = v * np.array([1.0, -1.0, -1.0], np.float32) * 1000.0
        meshes.append((v, f))
    # track-order the meshes like the reference (visualize.py:316)
    if len(order) and len(meshes):
        meshes = [meshes[i] for i in order if i < len(meshes)]
    return meshes


def _scene_images(rec, size=(640, 360)):
    """Load this frame's per-view images from the dump's views_meta
    (None when paths are absent/unreadable)."""
    metas = rec.get("views_meta") or []
    images = []
    for m in metas:
        img = imread_any(m.get("image") or "")
        if img is None:
            continue
        images.append(resize(bgr_to_rgb(img), size))
    return images


def images_to_video(img_dir: str, out_file: str, fps: int = 12):
    """(ref: tools/visualize.py:587-600)."""
    cmd = [
        "ffmpeg", "-y", "-framerate", str(fps),
        "-pattern_type", "glob", "-i", os.path.join(img_dir, "*.png"),
        "-c:v", "libx264", "-pix_fmt", "yuv420p", out_file,
    ]
    subprocess.run(cmd, check=False)


def main(argv=None):
    args = parse_args(argv)
    with open(args.dump, "rb") as f:
        records = pickle.load(f)
    if args.sequence:
        records = [r for r in records if args.sequence in r.get("key", "")]

    poses, scores = [], []
    for r in records:
        pred = np.asarray(r.get("preds_3d", np.zeros((0, 15, 5))))
        if pred.ndim == 3 and pred.shape[-1] >= 4:
            keep = pred[:, 0, 3] >= 0
            pred = pred[keep]
        poses.append(pred[:, :, :3])
        scores.append(pred[:, 0, -1] if pred.shape[-1] >= 5 else np.ones(len(pred)))

    orderings = track_sequence(poses, scores, args.score_threshold)

    os.makedirs(args.out_dir, exist_ok=True)
    azim = 30.0
    for i, (p, order) in enumerate(zip(poses, orderings)):
        if len(order) == 0:
            continue
        out_png = os.path.join(args.out_dir, f"{i:06d}.png")
        if args.scene:
            images = _scene_images(records[i])
            meshes = _frame_meshes(args.mesh_dir, records[i], i, order)
            save_scene_render(
                images, p[order], out_png, azimuth=azim, meshes=meshes
            )
            azim -= 0.8  # reference's per-frame orbit (visualize.py:583)
        else:
            save_3d_poses(p[order], out_png)
    if args.video:
        images_to_video(args.out_dir, os.path.join(args.out_dir, "render.mp4"), args.fps)
    print(f"rendered {len(poses)} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
