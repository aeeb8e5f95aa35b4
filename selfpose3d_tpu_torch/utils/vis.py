"""Debug visualization (ref: lib/utils/vis.py).

Writes the same artifact families the reference emits every PRINT_FREQ
batches: joint overlays on input images, per-joint heatmap grids, 3D skeleton
plots, and root-position scatter plots. matplotlib is imported lazily with the
Agg backend so headless training never touches a display.

The port's copy of ``selfpose3d_tpu/utils/vis.py``: the 2D overlays are
drawn by the port's rasteriser (``data/synthetic_dataset.py``) and
written as ``.jpg`` by ``utils/image_io.imwrite`` (the port's JPEG
encoder) where the JAX package draws and writes with OpenCV. Predictions
are projected with ``geometry/cameras.py`` on tensors.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from selfpose3d_tpu_torch.data.skeleton import PANOPTIC_LIMBS
from selfpose3d_tpu_torch.data.synthetic_dataset import draw_ring
from selfpose3d_tpu_torch.geometry.cameras import CameraParams, project_points_with_trans
from selfpose3d_tpu_torch.pseudo_labels.visualize import _PERSON_COLORS, draw_skeleton_2d
from selfpose3d_tpu_torch.utils.image_io import imwrite, resize

def _np(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def jet_bgr(gray: np.ndarray) -> np.ndarray:
    """``cv2.applyColorMap(gray, COLORMAP_JET)`` within one level: uint8
    (H, W) -> (H, W, 3) BGR, the piecewise-linear jet map."""
    t = gray.astype(np.float32)[..., None] / 255.0
    centres = np.array([1.0, 2.0, 3.0], np.float32)  # B, G, R
    return np.rint(np.clip(1.5 - np.abs(4.0 * t - centres), 0.0, 1.0) * 255).astype(np.uint8)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_batch_image_with_joints(
    images: np.ndarray,
    joints: np.ndarray,
    joints_vis: np.ndarray,
    file_name: str,
    nrow: int = 4,
):
    """Images (N, H, W, 3) in [0,1] with per-person joints (N, P, J, 2),
    each visible joint a red ring of radius 2, 3 px wide as OpenCV draws
    thickness 2 (ref: vis.py:62-106)."""
    N, H, W, _ = images.shape
    ncol = min(nrow, N)
    rows = math.ceil(N / ncol)
    grid = np.zeros((rows * H, ncol * W, 3), np.uint8)
    for i in range(N):
        img = (np.clip(images[i], 0, 1) * 255).astype(np.uint8).astype(np.float32)
        for p in range(joints.shape[1]):
            for j in range(joints.shape[2]):
                if joints_vis[i, p, j, 0] > 0:
                    draw_ring(img, int(joints[i, p, j, 0]), int(joints[i, p, j, 1]),
                              2, 3, (255.0, 0.0, 0.0))
        r, c = divmod(i, ncol)
        grid[r * H : (r + 1) * H, c * W : (c + 1) * W] = np.rint(np.clip(img, 0, 255))
    os.makedirs(os.path.dirname(file_name) or ".", exist_ok=True)
    imwrite(file_name, grid[..., ::-1])


def save_batch_heatmaps(
    images: Optional[np.ndarray],
    heatmaps: np.ndarray,
    file_name: str,
):
    """Per-joint heatmap grid, one row per sample, one column per joint, in
    the jet colour map (ref: vis.py:108-156)."""
    N, H, W, J = heatmaps.shape
    grid = np.zeros((N * H, (J + 1) * W, 3), np.uint8)
    for i in range(N):
        if images is not None:
            img = resize((np.clip(images[i], 0, 1) * 255).astype(np.uint8), (W, H))
        else:
            img = np.zeros((H, W, 3), np.uint8)
        grid[i * H : (i + 1) * H, :W] = img
        for j in range(J):
            hm = np.clip(heatmaps[i, :, :, j], 0, 1)
            colored = jet_bgr((hm * 255).astype(np.uint8))
            blend = (colored * 0.7 + img * 0.3).astype(np.uint8)
            grid[i * H : (i + 1) * H, (j + 1) * W : (j + 2) * W] = blend
    os.makedirs(os.path.dirname(file_name) or ".", exist_ok=True)
    imwrite(file_name, grid)


def save_3d_poses(
    poses: np.ndarray,
    file_name: str,
    limbs: Sequence[Sequence[int]] = PANOPTIC_LIMBS,
    valid_flags: Optional[np.ndarray] = None,
):
    """3D skeleton plot (ref: vis.py:359-428). poses (P, J, >=3) in mm."""
    plt = _plt()
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    for p in range(poses.shape[0]):
        if valid_flags is not None and valid_flags[p] < 0:
            continue
        pts = poses[p, :, :3]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=6)
        for a, b in limbs:
            ax.plot(
                [pts[a, 0], pts[b, 0]],
                [pts[a, 1], pts[b, 1]],
                [pts[a, 2], pts[b, 2]],
            )
    ax.set_xlim(-4000, 4000)
    ax.set_ylim(-4500, 3500)
    ax.set_zlim(0, 2000)
    os.makedirs(os.path.dirname(file_name) or ".", exist_ok=True)
    fig.savefig(file_name)
    plt.close(fig)


def save_3d_roots(roots: np.ndarray, file_name: str):
    """Root-position scatter (ref: vis.py:430-486). roots (K, >=4)."""
    plt = _plt()
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    valid = roots[:, 3] >= 0 if roots.shape[1] > 3 else np.ones(len(roots), bool)
    pts = roots[valid]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c="r", s=30)
    ax.set_xlim(-4000, 4000)
    ax.set_ylim(-4500, 3500)
    ax.set_zlim(0, 2000)
    os.makedirs(os.path.dirname(file_name) or ".", exist_ok=True)
    fig.savefig(file_name)
    plt.close(fig)


def save_debug_images(
    cfg,
    branch,
    heatmaps_pred: Optional[np.ndarray],
    pred_3d: Optional[np.ndarray],
    grid_centers: Optional[np.ndarray],
    prefix: str,
):
    """Composite debug dump per PRINT_FREQ batch (ref: vis.py:158-187,
    function.py:176-217): ``branch`` an AugBranch (tensors on any device),
    the predictions tensors or arrays."""
    if not cfg.DEBUG.DEBUG:
        return
    views = branch.views
    if views is not None:
        views = _np(views)
        B, V = views.shape[:2]
        flat = views.reshape(B * V, *views.shape[2:])
        if cfg.DEBUG.SAVE_BATCH_IMAGES_GT and branch.joints is not None:
            joints = _np(branch.joints).reshape(B * V, *branch.joints.shape[2:])
            vis = _np(branch.joints_vis).reshape(joints.shape[:-1] + (2,))
            save_batch_image_with_joints(
                flat, joints, vis, f"{prefix}_gt.jpg"
            )
        if cfg.DEBUG.SAVE_HEATMAPS_PRED and heatmaps_pred is not None:
            hm = _np(heatmaps_pred)
            hm = hm.reshape(-1, *hm.shape[2:])
            save_batch_heatmaps(None, hm[: min(4, len(hm))], f"{prefix}_hm_pred.jpg")
    if cfg.DEBUG.SAVE_3D_POSES and pred_3d is not None:
        pred_3d = _np(pred_3d)
        save_3d_poses(
            pred_3d[0, :, :, :3], f"{prefix}_3d_poses.png",
            valid_flags=pred_3d[0, :, 0, 3],
        )
    if cfg.DEBUG.SAVE_3D_ROOTS and grid_centers is not None:
        save_3d_roots(_np(grid_centers)[0], f"{prefix}_3d_roots.png")
    if (
        cfg.DEBUG.SAVE_BATCH_IMAGES_PRED
        and pred_3d is not None
        and branch.views is not None
    ):
        save_multiview_composite(
            cfg, branch, pred_3d, f"{prefix}_views_pred.jpg"
        )


def save_multiview_composite(
    cfg,
    branch,
    pred_3d: np.ndarray,
    file_name: str,
    sample: int = 0,
):
    """All-camera composite: predicted 3D poses projected into every view and
    drawn over the (denormalized) input images, tiled into one grid — the
    headless equivalent of the reference's vedo offscreen 5-camera render
    (ref: lib/utils/vis.py:189-357).

    Args:
      branch: AugBranch with views (B, V, H, W, 3), cam, trans.
      pred_3d: (B, K, J, >=4) predicted poses with validity in col 3.
    """
    views = branch.views
    if views is None or pred_3d is None:
        return
    views = _np(views)
    b = sample
    B, V, H, W, _ = views.shape
    pred = _np(pred_3d)[b]  # (K, J, C)
    K, J = pred.shape[:2]

    cam = branch.cam
    cam_b = CameraParams(*(getattr(cam, f.name)[b : b + 1].detach().cpu().float()
                           for f in dataclasses.fields(cam)))
    kps = project_points_with_trans(
        torch.from_numpy(np.ascontiguousarray(pred[:, :, :3], np.float32)).reshape(1, 1, K * J, 3),
        cam_b,
        branch.trans[b : b + 1].detach().cpu().float(),
    ).numpy().reshape(V, K, J, 2)

    panels = []
    for v in range(V):
        img = views[b, v]
        img = (img - img.min()) / max(img.max() - img.min(), 1e-6) * 255
        img = np.ascontiguousarray(img.astype(np.uint8))
        for n in range(K):
            if pred.shape[-1] > 3 and pred[n, 0, 3] < 0:
                continue
            pts = np.concatenate(
                [kps[v, n], np.ones((J, 1), np.float32)], axis=1
            )
            draw_skeleton_2d(
                img, pts, PANOPTIC_LIMBS,
                _PERSON_COLORS[n % len(_PERSON_COLORS)],
            )
        panels.append(img)
    cols = min(3, V)
    rows = (V + cols - 1) // cols
    grid = np.zeros((rows * H, cols * W, 3), np.uint8)
    for v, p in enumerate(panels):
        r, c = divmod(v, cols)
        grid[r * H : (r + 1) * H, c * W : (c + 1) * W] = p
    os.makedirs(os.path.dirname(file_name) or ".", exist_ok=True)
    imwrite(file_name, grid)


def load_obj_mesh(path: str):
    """Minimal wavefront OBJ reader -> (verts (N,3) f32, faces (M,3) i32).

    Reads only 'v' and triangular 'f' records ('f a/b/c' slash forms
    allowed) — sufficient for the SMPL fit meshes the reference renders
    (ref: tools/visualize.py:312 ``Mesh(os.path.join(mesh_dir, p))``).
    """
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0] - 1, idx[k] - 1, idx[k + 1] - 1])
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32).reshape(-1, 3),
    )


# track-stable mesh palette (the reference colors meshes by track id,
# tools/visualize.py:321 ``.c(COLORS[int(n % 10)])``)
MESH_COLORS = (
    "#4878d0", "#ee854a", "#6acc64", "#d65f5f", "#956cb4",
    "#8c613c", "#dc7ec0", "#797979", "#d5bb67", "#82c6e2",
)


def save_scene_render(
    images,
    poses: np.ndarray,
    file_name: str,
    azimuth: float = 30.0,
    elev: float = 22.0,
    limbs: Sequence[Sequence[int]] = PANOPTIC_LIMBS,
    downsample: int = 10,
    meshes=None,
    mesh_face_stride: int = 4,
):
    """3D scene composite: camera images as upright billboards arranged
    around the capture space + 3D skeletons, viewed from a virtual orbit
    camera — the headless matplotlib equivalent of the reference's vedo
    scene render (ref: tools/visualize.py:250-268 image layout,
    :493-600 orbiting virtual camera; layout constants reproduced).

    Args:
      images: per-camera list (<=5) of (H, W, 3) uint8/float RGB images
              (network-input-space frames, e.g. with 2D overlays).
      poses:  (P, J, >=3) 3D poses in world mm.
      azimuth: virtual-camera azimuth for this frame (callers step it
              per frame to reproduce the reference's orbit).
      meshes: optional per-person [(verts (N,3) mm, faces (M,3))] SMPL fit
              meshes, track-ordered — rendered as shaded surfaces over the
              skeletons (ref: tools/visualize.py:312,331-335).
      mesh_face_stride: render every k-th face (matplotlib Poly3D is slow
              at full SMPL resolution; stride 4 keeps the silhouette).
    """
    plt = _plt()
    # reference billboard layout (tools/visualize.py:251-257)
    z_rot = [100.0, 80.0, 0.0, 80.0, 100.0]
    x_t = [-2000.0, -2000.0, -1000.0, 2000.0, 2000.0]
    y_t = [-2000.0, 0.0, 2000.0, -2000.0, 0.0]
    scale = 1.8

    fig = plt.figure(figsize=(10, 7))
    ax = fig.add_subplot(111, projection="3d")
    ax.computed_zorder = False

    for i, im in enumerate(images[:5]):
        im = np.asarray(im)
        if im.dtype != np.uint8:
            im = np.clip(im * 255.0 if im.max() <= 2.0 else im, 0, 255)
        im = im[::downsample, ::downsample].astype(np.float32) / 255.0
        h, w = im.shape[:2]
        # upright plane (x-rot 90: image rows -> world z), centered
        lx = (np.arange(w) - w / 2.0) * downsample * scale
        lz = (h - np.arange(h)) * downsample * scale
        X0 = np.broadcast_to(lx[None, :], (h, w))
        Z = np.broadcast_to(lz[:, None], (h, w))
        a = np.deg2rad(z_rot[i % 5])
        Xr = X0 * np.cos(a) + x_t[i % 5]
        Yr = X0 * np.sin(a) + y_t[i % 5]
        ax.plot_surface(
            Xr, Yr, Z, facecolors=im, shade=False,
            rstride=1, cstride=1, antialiased=False, zorder=1,
        )

    if meshes:
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        for mi, (mv, mf) in enumerate(meshes):
            mv = np.asarray(mv, np.float32)
            mf = np.asarray(mf, np.int64)[::max(1, mesh_face_stride)]
            tris = mv[mf]  # (M', 3, 3)
            coll = Poly3DCollection(
                tris,
                facecolor=MESH_COLORS[mi % len(MESH_COLORS)],
                edgecolor="none", alpha=0.55, zorder=2,
            )
            ax.add_collection3d(coll)

    for p in range(poses.shape[0]):
        pts = poses[p, :, :3]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=10, zorder=3)
        for a_, b_ in limbs:
            ax.plot(
                [pts[a_, 0], pts[b_, 0]],
                [pts[a_, 1], pts[b_, 1]],
                [pts[a_, 2], pts[b_, 2]],
                linewidth=2, zorder=3,
            )

    ax.set_xlim(-4000, 4000)
    ax.set_ylim(-4500, 3500)
    ax.set_zlim(0, 2500)
    ax.set_box_aspect((8, 8, 2.5))
    ax.view_init(elev=elev, azim=azimuth)
    ax.set_axis_off()
    os.makedirs(os.path.dirname(file_name) or ".", exist_ok=True)
    fig.savefig(file_name, dpi=110, bbox_inches="tight")
    plt.close(fig)
