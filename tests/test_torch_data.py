"""The port's host data path against the JAX package's, on the CPU: camera
projection, transforms, skeleton converters, target generators, the
synthetic-scene dataset, ``collate_branch`` and ``PrefetchLoader``.

Bars: the numpy modules are the same float sequence, so results are
equal; torch against jnp (``affine_transform_points``, the camera-frame
transforms) within float32 round-off; dataset frames and collated
batches equal in every key of every view of every branch, the noise
images included. The render mode's stick figures come from the port's
own rasteriser and the JAX package's OpenCV drawing: each visible
joint's disc intensity centroid within 0.5 px, the mean absolute
difference of each image at most 0.02, and every other key equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import selfpose3d_tpu.data.loader as j_loader
import selfpose3d_tpu.data.skeleton as j_skel
import selfpose3d_tpu.data.targets as j_targets
import selfpose3d_tpu.geometry.cameras as j_cams
import selfpose3d_tpu.geometry.cameras_np as j_cams_np
import selfpose3d_tpu.geometry.transforms as j_tf
from selfpose3d_tpu.config import load_config as j_load_config
from selfpose3d_tpu.data.synthetic_dataset import SyntheticSceneDataset as JDataset

import selfpose3d_tpu_torch.data.skeleton as skel
import selfpose3d_tpu_torch.data.targets as targets
import selfpose3d_tpu_torch.geometry.cameras as cams
import selfpose3d_tpu_torch.geometry.cameras_np as cams_np
import selfpose3d_tpu_torch.geometry.transforms as tf
from selfpose3d_tpu_torch.config import load_config
from selfpose3d_tpu_torch.data.loader import PrefetchLoader, collate_branch
from selfpose3d_tpu_torch.data.registry import get_dataset
from selfpose3d_tpu_torch.data.synthetic_dataset import (
    SyntheticSceneDataset,
    draw_disc,
    joint_colors,
)

TINY = "configs/synthetic/tiny_ssv.yaml"
MAGNITUDE = "configs/synthetic/magnitude_ssv.yaml"
VIEW_KEYS = ("image", "target_2d", "weights_2d", "target_3d", "trans", "orig_wh", "joints",
             "joints_vis", "joints_3d", "joints_3d_vis", "roots_3d", "num_person", "hflip")


def _camera(rs):
    ang = rs.uniform(0, np.pi)
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    return {"R": R @ np.diag([1.0, -1.0, -1.0]), "T": rs.uniform(-500, 500, (3, 1)),
            "fx": 1400.0 + rs.rand(), "fy": 1450.0, "cx": 960.0, "cy": 540.0,
            "k": rs.randn(3, 1) * 0.05, "p": rs.randn(2, 1) * 0.01}


# -------------------------------------------------------------- geometry

def test_cameras_np_equal():
    rs = np.random.RandomState(0)
    cam = _camera(rs)
    x = rs.uniform(-2000, 2000, (40, 3)) + [0, 0, 4000]
    np.testing.assert_array_equal(cams_np.project_pose_np(x, cam), j_cams_np.project_pose_np(x, cam))
    args = cams_np._unfold(cam)
    np.testing.assert_array_equal(cams_np.project_point_radial_np(x, *args),
                                  j_cams_np.project_point_radial_np(x, *args))


def test_host_transforms_equal():
    rs = np.random.RandomState(1)
    t = j_tf.get_affine_transform([960, 540], [9.6, 5.4], 17.0, (256, 128))
    assert np.array_equal(tf.get_affine_transform([960, 540], [9.6, 5.4], 17.0, (256, 128)), t)
    for _ in range(5):
        pt = rs.uniform(0, 1920, 2)
        np.testing.assert_array_equal(tf.affine_transform_point_np(pt, t),
                                      j_tf.affine_transform_point_np(pt, t))
    pts, center = rs.randn(12, 2) * 100, rs.randn(2)
    np.testing.assert_array_equal(tf.rotate_points(pts, center, 33.0),
                                  j_tf.rotate_points(pts, center, 33.0))
    X = rs.uniform(-1000, 1000, (3, 20)) + [[0], [0], [4000]]
    K = np.array([[1400.0, 0.5, 960], [0, 1450, 540], [0, 0, 1]])
    R = _camera(rs)["R"]
    tv, Kd = rs.randn(3, 1) * 100, rs.randn(5) * 0.01
    np.testing.assert_array_equal(tf.project_points_opencv(X, K, R, tv, Kd),
                                  j_tf.project_points_opencv(X, K, R, tv, Kd))
    A, B = rs.randn(15, 3) * 300, rs.randn(15, 3) * 300
    for scale in (False, True):
        got = tf.compute_similarity_transform(A, B, compute_optimal_scale=scale)
        want = j_tf.compute_similarity_transform(A, B, compute_optimal_scale=scale)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tf.procrustes_transform(A, B), j_tf.procrustes_transform(A, B))


def test_device_transforms_match_jax():
    rs = np.random.RandomState(2)
    pts = rs.uniform(0, 1920, (2, 3, 40, 2)).astype(np.float32)
    t = np.stack([j_tf.get_affine_transform_3x3([960, 540], [9.6, 5.4], r, (256, 128))
                  for r in rs.uniform(-30, 30, 3)]).astype(np.float32)
    got = tf.affine_transform_points(torch.from_numpy(pts), torch.from_numpy(t))
    want = np.asarray(j_tf.affine_transform_points(jnp.asarray(pts), jnp.asarray(t)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)
    R = np.stack([_camera(rs)["R"] for _ in range(3)]).astype(np.float32)
    T = rs.uniform(-500, 500, (3, 3, 1)).astype(np.float32)
    x = rs.uniform(-2000, 2000, (3, 30, 3)).astype(np.float32)
    for port_fn, jax_fn in ((cams.world_to_camera_frame, j_cams.world_to_camera_frame),
                            (cams.camera_to_world_frame, j_cams.camera_to_world_frame)):
        got = port_fn(*map(torch.from_numpy, (x, R, T)))
        want = np.asarray(jax_fn(*map(jnp.asarray, (x, R, T))))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)
    back = cams.camera_to_world_frame(cams.world_to_camera_frame(
        torch.from_numpy(x), torch.from_numpy(R), torch.from_numpy(T)),
        torch.from_numpy(R), torch.from_numpy(T))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-2)


# ------------------------------------------------------ skeleton, targets

def test_skeleton_equal():
    for name in ("PANOPTIC_JOINTS", "FLIP_LR_JOINTS15", "PANOPTIC_LIMBS", "COCO_JOINTS",
                 "SHELF_JOINTS", "SHELF_LIMBS", "PANOPTIC_CAM_LIST"):
        assert getattr(skel, name) == getattr(j_skel, name), name
    rs = np.random.RandomState(3)
    coco = rs.randn(17, 3) * 300
    np.testing.assert_array_equal(skel.coco_to_panoptic(coco), j_skel.coco_to_panoptic(coco))
    np.testing.assert_array_equal(skel.coco_to_shelf_3d(coco), j_skel.coco_to_shelf_3d(coco))
    pan = rs.randn(15, 3) * 300
    np.testing.assert_array_equal(skel.panoptic_to_shelf_3d(pan), j_skel.panoptic_to_shelf_3d(pan))


def test_targets_equal():
    rs = np.random.RandomState(4)
    joints = [rs.uniform(-20, 270, (15, 2)).astype(np.float32) for _ in range(3)]
    vis = [(rs.rand(15, 2) > 0.2).astype(np.float32) for _ in range(3)]
    vis[2][:] = 0  # a person with no visible joint
    args = ((256, 128), (64, 32), 3.0, 15)
    for g, w in zip(targets.generate_target_heatmap(joints, vis, *args),
                    j_targets.generate_target_heatmap(joints, vis, *args)):
        np.testing.assert_array_equal(g, w)
    conf = [np.concatenate([j, rs.rand(15, 1).astype(np.float32)], 1) for j in joints]
    for use in (True, False):
        np.testing.assert_array_equal(
            targets.generate_input_heatmap(conf, (256, 128), (64, 32), 3.0, use),
            j_targets.generate_input_heatmap(conf, (256, 128), (64, 32), 3.0, use))
    roots = rs.uniform(-4000, 4000, (4, 3)) * [1, 1, 0.2] + [0, -500, 800]
    roots[3] = [20000.0, 0.0, 0.0]  # outside the space
    kw = dict(space_size=(8000.0, 8000.0, 2000.0), space_center=(0.0, -500.0, 800.0),
              cube_size=(32, 32, 16))
    np.testing.assert_array_equal(targets.generate_3d_target(roots, **kw),
                                  j_targets.generate_3d_target(roots, **kw))
    assert targets.compute_human_scale(joints[0], vis[0]) == \
        j_targets.compute_human_scale(joints[0], vis[0])


# ---------------------------------------------------------------- dataset

def _datasets(path, image_set, **over):
    over = {"DATASET": over} if over else None
    port = SyntheticSceneDataset(load_config(path, overrides=over), image_set,
                                 image_set == "train", num_frames=8)
    ref = JDataset(j_load_config(path, overrides=over), image_set, image_set == "train",
                   num_frames=8)
    return port, ref


def _assert_view_equal(got, want, where, skip=()):
    for k in VIEW_KEYS:
        if k in skip:
            continue
        g, w = got[k], want[k]
        assert (g is None) == (w is None), (where, k)
        if g is not None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"{where} {k}")
    for f in ("R", "T", "fx", "fy", "cx", "cy", "k", "p"):
        np.testing.assert_array_equal(np.asarray(got["camera"][f]),
                                      np.asarray(want["camera"][f]), err_msg=f"{where} cam {f}")


@pytest.mark.parametrize("image_set, seed", [("train", 0), ("train", 3), ("validation", 0)])
def test_dataset_frames_equal_noise_mode(image_set, seed):
    port, ref = _datasets(TINY, image_set, FLIP=True)  # flips drawn in some branches
    flips = set()
    for idx in (0, 1, 5):
        got, want = port.get_frame(idx, seed=seed), ref.get_frame(idx, seed=seed)
        assert got["frame_idx"] == want["frame_idx"] == idx
        for v, (g, w) in enumerate(zip(got["views"], want["views"])):
            _assert_view_equal(g, w, f"frame {idx} view {v}")
        for b, (gb, wb) in enumerate(zip(port.get_ssv_frame(idx, seed=seed),
                                         ref.get_ssv_frame(idx, seed=seed))):
            for v, (g, w) in enumerate(zip(gb, wb)):
                _assert_view_equal(g, w, f"ssv frame {idx} branch {b} view {v}")
                flips.add(g["hflip"])
    assert flips == {False, True}
    g0 = port.get_frame(2, load_images=False)["views"][0]
    assert g0["image"] is None
    _assert_view_equal(g0, ref.get_frame(2, load_images=False)["views"][0], "no images")


def _disc_window(img, x, y, r):
    """The window of the disc of radius ``r`` at pixel (x, y): its summed
    intensity and its intensity centroid."""
    H, W = img.shape[:2]
    x0, x1, y0, y1 = max(x - r, 0), min(x + r, W - 1), max(y - r, 0), min(y + r, H - 1)
    win = img[y0:y1 + 1, x0:x1 + 1].sum(-1)
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    return win.sum(), ((win * xs).sum() / win.sum(), (win * ys).sum() / win.sum())


def test_render_mode_matches_opencv_drawing():
    port, ref = _datasets(MAGNITUDE, "train")
    w_img, h_img = port.cfg.NETWORK.IMAGE_SIZE
    rad = max(1, round(min(w_img, h_img) / 48))
    n_discs, worst_mad, worst_shift, worst_ink = 0, 0.0, 0.0, 0.0
    for idx in (0, 2, 4):
        for b, (gb, wb) in enumerate(zip(port.get_ssv_frame(idx, seed=1),
                                         ref.get_ssv_frame(idx, seed=1))):
            for v, (g, w) in enumerate(zip(gb, wb)):
                _assert_view_equal(g, w, f"render frame {idx} branch {b} view {v}",
                                   skip=("image",))
                gi, wi = g["image"], w["image"]
                assert gi.dtype == np.float32 and gi.shape == wi.shape == (h_img, w_img, 3)
                mad = float(np.abs(gi - wi).mean())
                assert mad <= 0.02, (idx, b, v, mad)
                worst_mad = max(worst_mad, mad)
                for p in range(g["num_person"]):
                    for jx, jy in g["joints"][p][g["joints_vis"][p][:, 0] > 0]:
                        x, y = int(round(jx)), int(round(jy))
                        sg, cg = _disc_window(gi, x, y, rad)
                        sw, cw = _disc_window(wi, x, y, rad)
                        shift = max(abs(cg[0] - cw[0]), abs(cg[1] - cw[1]))
                        assert shift <= 0.5, (idx, b, v, p, shift)
                        # the disc is drawn: its window holds OpenCV's ink to
                        # 15 % (a window of the noise floor alone is > 80 % short)
                        ink = abs(sg / sw - 1)
                        assert ink <= 0.15, (idx, b, v, p, ink)
                        worst_shift, worst_ink = max(worst_shift, shift), max(worst_ink, ink)
                        n_discs += 1
    assert n_discs > 100 and worst_mad > 0  # the drawings differ, within the bars


def test_draw_disc_antialiased_and_in_its_box():
    img = np.zeros((20, 30, 3), np.float32)
    draw_disc(img, 10, 8, 3, joint_colors(15)[4])
    a = img[..., 0] / joint_colors(15)[4][0]
    assert np.isclose(a[8, 10], 1.0) and np.isclose(a[8, 13], 0.5)  # edge at the radius
    assert 0 < a[10, 12] < 1 and a[8, 14] == 0  # partly covered; outside
    np.testing.assert_allclose(a.sum(), np.pi * 9, rtol=0.05)  # the disc's area
    assert not img[:, 15:].any() and not img[13:].any()
    draw_disc(img, -10, -10, 3, (1.0, 1.0, 1.0))  # wholly outside: no change
    assert not img[:, 15:].any()


# ------------------------------------------------------- collate, loader

@pytest.mark.parametrize("branch", [0, 2])
def test_collate_branch_equal(branch):
    port, ref = _datasets(TINY, "train")
    got = collate_branch([port.get_ssv_frame(i, seed=1)[branch] for i in (0, 1, 2)])
    want = j_loader.collate_branch([ref.get_ssv_frame(i, seed=1)[branch] for i in (0, 1, 2)])
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "cam":
            for c in dataclasses.fields(g):
                np.testing.assert_array_equal(getattr(g, c.name).numpy(),
                                              np.asarray(getattr(w, c.name)))
            continue
        assert (g is None) == (w is None), f.name
        if g is not None:
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f.name)
    assert got.num_person.tolist() == [1, 2, 3] and got.num_person.dtype == torch.int32
    assert got.hflip.dtype == torch.bool


def _jax_loader(n, b, **kw):
    return j_loader.PrefetchLoader(n, b, lambda idxs: list(idxs), process_index=0,
                                   process_count=1, **kw)


@pytest.mark.parametrize("shuffle, drop_last, workers", [
    (False, False, 1), (True, False, 3), (True, True, 2)])
def test_prefetch_loader_order_equals_jax(shuffle, drop_last, workers):
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=5, num_workers=workers)
    port = PrefetchLoader(11, 3, lambda idxs: list(idxs), **kw)
    ref = _jax_loader(11, 3, **kw)
    epochs = [list(port) for _ in range(3)]
    assert epochs == [list(ref) for _ in range(3)]
    assert len(port) == len(ref) == (3 if drop_last else 4)
    assert all(len(e) == len(port) for e in epochs)
    if shuffle:
        assert epochs[0] != epochs[1]  # a new order every epoch
    else:
        assert epochs[0] == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10]]


def test_prefetch_loader_stripes_processes():
    got = [sum(PrefetchLoader(10, 2, list, shuffle=True, seed=1, process_index=i,
                              process_count=3), []) for i in range(3)]
    assert sorted(sum(got, [])) == list(range(10)) and [len(g) for g in got] == [4, 3, 3]


def test_prefetch_loader_raises_worker_errors_in_order():
    def make(idxs):
        if idxs[0] == 4:
            raise ValueError("bad frame 4")
        return idxs

    it = iter(PrefetchLoader(8, 2, make, num_workers=3))
    assert next(it) == [0, 1] and next(it) == [2, 3]
    with pytest.raises(ValueError, match="bad frame 4"):
        next(it)


def test_registry():
    cfg = load_config(TINY)
    ds = get_dataset(cfg, "synthetic", "validation", False)
    assert isinstance(ds, SyntheticSceneDataset) and ds.seed_base == 10_000
    # the real-data datasets are ported: each reaches its own files (absent here)
    for name in ("panoptic", "panoptic_ssv", "shelf", "campus", "shelf_ssv", "campus_ssv",
                 "shelf_synthetic", "campus_synthetic"):
        with pytest.raises(FileNotFoundError):
            get_dataset(cfg, name, "train", True)
    with pytest.raises(KeyError):
        get_dataset(cfg, "nonsense", "train", True)
