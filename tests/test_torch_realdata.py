"""The port's real-data datasets against the JAX package's, on fabricated
trees in the reference's layouts: a mini CMU Panoptic tree written by
``mini_panoptic.write_panoptic_tree`` (calibration and ``hdPose3d_stage1_coco19``
JSON, rendered 960x540 views stored as JPEG by the port's encoder, which
the JAX package reads through OpenCV and the port through its own codec), the
Shelf/Campus files (``actorsGT.mat``, calibration, 2D predictions, the
mmpose pickle, a pose bank), plus ``utils/flip``, ``eval/tracking`` and
both evaluation protocols. The sequence lists are cut to 2 train and 1
validation sequences, the camera count to 3.

Bars: sequence parses, DB pickles, evaluation tables and track orders are
equal; every non-image entry of a frame (targets, weights, joints,
``trans``, cameras, flags) within 1e-6; images within the warp's bar
(1/255 everywhere, mean under 0.01/255) with RandAugment off, and with it
on (the JAX package through Pillow) a mean difference under 0.01/255 and
the same augmentation draws (``trans`` and flips equal).
"""

import copy
import json
import os
import pickle

import numpy as np
import pytest
import scipy.io as scio

import selfpose3d_tpu.data.panoptic as j_panoptic
import selfpose3d_tpu.data.skeleton as j_skel
import selfpose3d_tpu.eval.tracking as j_tracking
import selfpose3d_tpu.utils.flip as j_flip
from selfpose3d_tpu.config import load_config as j_load_config
from selfpose3d_tpu.data.registry import get_dataset as j_get_dataset

import selfpose3d_tpu_torch.data.panoptic as panoptic
import selfpose3d_tpu_torch.mini_panoptic as mini_panoptic
import selfpose3d_tpu_torch.data.skeleton as skel
import selfpose3d_tpu_torch.eval.tracking as tracking
import selfpose3d_tpu_torch.utils.flip as flip
from selfpose3d_tpu_torch.config import load_config
from selfpose3d_tpu_torch.data.registry import get_dataset
from selfpose3d_tpu_torch.data.shelf_campus import _DATASET_SPEC

TRAIN_SEQS, VAL_SEQS = skel.PANOPTIC_TRAIN_LIST[:2], skel.PANOPTIC_VAL_LIST[:1]
V = 3
SMALL = {"NETWORK": {"IMAGE_SIZE": [192, 128], "HEATMAP_SIZE": [48, 32], "SIGMA": 2,
                     "NUM_JOINTS": 15},
         "MULTI_PERSON": {"MAX_PEOPLE_NUM": 5, "INITIAL_CUBE_SIZE": [16, 16, 8]},
         "DATASET": {"ROOT": "panoptic", "CAMERA_NUM": V, "CAMERA_NUM_TOTAL": V,
                     "CAMERAS": list(range(V)), "ROOTIDX": 2}}


def _merge(a, b):
    out = copy.deepcopy(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and k in out else v
    return out


def _cfgs(data_dir, **overrides):
    o = _merge(_merge(SMALL, {"DATA_DIR": str(data_dir)}), overrides)
    return j_load_config(overrides=o), load_config(overrides=o)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The mini Panoptic tree with the sequence lists of both packages cut."""
    mp = pytest.MonkeyPatch()
    for mod in (skel, j_skel):
        mp.setattr(mod, "PANOPTIC_TRAIN_LIST", TRAIN_SEQS)
        mp.setattr(mod, "PANOPTIC_VAL_LIST", VAL_SEQS)
    data_dir = tmp_path_factory.mktemp("panoptic_tree")
    root, poses = mini_panoptic.write_panoptic_tree(str(data_dir), image_wh=(960, 540))
    os.symlink(root, os.path.join(data_dir, "panoptic"))
    yield data_dir, poses
    mp.undo()


def _assert_same(a, b, path="", atol=1e-6):
    """Nested dicts / lists / arrays equal (floats within ``atol``)."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}", atol)
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]", atol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        if a.dtype.kind in "fc" or b.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) or isinstance(b, float):
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= atol, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _assert_views(jv, tv, randaug=False):
    """Every entry equal within 1e-6 but the image; the image within the
    warp's bar (or the RandAugment bar)."""
    assert len(jv) == len(tv)
    for a, b in zip(jv, tv):
        ia, ib = a.pop("image"), b.pop("image")
        _assert_same(a, b)
        d = np.abs(ia.astype(np.float64) - ib)
        if not randaug:
            assert d.max() <= 1 / 255 + 1e-6, d.max()
        assert d.mean() <= 0.01 / 255, d.mean()


def test_parse_panoptic_sequence_equals_jax(tree):
    data_dir, poses = tree
    root = os.path.join(data_dir, "panoptic")
    cams = skel.PANOPTIC_CAM_LIST[:V]
    for seq in TRAIN_SEQS + VAL_SEQS:
        got = panoptic.parse_panoptic_sequence(root, seq, cams, 1)
        _assert_same(j_panoptic.parse_panoptic_sequence(root, seq, cams, 1), got)
        assert len(got) == V and len(got[0]["joints_3d"]) == len(poses[seq])
        # the parse undoes the tree's axes swap and cm: the world poses back
        np.testing.assert_allclose(np.stack(got[0]["joints_3d"]), poses[seq], atol=1e-6)


@pytest.mark.parametrize("image_set", ["train", "validation"])
def test_db_pickle_equals_jax(tree, image_set):
    data_dir, _ = tree
    jcfg, cfg = _cfgs(data_dir, DATASET={"SUFFIX": "dbtest"})
    pkl = os.path.join(data_dir, "panoptic",
                       f"group_{image_set}_cam{V}_{'dbtest' if image_set == 'train' else 'sub'}.pkl")
    blobs = []
    for make, c in ((panoptic.PanopticDataset, cfg), (j_panoptic.PanopticDataset, jcfg)):
        if os.path.exists(pkl):  # written by another test: parse anew
            os.remove(pkl)
        ds = make(c, image_set, image_set == "train")
        with open(pkl, "rb") as f:
            blobs.append(pickle.load(f))
        os.remove(pkl)
        assert len(ds) == len(TRAIN_SEQS if image_set == "train" else VAL_SEQS)
    _assert_same(blobs[1], blobs[0], atol=0)


@pytest.mark.parametrize("randaug", [False, True])
def test_get_frame_equals_jax(tree, randaug):
    data_dir, _ = tree
    jcfg, cfg = _cfgs(data_dir, DATASET={"SUFFIX": "frames", "APPLY_RANDAUG": randaug,
                                         "APPLY_CUTOUT": randaug, "COLOR_RGB": True})
    image_set = "train" if randaug else "validation"
    jds = j_get_dataset(jcfg, "panoptic", image_set, randaug)
    ds = get_dataset(cfg, "panoptic", image_set, randaug)
    for i in range(len(ds)):
        jf, tf = jds.get_frame(i, seed=3), ds.get_frame(i, seed=3)
        assert jf["frame_idx"] == tf["frame_idx"]
        _assert_views(jf["views"], tf["views"], randaug)


@pytest.mark.parametrize("randaug", [False, True])
def test_ssv_frame_equals_jax(tree, randaug):
    data_dir, _ = tree
    jcfg, cfg = _cfgs(data_dir, DATASET={
        "SUFFIX": "ssv", "APPLY_RANDAUG": randaug, "APPLY_CUTOUT": randaug, "FLIP": True,
        "ROT_FACTOR1": 45, "ROT_FACTOR2": 45, "SCALE_FACTOR1": 0.35, "SCALE_FACTOR2": 0.35,
        "COLOR_RGB": True})
    jds = j_get_dataset(jcfg, "panoptic_ssv", "train", True)
    ds = get_dataset(cfg, "panoptic_ssv", "train", True)
    flips = set()
    for seed in (0, 1):
        for i in range(len(ds)):
            for jb, tb in zip(jds.get_ssv_frame(i, seed=seed), ds.get_ssv_frame(i, seed=seed)):
                flips.add(bool(tb[0]["hflip"]))
                _assert_views(jb, tb, randaug)
    assert flips == {False, True}


def _shelf_files(root, name, rs, P=3, J=14):
    """The Shelf/Campus files of ``name`` under ``root``: calibration, GT
    actors (``actorsGT.mat``, the reference's cell layout), 2D predictions,
    the mmpose pickle of the SSV dataset and a Panoptic pose bank."""
    spec = _DATASET_SPEC[name]
    cams = spec["cam_list"]
    calib = {c: {"R": np.eye(3).tolist(), "T": [[300.0 * int(c)], [-4000.0], [1500.0]],
                 "fx": 1000.0, "fy": 1000.0, "cx": spec["width"] / 2, "cy": spec["height"] / 2,
                 "k": [[0.0], [0.0], [0.0]], "p": [[0.0], [0.0]]} for c in cams}
    with open(os.path.join(root, spec["calib"]), "w") as f:
        json.dump(calib, f)
    frames = max(spec["frame_range"]) + 1
    inner = np.empty((1, P), object)
    for p in range(P):
        cells = np.empty((frames, 1), object)
        for fi in range(frames):
            seen = (fi + p) % 4 != 0
            cells[fi, 0] = rs.rand(J, 3) * 2 + [0, 0, 0.2] if seen else np.zeros((1, 0))
        inner[0, p] = cells
    outer = np.empty((1, 1), object)
    outer[0, 0] = inner
    scio.savemat(os.path.join(root, "actorsGT.mat"), {"actor3D": outer})
    preds = {}
    for fi in spec["frame_range"][:6]:
        for c in cams:
            preds[f"{c}_{fi}"] = [
                {"pred": np.concatenate([rs.rand(17, 2) * [spec["width"], spec["height"]],
                                         rs.rand(17, 1)], axis=1)}
                for _ in range(1 + fi % 2)]
    with open(os.path.join(root, spec["pred_file"]), "wb") as f:
        pickle.dump(preds, f)
    db = []
    for fi in range(4):
        for c in range(len(cams)):
            n = 1 + (fi + c) % 3
            db.append({"key": f"{name}_{fi}", "image": f"Camera{c}/img_{fi:06d}.png",
                       "joints_2d": [(rs.rand(J, 2) * [spec["width"] * 0.6, spec["height"] * 0.6]
                                      + [spec["width"] * 0.2, spec["height"] * 0.2])
                                     for _ in range(n)],
                       "joints_2d_vis": [np.ones((J, 3)) for _ in range(n)]})
    with open(os.path.join(root, f"{name}_mmpose.pkl"), "wb") as f:
        pickle.dump({"db": db}, f)
    with open(os.path.join(root, "panoptic_training_pose.pkl"), "wb") as f:
        pickle.dump([rs.randn(15, 3) * 200 + [0, 0, 900] for _ in range(20)], f)
    return spec


@pytest.mark.parametrize("name", ["shelf", "campus"])
def test_shelf_campus_datasets_equal_jax(tmp_path, name):
    rs = np.random.RandomState(5)
    spec = _shelf_files(str(tmp_path), name, rs)
    cams = len(spec["cam_list"])
    net = {"NUM_JOINTS": 14, "IMAGE_SIZE": [320, 256], "HEATMAP_SIZE": [80, 64],
           "IMAGE_SIZE_ORIG": [spec["width"], spec["height"]], "SIGMA": 3}
    data = {"ROOT": "", "CAMERA_NUM": cams, "CAMERA_NUM_TOTAL": cams,
            "CAMERAS": list(range(cams)), "ROT_FACTOR1": 30, "SCALE_FACTOR1": 0.2,
            "ROT_FACTOR2": 30, "SCALE_FACTOR2": 0.2, "FLIP": False}
    jcfg, cfg = _cfgs(tmp_path, NETWORK=net, DATASET=data)
    # the evaluation dataset: heatmaps of the 2D predictions, GT roots
    jds = j_get_dataset(jcfg, name, "validation", False)
    ds = get_dataset(cfg, name, "validation", False)
    assert len(ds) == len(jds) == len(spec["frame_range"])
    for i in (0, 1, 5, 7):
        _assert_same(jds.get_frame(i), ds.get_frame(i))
    # its PCP protocol on random 15-joint predictions
    preds = []
    for i in range(len(ds)):
        k = 1 + i % 3
        p = np.concatenate([rs.rand(k, 15, 3) * 2000, np.zeros((k, 15, 1)),
                            rs.rand(k, 15, 1)], axis=-1)
        preds.append(p)
    _assert_same(jds.evaluate(preds), ds.evaluate(preds))
    # the SSV dataset over the mmpose pickle (images absent: None)
    jds = j_get_dataset(jcfg, f"{name}_ssv", "train", True)
    ds = get_dataset(cfg, f"{name}_ssv", "train", True)
    for i in range(len(ds)):
        for jb, tb in zip(jds.get_ssv_frame(i, seed=1), ds.get_ssv_frame(i, seed=1)):
            _assert_same(jb, tb)
    # the synthetic training scenes over the pose bank
    jds = j_get_dataset(_merge_cfg(jcfg, 15), f"{name}_synthetic", "train", True)
    ds = get_dataset(_merge_cfg(cfg, 15), f"{name}_synthetic", "train", True)
    assert len(ds) == len(jds) == 3000
    for i in range(4):
        _assert_same(jds.get_frame(i, seed=2), ds.get_frame(i, seed=2))


def _merge_cfg(cfg, J):
    import dataclasses

    return dataclasses.replace(cfg, NETWORK=dataclasses.replace(cfg.NETWORK, NUM_JOINTS=J))


def test_panoptic_evaluate_equals_jax(tree, tmp_path):
    data_dir, _ = tree
    jcfg, cfg = _cfgs(data_dir)
    jds = j_get_dataset(jcfg, "panoptic", "validation", False)
    ds = get_dataset(cfg, "panoptic", "validation", False)
    rs = np.random.RandomState(7)
    preds, roots = [], []
    for i in range(len(ds)):
        gt = np.stack(ds.db[V * i]["joints_3d"])
        k = len(gt) + 1
        pose = np.concatenate([gt + rs.randn(*gt.shape) * 40, rs.rand(1, 15, 3) * 3000])
        pred = np.concatenate([pose, np.zeros((k, 15, 1)), np.repeat(rs.rand(k, 1, 1), 15, 1)], -1)
        pred[-1, :, 3] = -1  # an invalid slot
        preds.append(pred)
        roots.append(np.concatenate([pose[:, 2], np.zeros((k, 1)), rs.rand(k, 1)], -1))
    want = jds.evaluate(preds, roots, str(tmp_path / "jax"))
    got = ds.evaluate(preds, roots, str(tmp_path / "torch"))
    _assert_same(want, got, atol=0)
    assert 0 < got["aps"][-1] and np.isfinite(got["mpjpe"])
    dumps = []
    for side in ("jax", "torch"):
        with open(tmp_path / side / "predictions_dump.pkl", "rb") as f:
            dumps.append(pickle.load(f))
    _assert_same(dumps[0], dumps[1], atol=0)


def test_flip_utilities_equal_jax():
    rs = np.random.RandomState(0)
    pairs = flip.flip_pairs_from_order(skel.FLIP_LR_JOINTS15)
    assert pairs == j_flip.flip_pairs_from_order(j_skel.FLIP_LR_JOINTS15)
    hm = rs.rand(2, 15, 8, 12)
    np.testing.assert_array_equal(flip.flip_back(hm, pairs), j_flip.flip_back(hm, pairs))
    joints, vis = rs.rand(15, 3) * 100, (rs.rand(15, 3) > 0.3).astype(np.float64)
    for a, b in zip(flip.fliplr_joints(joints, vis, 128, pairs),
                    j_flip.fliplr_joints(joints, vis, 128, pairs)):
        np.testing.assert_array_equal(a, b)


def test_track_sequence_equals_jax():
    rs = np.random.RandomState(11)
    for trial in range(5):
        base = rs.rand(4, 15, 3) * 3000
        poses, scores = [], []
        for f in range(6):
            n = rs.randint(0, 5)
            order = rs.permutation(4)[:n]
            poses.append(base[order] + rs.randn(n, 15, 3) * 30 + f * 20)
            scores.append(rs.rand(n))
        for args in ((poses,), (poses, scores, 0.3)):
            want = j_tracking.track_sequence(*args)
            got = tracking.track_sequence(*args)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
