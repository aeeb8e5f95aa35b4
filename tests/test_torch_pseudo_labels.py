"""The port's pseudo-label pipeline (``pseudo_labels/pipeline``,
``inference``, ``visualize``) and the 2D debug writers of ``utils/vis``
against the JAX package's, with fake detector and pose models.

Bars: stages s1 -> s7 write equal JSON files and DB pickles; the crops s4
hands its model are within the warp's bar of the JAX package's
(``cv2.warpAffine``: 1 level everywhere, mean under 0.01). The drawings
come from the port's anti-aliased rasteriser and the JAX package's
OpenCV: drawn over the same canvas, each person's ink centroid within
0.5 px and its ink within 15 % of OpenCV's; the overlay and dump files
have the JAX package's names (``.jpg``), sizes and ink.
"""

import json
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

import selfpose3d_tpu.pseudo_labels.inference as j_inference
import selfpose3d_tpu.pseudo_labels.pipeline as j_pipeline
import selfpose3d_tpu.pseudo_labels.visualize as j_visualize
import selfpose3d_tpu.utils.vis as j_vis

from selfpose3d_tpu_torch.data.structures import AugBranch
from selfpose3d_tpu_torch.data.synthetic_dataset import draw_capsule, draw_ring
from selfpose3d_tpu_torch.data.synthetic import ring_cameras
from selfpose3d_tpu_torch.pseudo_labels import inference, pipeline
from selfpose3d_tpu_torch.pseudo_labels import visualize
from selfpose3d_tpu_torch.utils import vis
from selfpose3d_tpu_torch.utils.zipreader import imread_any

W, H, N_IMAGES = 96, 72, 4


def _fixture(root):
    """Images (noise + a bright block per person), the train DB pickle."""
    rs = np.random.RandomState(0)
    db = []
    for i in range(N_IMAGES):
        img = rs.randint(0, 60, (H, W, 3), np.uint8)
        img[10 + 4 * i : 50, 20 : 40 + 6 * i] = 200
        path = os.path.join(root, f"img{i}.png")
        cv2.imwrite(path, img)
        db.append({"key": f"k{i}", "image": path, "camera": {"R": np.eye(3)}})
    pkl = os.path.join(root, "db.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"interval": 3, "cam_list": [(0, 3)], "sequence_list": ["seq"],
                     "db": db}, f)
    return pkl


def _detector(img):
    """One or two boxes whose place and keypoints follow the image's mean."""
    m = float(img.mean())
    boxes = np.array([[8.0, 6.0 + m % 5, 60.0, 66.0], [40.0, 10.0, 90.0, 70.0]])[: 1 + int(m) % 2]
    kps = np.zeros((len(boxes), 17, 3))
    for n, (x0, y0, x1, y1) in enumerate(boxes):
        kps[n, :, 0] = np.linspace(x0 + 2, x1 - 2, 17)
        kps[n, :, 1] = np.linspace(y0 + 2, y1 - 2, 17)[::-1]
        kps[n, :, 2] = 0.3 + 0.04 * np.arange(17)
    return {"boxes": boxes, "scores": np.array([0.95, 0.8])[: len(boxes)], "keypoints": kps}


def _run(pl, inf, root, crops):
    """s1 -> s7 of one package into ``root``; the crops s4 made go to ``crops``."""
    pkl = _fixture(root)
    p = {k: os.path.join(root, f"{k}.json") for k in ("images", "dets", "bboxes", "kps", "merged")}
    pl.create_image_list(pkl, p["images"])
    inf.run_person_detector(p["images"], "", p["dets"], model=_detector)
    pl.create_pseudo_bboxes(p["images"], p["dets"], p["bboxes"])
    calls = iter(range(100))

    def pose(crop):
        crops.append(crop)
        k = next(calls)
        kp = np.zeros((17, 3))
        kp[:, 0] = crop.shape[1] * (0.2 + 0.6 * np.linspace(0, 1, 17))
        kp[:, 1] = crop.shape[0] * (0.3 + 0.02 * k)
        kp[:, 2] = np.where(np.arange(17) % 5 == 4, 0.01, 0.9)
        return kp

    inf.run_topdown_keypoints(p["bboxes"], "", p["kps"], model=pose, input_wh=(48, 64))
    pl.merge_keypoints(p["bboxes"], p["kps"], p["merged"])
    pkls = pl.create_db_pickles(pkl, p["merged"], root)
    return p, pkls


def test_stages_s1_to_s7_equal_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jcrops, crops = [], []
    jp, jpkls = _run(j_pipeline, j_inference, str(tmp_path / "jax"), jcrops)
    tp, pkls = _run(pipeline, inference, str(tmp_path / "torch"), crops)
    for k in jp:
        with open(jp[k]) as a, open(tp[k]) as b:
            want, got = json.load(a), json.load(b)
        want, got = (json.loads(json.dumps(x).replace(str(tmp_path / "jax"), "ROOT")
                                .replace(str(tmp_path / "torch"), "ROOT")) for x in (want, got))
        assert got == want, k
    assert len(crops) == len(jcrops) > N_IMAGES
    for a, b in zip(jcrops, crops):
        d = np.abs(a.astype(int) - b)
        assert a.shape == b.shape == (64, 48, 3) and d.max() <= 1 and d.mean() < 0.01
    assert set(pkls) == set(jpkls)
    for k in pkls:
        with open(jpkls[k], "rb") as a, open(pkls[k], "rb") as b:
            want, got = pickle.load(a), pickle.load(b)
        for r in want["db"] + got["db"]:
            r["image"] = os.path.basename(r["image"])
        assert want.keys() == got.keys() and len(want["db"]) == len(got["db"]) == N_IMAGES
        for rw, rg in zip(want["db"], got["db"]):
            assert rw.keys() == rg.keys()
            for key in rw:
                if key in ("joints_2d", "joints_2d_vis", "camera"):
                    for x, y in zip(rw[key] if key != "camera" else [rw[key]["R"]],
                                    rg[key] if key != "camera" else [rg[key]["R"]]):
                        np.testing.assert_array_equal(x, y)
                else:
                    assert rw[key] == rg[key], key


def _ink(img):
    """Per-pixel ink: the largest channel change from the canvas (0)."""
    return img.astype(np.float64).max(axis=-1)


def _centroid(w):
    ys, xs = np.mgrid[: w.shape[0], : w.shape[1]]
    return np.array([(w * xs).sum(), (w * ys).sum()]) / w.sum()


@pytest.mark.parametrize("pairs", ["coco", "panoptic"])
def test_skeleton_drawing_inks_where_opencv_does(pairs):
    rs = np.random.RandomState(4)
    table = visualize.COCO_PAIRS if pairs == "coco" else visualize.PANOPTIC_PAIRS
    J = 17 if pairs == "coco" else 15
    for person in range(6):
        kp = np.concatenate([rs.rand(J, 2) * [150, 110] + [25, 25],
                             (rs.rand(J, 1) > 0.2).astype(float)], axis=1)
        color = visualize._PERSON_COLORS[person]
        want = j_visualize.draw_skeleton_2d(np.zeros((160, 200, 3), np.uint8), kp, table, color)
        got = visualize.draw_skeleton_2d(np.zeros((160, 200, 3), np.uint8), kp, table, color)
        iw, ig = _ink(want), _ink(got)
        assert np.abs(_centroid(iw) - _centroid(ig)).max() <= 0.5
        assert abs(ig.sum() / iw.sum() - 1) <= 0.15, ig.sum() / iw.sum()


def test_skeleton_drawing_touches_only_its_window():
    """Drawing inside the person's window equals drawing over a float copy
    of the whole image, also for joints at and past the image's edges."""
    rs = np.random.RandomState(7)
    for person in range(6):
        img = rs.randint(0, 256, (90, 120, 3)).astype(np.uint8)
        kp = np.concatenate([rs.rand(15, 2) * [60, 40] + rs.rand(2) * [100, 80] - 10,
                             (rs.rand(15, 1) > 0.2).astype(float)], axis=1)
        kp[0, :2] = (-3.0, 200.0)  # beyond the image: its limbs cross the window
        canvas = img.astype(np.float32)
        pix = {j: (int(round(x)), int(round(y))) for j, (x, y, c) in enumerate(kp) if c > 0}
        for a, b in visualize.PANOPTIC_PAIRS:
            if a in pix and b in pix:
                draw_capsule(canvas, pix[a], pix[b], visualize.aa_width(3),
                             np.asarray(visualize._PERSON_COLORS[person], np.float32))
        for x, y in pix.values():
            draw_ring(canvas, x, y, 4, visualize.aa_width(2), visualize._PERSON_COLORS[person])
            draw_ring(canvas, x, y, 5, visualize.aa_width(1), (0.0, 0.0, 0.0))
        want = np.clip(np.rint(canvas), 0, 255).astype(np.uint8)
        got = visualize.draw_skeleton_2d(img, kp, visualize.PANOPTIC_PAIRS,
                                         visualize._PERSON_COLORS[person])
        np.testing.assert_array_equal(got, want)


def test_default_models_take_the_device_and_local_weights(tmp_path, monkeypatch):
    """``inference.main`` runs its default models on ``--device`` (the card
    unless asked) and loads their weights only from a local file."""
    pkl = _fixture(str(tmp_path))
    images = str(tmp_path / "images.json")
    pipeline.create_image_list(pkl, images)
    s2 = ["s2", "--image-list", images, "--image-root", "", "--out", str(tmp_path / "d.json")]
    s4 = ["s4", "--pseudo-bboxes", images, "--image-root", "", "--out", str(tmp_path / "k.json")]
    with pytest.raises(FileNotFoundError, match="--detector-weights"):
        inference.main(s2 + ["--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="--pose-weights"):
        inference.main(s4 + ["--device", "cpu", "--pose-weights", str(tmp_path / "none.pth")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            inference.main(s2)
    asked = []

    def detector(device, weights):
        asked.append((device, weights))
        return _detector

    monkeypatch.setattr(inference, "_default_detector", detector)
    inference.main(s2 + ["--device", "cpu", "--detector-weights", "w.pth"])
    with open(tmp_path / "d.json") as f:
        assert asked == [("cpu", "w.pth")] and len(json.load(f)) > N_IMAGES


def test_overlay_writers_match_jax_files(tmp_path, monkeypatch):
    """s6 and s8 over missing images (black canvases): the port's files
    against the JAX package's, the arrays it hands ``cv2.imwrite`` as
    ``cv2.imwrite`` writes them (JPEG at quality 95)."""
    written = {}
    monkeypatch.setattr(cv2, "imwrite", lambda path, img: written.setdefault(path, img.copy()))
    rs = np.random.RandomState(1)
    images, anns = [], []
    for i in range(2):
        images.append({"id": i, "file_name": f"missing{i}.jpg", "width": 64, "height": 48})
        kp = np.concatenate([rs.rand(17, 2) * [50, 36] + 5, np.full((17, 1), 0.9)], 1)
        anns.append({"id": i + 1, "image_id": i, "keypoints": kp.reshape(-1).tolist()})
    pj = tmp_path / "pseudo.json"
    pj.write_text(json.dumps({"images": images, "annotations": anns}))
    dbs = []
    for jitter in (0.0, 2.0):
        recs = [{"key": f"k{i}", "image": f"missing{i}.jpg", "width": 64, "height": 48,
                 "joints_2d": [rs.rand(15, 2) * 40 + 4 + jitter],
                 "joints_2d_vis": [np.ones((15, 3))]} for i in range(2)]
        path = tmp_path / f"db{jitter}.pkl"
        with open(path, "wb") as f:
            pickle.dump({"db": recs}, f)
        dbs.append(str(path))
    for stage in ("s6", "s8"):
        outs = []
        for mod, sub in ((j_visualize, "jax"), (visualize, "torch")):
            if stage == "s6":
                outs.append(mod.vis_pseudo_kpt2d(str(pj), str(tmp_path), str(tmp_path / sub),
                                                 num_samples=2))
            else:
                outs.append(mod.vis_compare_pseudo_kpt2d(*dbs, str(tmp_path), str(tmp_path / sub),
                                                         num_samples=2))
        for a, b in zip(*outs):
            assert os.path.basename(a) == os.path.basename(b) and b.endswith(".jpg")
            jax_file = cv2.imdecode(cv2.imencode(os.path.splitext(a)[1], written[a])[1], 1)
            ia, ib = _ink(jax_file), _ink(imread_any(b))
            assert ia.shape == ib.shape and ib.max() > 0
            assert abs(ib.sum() / ia.sum() - 1) <= 0.15
            assert np.abs(_centroid(ia) - _centroid(ib)).max() <= 0.5


def _branch(rs, B=1, V=3, Hh=64, Wh=96, P=2, J=15):
    cam = ring_cameras(V, image_wh=(Wh * 4, Hh * 4), seed=0)
    cam = type(cam)(*(t.expand(B, *t.shape[1:]).contiguous() for t in (cam.R, cam.T, cam.f,
                                                                     cam.c, cam.k, cam.p)))
    s = 0.25
    trans = torch.tensor([[s, 0, 0], [0, s, 0], [0, 0, 1]], dtype=torch.float32).expand(B, V, 3, 3)
    return AugBranch(
        cam=cam, trans=trans.contiguous(), orig_wh=torch.full((B, V, 2), 100.0),
        hflip=torch.zeros(B, dtype=torch.bool),
        # smooth views: JPEG keeps them within a few levels
        views=torch.from_numpy(np.broadcast_to(
            np.linspace(0.1, 0.4, Wh, dtype=np.float32)[None, None, None, :, None],
            (B, V, Hh, Wh, 3)).copy()),
        joints=torch.from_numpy(rs.rand(B, V, P, J, 2).astype(np.float32) * [Wh, Hh]),
        joints_vis=torch.ones(B, V, P, J, 2))


def test_debug_writers_match_jax_files(tmp_path, monkeypatch):
    """``save_batch_image_with_joints``, ``save_batch_heatmaps`` and
    ``save_multiview_composite`` against the arrays the JAX package hands
    ``cv2.imwrite`` (before JPEG): same sizes, the same pixels but for the
    drawings (mean difference under 1 level), the drawings' ink centroid
    within 0.5 px."""
    import jax.numpy as jnp

    from selfpose3d_tpu.data.structures import AugBranch as JBranch
    from selfpose3d_tpu.geometry.cameras import CameraParams as JCam

    written = {}
    monkeypatch.setattr(cv2, "imwrite", lambda path, img: written.setdefault(path, img.copy()))
    rs = np.random.RandomState(2)
    br = _branch(rs)
    jbr = JBranch(cam=JCam(*(jnp.asarray(getattr(br.cam, f).numpy())
                             for f in ("R", "T", "f", "c", "k", "p"))),
                  trans=jnp.asarray(br.trans.numpy()), orig_wh=jnp.asarray(br.orig_wh.numpy()),
                  hflip=jnp.asarray(br.hflip.numpy()), views=jnp.asarray(br.views.numpy()))
    pred = np.concatenate([rs.randn(1, 3, 15, 3) * 300 + [0, -500, 900],
                           np.zeros((1, 3, 15, 1)), np.ones((1, 3, 15, 1))], -1)
    pred[0, 2, :, 3] = -1
    flat = br.views.numpy().reshape(3, 64, 96, 3)
    joints = br.joints.numpy().reshape(3, 2, 15, 2)
    yy, xx = np.mgrid[:32, :48]
    hm = np.exp(-((xx[None, :, :, None] - 6 - 2 * np.arange(15)) ** 2 + (yy[None, :, :, None] - 16)
                  ** 2) / 40.0).repeat(4, 0).astype(np.float32)
    none = pred.copy()
    none[..., 3] = -1
    calls = {  # stem: (JAX call, port call), each with a flag: draw or not
        "a": (lambda f, draw: j_vis.save_batch_image_with_joints(
                  flat, joints, np.full_like(joints, float(draw)), f),
              lambda f, draw: vis.save_batch_image_with_joints(
                  flat, joints, np.full_like(joints, float(draw)), f)),
        "h": (lambda f, draw: j_vis.save_batch_heatmaps(flat[:3], hm[:3] * draw, f),
              lambda f, draw: vis.save_batch_heatmaps(flat[:3], hm[:3] * draw, f)),
        "m": (lambda f, draw: j_vis.save_multiview_composite(None, jbr, pred if draw else none, f),
              lambda f, draw: vis.save_multiview_composite(
                  None, br, torch.from_numpy(pred if draw else none), f)),
    }
    for stem, (jax_call, port_call) in calls.items():
        imgs = {}
        for draw in (False, True):
            jax_call(str(tmp_path / f"{stem}{draw}.jpg"), draw)
            port_call(str(tmp_path / f"{stem}{draw}.png"), draw)
            imgs[draw] = (written[str(tmp_path / f"{stem}{draw}.jpg")].astype(np.float64),
                          imread_any(str(tmp_path / f"{stem}{draw}.png")).astype(np.float64))
        (bg_j, bg_t), (want, got) = imgs[False], imgs[True]
        assert want.shape == got.shape and np.abs(bg_j - bg_t).max() <= 1, stem
        ink_j, ink_t = np.abs(want - bg_j).max(-1), np.abs(got - bg_t).max(-1)
        assert ink_j.sum() > 0 and abs(ink_t.sum() / ink_j.sum() - 1) <= 0.15, stem
        assert np.abs(_centroid(ink_j) - _centroid(ink_t)).max() <= 0.5, stem
