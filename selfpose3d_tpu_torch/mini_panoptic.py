"""A mini CMU Panoptic tree in the reference's layout, its pseudo labels,
and one drive of the real-data path over it: the fixture of
``chip_smoke.py``'s phase realdata and of the port's real-data tests,
since the dataset's images, calibration and pseudo labels are not in the
repository.

``write_panoptic_tree`` writes the tree (calibration and
``hdPose3d_stage1_coco19`` JSON, views rendered by the port's rasteriser
and stored as PNG at the ``.jpg`` paths, which the reader decodes by
content); ``build_pseudo_labels`` runs the pseudo-label stages over it
with fake models; ``run_realdata`` trains one epoch through the train
CLI with the debug dumps, validates, evaluates a reference-layout
checkpoint through the evaluate CLI and tracks its predictions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import shutil
import time

import numpy as np
import torch

from selfpose3d_tpu_torch.cli import evaluate as evaluate_cli
from selfpose3d_tpu_torch.cli import train_3d
from selfpose3d_tpu_torch.config import get_model_name
from selfpose3d_tpu_torch.data import skeleton
from selfpose3d_tpu_torch.data.panoptic import M_AXES, PanopticDataset
from selfpose3d_tpu_torch.data.registry import get_dataset
from selfpose3d_tpu_torch.data.synthetic import random_poses, ring_cameras
from selfpose3d_tpu_torch.data.synthetic_dataset import render_stick_figures
from selfpose3d_tpu_torch.eval.tracking import track_sequence
from selfpose3d_tpu_torch.geometry.cameras_np import project_pose_np
from selfpose3d_tpu_torch.geometry.transforms import get_affine_transform_3x3
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.ops import slicewarp
from selfpose3d_tpu_torch.pseudo_labels import inference, pipeline
from selfpose3d_tpu_torch.pseudo_labels import visualize as pseudo_vis
from selfpose3d_tpu_torch.train import checkpoint
from selfpose3d_tpu_torch.train.checkpoint import save_reference_checkpoint
from selfpose3d_tpu_torch.train.train_state import create_train_state
from selfpose3d_tpu_torch.utils.image_io import imwrite_png
from selfpose3d_tpu_torch.utils.zipreader import imread_any

# the COCO-17 joint of each Panoptic-15 joint that has one (eyes and ears
# are placed about the nose)
PANOPTIC_OF_COCO = (1, None, None, None, None, 3, 9, 4, 10, 5, 11, 6, 12, 7, 13, 8, 14)
COCO_FACE_OFFSETS = {1: (-12, -8), 2: (12, -8), 3: (-24, 0), 4: (24, 0)}


def panoptic_camera_json(cam, v, node, image_wh):
    """One HD camera of a ``calibration_<seq>.json`` whose parse (axes swap,
    cm -> mm) gives back camera ``v`` of the (1, V) CameraParams ``cam``:
    R_json = R M^T, t_json = -R T / 10 (cm)."""
    R = cam.R[0, v].double().numpy()
    T = cam.T[0, v].double().numpy()
    K = [[float(cam.f[0, v, 0]), 0.0, float(cam.c[0, v, 0])],
         [0.0, float(cam.f[0, v, 1]), float(cam.c[0, v, 1])], [0.0, 0.0, 1.0]]
    return {"name": f"00_{node:02d}", "type": "hd", "panel": 0, "node": node,
            "resolution": list(image_wh), "K": K, "distCoef": [0.0] * 5,
            "R": (R @ M_AXES.T).tolist(), "t": (-R @ T / 10.0).tolist()}


def write_panoptic_tree(data_dir, image_wh=(1920, 1080), seed=0):
    """A mini CMU Panoptic tree in the panoptic-toolbox layout under
    ``data_dir/data/panoptic-toolbox/data``: for every sequence of the
    train and validation lists, ``calibration_<seq>.json`` (the five HD
    cameras of PANOPTIC_CAM_LIST on a ring, and one VGA camera the
    datasets skip) and one frame, ``hdPose3d_stage1_coco19/
    body3DScene_00000000.json`` with 2-3 people (joints19 in cm, axes as the
    toolbox stores them), whose five views are rendered with the port's
    rasteriser and written as PNG at the ``hdImgs/<cam>/<cam>_00000000.jpg``
    paths the DB records name (the reader decodes by content). Returns the
    dataset root and the world poses (mm) by sequence."""
    root = os.path.join(data_dir, "data", "panoptic-toolbox", "data")
    J = 15
    poses_by_seq = {}
    seqs = skeleton.PANOPTIC_TRAIN_LIST + skeleton.PANOPTIC_VAL_LIST
    for s, seq in enumerate(seqs):
        cam = ring_cameras(len(skeleton.PANOPTIC_CAM_LIST), image_wh=image_wh, seed=seed + s)
        cams = [panoptic_camera_json(cam, v, node, image_wh)
                for v, (_, node) in enumerate(skeleton.PANOPTIC_CAM_LIST)]
        vga = dict(cams[0], name="01_01", type="vga", panel=1, node=1)
        seq_dir = os.path.join(root, seq)
        os.makedirs(os.path.join(seq_dir, "hdPose3d_stage1_coco19"), exist_ok=True)
        with open(os.path.join(seq_dir, f"calibration_{seq}.json"), "w") as f:
            json.dump({"calibDataSource": seq, "cameras": [vga] + cams}, f)
        n = 2 + s % 2
        poses = random_poses(n, J, seed=seed + 100 + s, root_idx=2).astype(np.float64)
        poses_by_seq[seq] = poses
        bodies = []
        for p in range(n):
            j19 = np.zeros((19, 4))
            j19[:J, :3] = (poses[p] / 10.0) @ M_AXES.T
            j19[:J, 3] = 0.9
            bodies.append({"id": p, "joints19": j19.reshape(-1).tolist()})
        with open(os.path.join(seq_dir, "hdPose3d_stage1_coco19",
                               "body3DScene_00000000.json"), "w") as f:
            json.dump({"version": 0.7, "univTime": 0.0, "fpsType": "hd_29_97",
                       "bodies": bodies}, f)
        rs = np.random.RandomState(seed + 200 + s)
        for v, (panel, node) in enumerate(skeleton.PANOPTIC_CAM_LIST):
            c = cams[v]
            npcam = {"R": cam.R[0, v].numpy(), "T": cam.T[0, v].numpy(),
                     "fx": c["K"][0][0], "fy": c["K"][1][1], "cx": c["K"][0][2],
                     "cy": c["K"][1][2], "k": np.zeros((3, 1)), "p": np.zeros((2, 1))}
            pix = [project_pose_np(poses[p], npcam).astype(np.float32) for p in range(n)]
            vis = [np.ones((J, 2), np.float32) for _ in range(n)]
            img = render_stick_figures(pix, vis, image_wh, rs, J)
            prefix = f"{panel:02d}_{node:02d}"
            img_dir = os.path.join(seq_dir, "hdImgs", prefix)
            os.makedirs(img_dir, exist_ok=True)
            rgb = np.rint(img * 255).astype(np.uint8)
            imwrite_png(os.path.join(img_dir, f"{prefix}_00000000.jpg"), rgb[..., ::-1])
    return root, poses_by_seq


def coco_from_panoptic(j2d, vis):
    """(17, 3) COCO keypoints [x, y, score] of one person's Panoptic-15
    (J, 2) joints; score 0.9 where visible, 0 elsewhere."""
    out = np.zeros((17, 3))
    for k, j in enumerate(PANOPTIC_OF_COCO):
        src = 1 if j is None else j
        dx, dy = COCO_FACE_OFFSETS.get(k, (0, 0))
        out[k] = (j2d[src, 0] + dx, j2d[src, 1] + dy, 0.9 if vis[src, 0] > 0 else 0.0)
    return out


def build_pseudo_labels(cfg, work_dir, seed=0):
    """Stages s1 -> s8 of the pseudo-label pipeline over the train split's
    GT DB (written as ``group_train_cam5_sub.pkl`` by PanopticDataset),
    with a fake person detector and a fake top-down pose model that return
    the projected ground truth plus seeded noise (2 px): a box for each
    person with 4 or more joints inside the image, the keypoints in each
    crop's pixels. Writes the four DB pickles (s7) beside
    the GT DB, ``group_train_cam5_pseudo_hrnet_soft_9videos.pkl`` among
    them; -> a summary."""
    gt_cfg = dataclasses.replace(cfg, DATASET=dataclasses.replace(cfg.DATASET, SUFFIX="sub"))
    gt = PanopticDataset(gt_cfg, "train", True)
    gt_pkl = os.path.join(gt.dataset_root, "group_train_cam5_sub.pkl")
    rs = np.random.RandomState(seed)
    os.makedirs(work_dir, exist_ok=True)
    path = {k: os.path.join(work_dir, f"{k}.json")
            for k in ("images", "dets", "bboxes", "kps", "merged")}
    pipeline.create_image_list(gt_pkl, path["images"])  # s1, sizes read from the images
    records = iter(gt.db)
    emitted, expected = [], []

    def detector(img):  # s2: a box for each GT person in sight, in image order
        rec = next(records)
        boxes, scores, kps = [], [], []
        for j2d, vis in zip(rec["joints_2d"], rec["joints_2d_vis"]):
            coco = coco_from_panoptic(j2d, vis)
            coco[:, :2] += rs.randn(17, 2) * 2.0
            inside = ((coco[:, 0] >= 0) & (coco[:, 0] < img.shape[1])
                      & (coco[:, 1] >= 0) & (coco[:, 1] < img.shape[0]))
            coco[~inside, 2] = 0.0
            seen = coco[coco[:, 2] > 0, :2]
            if len(seen) < 4:
                continue
            (x0, y0), (x1, y1) = seen.min(0) - 30, seen.max(0) + 30
            boxes.append([x0, y0, x1, y1])
            scores.append(0.9 + 0.09 * rs.rand())
            kps.append(coco)
            emitted.append(([x0, y0, x1 - x0, y1 - y0], coco))
        expected.append(len(boxes))
        return {"boxes": np.array(boxes).reshape(-1, 4), "scores": np.array(scores),
                "keypoints": np.array(kps).reshape(-1, 17, 3)}

    dets = inference.run_person_detector(path["images"], "", path["dets"], model=detector)
    bboxes = pipeline.create_pseudo_bboxes(path["images"], path["dets"], path["bboxes"])  # s3
    in_wh = (288, 384)
    queue = iter(emitted)

    def pose_model(crop):  # s4: the person of the next box, in crop pixels
        assert crop.shape == (in_wh[1], in_wh[0], 3), crop.shape
        bbox, coco = next(queue)
        center, scale = inference.bbox_center_scale(bbox, in_wh[0] / in_wh[1])
        trans = get_affine_transform_3x3(center, scale, 0, in_wh)
        out = coco.copy()
        out[:, :2] = coco[:, :2] @ trans[:2, :2].T + trans[:2, 2] + rs.randn(17, 2) * 2.0
        return out

    kps = inference.run_topdown_keypoints(path["bboxes"], "", path["kps"], model=pose_model,
                                          input_wh=in_wh)
    merged = pipeline.merge_keypoints(path["bboxes"], path["kps"], path["merged"])  # s5
    s6 = pseudo_vis.vis_pseudo_kpt2d(path["merged"], "", os.path.join(work_dir, "s6"), num_samples=3)
    pkls = pipeline.create_db_pickles(gt_pkl, path["merged"], gt.dataset_root)  # s7
    s8 = pseudo_vis.vis_compare_pseudo_kpt2d(gt_pkl, pkls["hrnet_soft"], "",
                                       os.path.join(work_dir, "s8"), num_samples=2)
    with open(pkls["hrnet_soft"], "rb") as f:
        soft = pickle.load(f)
    people = [len(r["joints_2d"]) for r in soft["db"]]
    gt_people = [len(r["joints_2d"]) for r in gt.db]
    # every person with 4 or more joints in the view keeps a pseudo label
    assert len(soft["db"]) == len(gt.db) and people == expected, (people, expected)
    for p in s6 + s8:
        assert image_inked(p), p
    return {"gt_records": len(gt.db), "detections": len(dets),
            "pseudo_bboxes": len(bboxes["annotations"]), "keypoints": len(kps),
            "merged": len(merged["annotations"]), "people_per_record": people,
            "gt_people_per_record": gt_people,
            "pickles": sorted(os.path.basename(p) for p in pkls.values()),
            "overlays_s6_s8": len(s6) + len(s8)}


def image_inked(path):
    """The PNG at ``path`` decodes and is not one colour."""
    img = imread_any(path)
    return img is not None and int(img.max()) > int(img.min())


REALDATA_CHANGED = {
    "MULTI_PERSON.THRESHOLD": -100.0, "DEBUG.DEBUG": True, "PRINT_FREQ": 1,
    "TRAIN.END_EPOCH": 1, "TRAIN.RESUME": False}


def realdata_sets(data_dir, out_dir, stage_file, extra=None):
    """The ``--set`` list of phase realdata's CLI calls: the tree, the output
    dir, REALDATA_CHANGED, the two stage files of the YAML replaced by
    ``stage_file``, and ``extra``."""
    sets = {"DATA_DIR": data_dir, "OUTPUT_DIR": out_dir, "LOG_DIR": out_dir,
            "NETWORK.PRETRAINED_BACKBONE": stage_file, "NETWORK.INIT_ROOTNET": stage_file,
            **REALDATA_CHANGED, **(extra or {})}
    return [a for k, v in sets.items() for a in ("--set", f"{k}={json.dumps(v)}")]


def run_realdata(work, yaml_path, device="cuda", extra=None, seed=0, image_wh=(1920, 1080)):
    """The real-data path on ``device`` under ``work``: the mini Panoptic
    tree (views of ``image_wh``), the pseudo labels, one epoch of
    ``cli.train_3d`` on ``yaml_path`` with REALDATA_CHANGED and ``extra``
    (``--set`` values) and its validation, the epoch's checkpoint as a
    reference ``.pth.tar``, ``cli.evaluate`` on it with ``--vis-attn``,
    and ``track_sequence`` over the predictions dump. The sampler launches
    are read as the loops record them: a train step's are the epoch's less
    its debug dumps' (all zero on the CPU). -> a report."""
    shutil.rmtree(work, ignore_errors=True)
    data_dir, out_dir = os.path.join(work, "tree"), os.path.join(work, "out")
    t0 = time.perf_counter()
    _, sequences = write_panoptic_tree(data_dir, image_wh=image_wh, seed=seed)
    tree_s = time.perf_counter() - t0
    stage_file = os.path.join(work, "stage_seed0.pth.tar")
    sets = realdata_sets(data_dir, out_dir, stage_file, extra)
    cfg = train_3d.load_cli_config(argparse.Namespace(cfg=yaml_path, set=sets[1::2]))
    t0 = time.perf_counter()
    pseudo = build_pseudo_labels(cfg, os.path.join(work, "pseudo"), seed=seed)
    pseudo_s = time.perf_counter() - t0
    save_reference_checkpoint(get_model(cfg, device="cpu", seed=seed), stage_file)

    train_ds = get_dataset(cfg, cfg.DATASET.TRAIN_DATASET, cfg.DATASET.TRAIN_SUBSET, True)
    frame_ms = []
    for i in range(3):  # one SSV frame from disk, on this thread: 3 x V images
        t0 = time.perf_counter()
        train_ds.get_ssv_frame(i, seed=0)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    common = ["--cfg", yaml_path, "--device", device] + sets
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trained = {}
    slicewarp.reset_launches()
    t0 = time.perf_counter()
    train_3d.main(common, report=trained)
    train_cli_s = time.perf_counter() - t0
    launched = dict(slicewarp.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if device == "cuda" else None
    meters, val = trained["epoch"], trained["validation"]
    # the loops' records hold every launch of the CLI's run
    assert launched == {k: meters["launches"][k] + val["launches"][k] for k in launched}, (
        launched, meters["launches"], val["launches"])
    debug = meters["debug_launches"]

    model_name, _ = get_model_name(cfg)
    run_dir = os.path.join(out_dir, cfg.DATASET.TRAIN_DATASET, model_name,
                           os.path.basename(yaml_path).split(".")[0])
    trained_model = get_model(cfg, device=device, seed=seed + 1)
    _, epoch, _ = checkpoint.load_checkpoint(run_dir, create_train_state(cfg, trained_model))
    assert epoch == 1, epoch
    pth = save_reference_checkpoint(
        trained_model, os.path.join(work, "epoch1.pth.tar"))
    del trained_model

    slicewarp.reset_launches()
    t0 = time.perf_counter()
    precision = evaluate_cli.main(common + ["--test-file", pth, "--vis-attn"])
    eval_s = time.perf_counter() - t0
    eval_launches = dict(slicewarp.LAUNCHES)
    with open(os.path.join(run_dir, "predictions_dump.pkl"), "rb") as f:
        dump = pickle.load(f)
    poses, scores = [], []
    for r in dump:
        pred = np.asarray(r["preds_3d"])
        pred = pred[pred[:, 0, 3] >= 0]
        poses.append(pred[:, :, :3])
        scores.append(pred[:, 0, 4])
    tracks = track_sequence(poses, scores, score_threshold=-np.inf)

    debug_dir = os.path.join(run_dir, "debug")
    return {
        "config": yaml_path,
        "changed": {**REALDATA_CHANGED, **(extra or {}), "DATA_DIR": data_dir,
                    "NETWORK.PRETRAINED_BACKBONE and INIT_ROOTNET":
                        "one reference-layout file of the seeded model (the released "
                        "stage files are not in the repository)"},
        "tree": {"sequences": len(sequences), "views": len(sequences) * cfg.DATASET.CAMERA_NUM,
                 "image_wh": list(image_wh), "seconds": tree_s},
        "pseudo_labels": {**pseudo, "seconds": pseudo_s},
        "ssv_frame_from_disk_ms": frame_ms, "train_frames": len(train_ds),
        "train_cli_seconds": train_cli_s, "epoch": meters, "dumps": meters["debug_dumps"],
        "debug_dump_seconds": meters["debug_seconds"],
        "launches": {"train": {k: n - debug[k] for k, n in meters["launches"].items()},
                     "debug": debug, "validate": val["launches"], "evaluate": eval_launches},
        "validation": val, "evaluate": {"precision": precision, "seconds": eval_s},
        "dump_frames": len(dump), "tracks": [t.tolist() for t in tracks],
        "debug_files": sorted(os.listdir(debug_dir)), "debug_dir": debug_dir,
        "peak_mem_gib": peak, "run_dir": run_dir, "cfg": cfg}
