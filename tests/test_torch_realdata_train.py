"""One ``panoptic_ssv`` epoch of the port's train CLI on the CPU, through
``mini_panoptic.run_realdata`` (the work of ``chip_smoke.py``'s phase
``realdata``):
a mini Panoptic tree with 960x540 views (the sequence lists cut to 3
train and 1 validation sequences), pseudo labels from stages s1 ->
s8 with fake models (at this size some people leave some views),
``cli.train_3d`` on cam5_posenet.yaml at a small
float32 width with DEBUG.DEBUG and the 3D plots on, validation on
``panoptic``, the epoch's checkpoint as a reference ``.pth.tar`` through
``cli.evaluate --vis-attn``, and ``track_sequence`` over its dump.

Checks: every step trains (finite losses), every PRINT_FREQ-th step writes
all five debug dumps (the 2D PNGs and the two matplotlib plots), each a
non-blank image; the pseudo labels keep 80 % of the GT people or more;
the dump holds every validation frame.
"""

import logging
import os

import numpy as np
import pytest

from selfpose3d_tpu_torch import mini_panoptic
from selfpose3d_tpu_torch.cli import train_3d
from selfpose3d_tpu_torch.data import skeleton
from selfpose3d_tpu_torch.utils.zipreader import imread_any

FLAGSHIP_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "configs", "panoptic_ssl", "resnet50", "cam5_posenet.yaml")
SMALL = {"NETWORK.IMAGE_SIZE": [192, 128], "NETWORK.HEATMAP_SIZE": [48, 32],
         "POSE_RESNET.NUM_LAYERS": 18, "ATTN_NUM_LAYERS": 18, "DTYPE": "float32",
         "MULTI_PERSON.INITIAL_CUBE_SIZE": [16, 16, 8], "PICT_STRUCT.CUBE_SIZE": [8, 8, 8],
         "WORKERS": 2, "PRINT_FREQ": 2, "DEBUG.SAVE_3D_POSES": True,
         "DEBUG.SAVE_3D_ROOTS": True}


class _Writer:
    def add_scalar(self, *a):
        pass

    def close(self):
        pass


@pytest.fixture
def restore_logging():
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in root.handlers[len(handlers):]:
        root.removeHandler(h)
        h.close()
    root.setLevel(level)


def test_panoptic_ssv_epoch_writes_every_debug_dump(tmp_path, monkeypatch, restore_logging):
    # importing TensorBoard pulls in TensorFlow where that is installed
    monkeypatch.setattr(train_3d, "TBWriter", lambda log_dir: _Writer())
    monkeypatch.setattr(skeleton, "PANOPTIC_TRAIN_LIST", skeleton.PANOPTIC_TRAIN_LIST[:3])
    monkeypatch.setattr(skeleton, "PANOPTIC_VAL_LIST", skeleton.PANOPTIC_VAL_LIST[:1])
    rep = mini_panoptic.run_realdata(str(tmp_path / "realdata"), FLAGSHIP_YAML, "cpu", SMALL,
                                     image_wh=(960, 540))
    meters = rep["epoch"]
    assert rep["train_frames"] == 3 and meters["steps"] == 3
    assert all(np.isfinite(m.avg) for k, m in meters.items() if k.startswith("loss"))
    pseudo = rep["pseudo_labels"]
    assert sum(pseudo["people_per_record"]) >= 0.8 * sum(pseudo["gt_people_per_record"])
    stems = [f"train_0_{i}" for i in (0, 2)]
    kinds = ("gt.png", "hm_pred.png", "views_pred.png", "3d_poses.png", "3d_roots.png")
    assert rep["dumps"] == 2 and rep["debug_dump_seconds"] > 0
    # the loops record the samplers' launches, none on the CPU
    assert all(n == 0 for path in rep["launches"].values() for n in path.values())
    assert sorted(rep["debug_files"]) == sorted(f"{s}_{k}" for s in stems for k in kinds)
    for f in rep["debug_files"]:
        img = imread_any(os.path.join(rep["debug_dir"], f))
        assert img is not None and img.max() > img.min(), f
    assert rep["dump_frames"] == 1 and len(rep["tracks"]) == 1
    assert all(np.isfinite(a) for a in rep["validation"]["aps"])
    assert rep["evaluate"]["precision"] is not None
    assert os.path.exists(os.path.join(rep["run_dir"], "attn_vis.png"))
