"""The port's real-data entry points on the CPU: ``cli.evaluate`` against
the JAX package's ``main`` on the fixture of ``tests/test_cli_evaluate.py``
(a mini Panoptic validation pickle, JPEG views, a fabricated reference
``.pth.tar``), its ``--dry-assets`` and ``--vis-attn``, and
``cli.visualize`` against the JAX package's on the dump ``evaluate``
writes.

Bars: the AP, recall and root tables equal, MPJPE within 1 mm (random
weights; float32 sums in two orders); the dry run's exit codes; a
non-blank attention grid; the visualizer's frames equal pixel for pixel.
"""

import logging
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import selfpose3d_tpu.data.panoptic as j_panoptic
from selfpose3d_tpu.cli import evaluate as j_evaluate
from selfpose3d_tpu.cli import train_3d as j_train_3d
from selfpose3d_tpu.cli import visualize as j_visualize
from tests.test_cli_evaluate import mini_panoptic  # noqa: F401  (the fixture)

import selfpose3d_tpu_torch.data.panoptic as panoptic
from selfpose3d_tpu_torch.cli import evaluate, validate_3d, visualize
from selfpose3d_tpu_torch.config import load_config
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.train.checkpoint import save_reference_checkpoint
from selfpose3d_tpu_torch.utils.zipreader import imread_any


@pytest.fixture
def restore_logging():
    """create_logger adds a file and a console handler a call."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in root.handlers[len(handlers):]:
        root.removeHandler(h)
        h.close()
    root.setLevel(level)


def _capture_evaluate(monkeypatch, cls, into):
    real = cls.evaluate

    def evaluate_(self, *a, **k):
        into.append(real(self, *a, **k))
        return into[-1]

    monkeypatch.setattr(cls, "evaluate", evaluate_)


def _resnet18_eval(mini, tmp_path):
    """The fixture's YAML with a ResNet-18 backbone (the JAX package's CPU
    compile of ResNet-50 alone takes about a minute) and a reference
    ``.pth.tar`` of a seeded model of that config."""
    tmp, cfg_path, _, out_dir = mini
    path = tmp_path / "mini_eval18.yaml"
    path.write_text(cfg_path.read_text().replace("NUM_LAYERS: 50", "NUM_LAYERS: 18"))
    model = get_model(load_config(str(path)), device="cpu", seed=5)
    pth = save_reference_checkpoint(model, str(tmp_path / "model_best18.pth.tar"))
    run = out_dir / "panoptic" / "multi_person_posenet_ssv_18" / "mini_eval18"
    return path, pth, run


def _shapes_only_init(cfg, model):
    """The JAX CLI's ``init_variables`` as zeros of its shapes (every leaf is
    then overwritten by the strict ``--test-file`` load): its eager flax
    init takes some 50 s on this CPU."""
    import jax

    from selfpose3d_tpu.data.synthetic import make_synthetic_branch

    branch, _ = make_synthetic_branch(cfg, batch_size=1, with_images=True)
    rngs = {"params": jax.random.PRNGKey(0), "synth": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda b: model.init(
        rngs, b, b, b, train_posenet_stage=True, use_l1_stage=bool(cfg.USE_L1), train=True,
        method="ssv_losses"), branch)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_evaluate_equals_jax(mini_panoptic, tmp_path, monkeypatch,  # noqa: F811
                             restore_logging):
    cfg_path, ckpt_path, run = _resnet18_eval(mini_panoptic, tmp_path)
    monkeypatch.setattr(j_train_3d, "init_variables", _shapes_only_init)
    want, got = [], []
    _capture_evaluate(monkeypatch, j_panoptic.PanopticDataset, want)
    _capture_evaluate(monkeypatch, panoptic.PanopticDataset, got)
    monkeypatch.setattr(sys, "argv", ["sp3d-evaluate", "--cfg", str(cfg_path), "--test-file",
                                      str(ckpt_path), "--platform", "cpu"])
    j_precision = j_evaluate.main()
    dump = run / "predictions_dump.pkl"
    with open(dump, "rb") as f:
        j_dump = pickle.load(f)
    precision = validate_3d.main(["--cfg", str(cfg_path), "--test-file", str(ckpt_path),
                                  "--device", "cpu"])
    assert len(want) == len(got) == 1
    w, g = want[0], got[0]
    assert set(w) == set(g)
    for k in w:
        if k.startswith("mpjpe"):
            assert w[k] == g[k] or abs(w[k] - g[k]) <= 1.0, (k, w[k], g[k])
        else:
            assert w[k] == g[k], (k, w[k], g[k])
    assert precision == j_precision
    with open(dump, "rb") as f:
        t_dump = pickle.load(f)
    assert len(t_dump) == len(j_dump) == 2
    for a, b in zip(j_dump, t_dump):
        assert a["preds_3d"].shape == b["preds_3d"].shape
        assert [m["image"] for m in a["views_meta"]] == [m["image"] for m in b["views_meta"]]
        np.testing.assert_allclose(a["preds_3d"], b["preds_3d"], atol=1.0)

    # the visualizer on this dump: the same frames, pixel for pixel
    frames = {}
    tmp = tmp_path
    for name, mod in (("jax", j_visualize), ("torch", visualize)):
        # random weights score every pose under the default 0.2
        argv = ["--dump", str(dump), "--out-dir", str(tmp / f"vis_{name}"),
                "--score-threshold", "-1"]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["sp3d-visualize"] + argv)
            mod.main()
        else:
            mod.main(argv)
        frames[name] = sorted(os.listdir(tmp / f"vis_{name}"))
    assert frames["torch"] == frames["jax"] and frames["torch"]
    for f in frames["torch"]:
        np.testing.assert_array_equal(imread_any(str(tmp / "vis_torch" / f)),
                                      imread_any(str(tmp / "vis_jax" / f)))


def test_dry_assets_and_vis_attn(mini_panoptic, tmp_path, restore_logging):  # noqa: F811
    tmp, cfg_path, ckpt_path, out_dir = mini_panoptic
    common = ["--cfg", str(cfg_path), "--device", "cpu"]
    for extra, code in ((["--test-file", str(ckpt_path)], 0),
                        ([], 0),
                        (["--test-file", str(tmp_path / "missing.pth.tar")], 1),
                        (["--set", f"DATA_DIR={tmp_path}", "--test-file", str(ckpt_path)], 1)):
        with pytest.raises(SystemExit) as e:
            evaluate.main(common + ["--dry-assets"] + extra)
        assert e.value.code == code, extra
    # --vis-attn needs the attention net: a small model with one, saved in
    # the reference layout
    small = ["--set", "WITH_ATTN=true", "--set", "POSE_RESNET.NUM_LAYERS=18",
             "--set", "ATTN_NUM_LAYERS=18", "--set", f"OUTPUT_DIR={tmp_path}"]
    cfg = load_config(str(cfg_path), overrides={"WITH_ATTN": True, "ATTN_NUM_LAYERS": 18,
                                                "POSE_RESNET": {"NUM_LAYERS": 18}})
    pth = save_reference_checkpoint(get_model(cfg, device="cpu", seed=3),
                                    str(tmp_path / "attn.pth.tar"))
    assert "module.attn.backbone.conv1.weight" in torch.load(pth, weights_only=True)["state_dict"]
    precision = evaluate.main(common + small + ["--test-file", pth, "--vis-attn"])
    assert precision is not None
    run = tmp_path / "panoptic" / "multi_person_posenet_ssv_18" / "mini_eval"
    grid = imread_any(str(run / "attn_vis.png"))
    assert grid is not None and grid.shape == (4 * 16, 16 * 32, 3) and grid.max() > grid.min()
    assert (run / "predictions_dump.pkl").exists()
