"""The port's training engine on the CPU: the train and validation loops on
the synthetic-scene dataset (configs/synthetic/tiny_ssv.yaml, a few
frames), checkpoints and resume, the staged loading of reference files,
and the CLIs.

Against the JAX package: ``load_torch_stage`` on fake reference files
gives the parameters that the JAX package's ``load_torch_stage`` followed
by ``from_jax`` gives (equal); ``validate_3d`` with ``from_jax`` weights
gives the JAX package's predictions (flags equal, positions within 1e-3
of their largest entry) and metrics (recalls equal, MPJPE within 1 mm).
A resumed run equals the uninterrupted one bit for bit.
"""

import logging
import os
import types

import jax
import numpy as np
import pytest
import torch
import yaml

import selfpose3d_tpu.train.checkpoint as j_ckpt
import selfpose3d_tpu.train.loop as j_loop
from selfpose3d_tpu.convert.torch2jax import convert_pose_resnet, convert_v2v_net
from selfpose3d_tpu.config import load_config as j_load_config
from selfpose3d_tpu.data.synthetic import make_synthetic_branch as j_make_branch
from selfpose3d_tpu.data.synthetic_dataset import SyntheticSceneDataset as JDataset
from selfpose3d_tpu.models import get_model as j_get_model

from selfpose3d_tpu_torch.cli import evaluate as evaluate_cli
from selfpose3d_tpu_torch.cli import train_3d, validate_3d as validate_cli
from selfpose3d_tpu_torch.config import load_config
from selfpose3d_tpu_torch.convert.from_jax import from_jax
from selfpose3d_tpu_torch.data.synthetic_dataset import (
    SyntheticSceneDataset,
    render_stick_figures,
)
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.train import checkpoint as ckpt
from selfpose3d_tpu_torch.train import create_train_state
from selfpose3d_tpu_torch.train.convergence import RecordingWriter, head_tail_means
from selfpose3d_tpu_torch.train.loop import (
    dispatch_buckets,
    pick_k_cap,
    train_epoch_ssv,
    train_epoch_supervised,
    validate_3d,
)

from tests.test_torch_models import random_variables
from tests.torch_oracles import TorchPoseResNet, TorchV2V

TINY = "configs/synthetic/tiny_ssv.yaml"
NO_DEBUG = {"DEBUG": {"DEBUG": False}}
SSV_TERMS = ("loss_2d", "loss_root_syn", "loss_root_reg", "loss_pose3d_ssv",
             "loss_pose3d_l1_ssv", "loss")


def _tiny(**over):
    return load_config(TINY, overrides={**NO_DEBUG, **over})


def _dataset(cfg, image_set, frames):
    return SyntheticSceneDataset(cfg, image_set, image_set == "train", num_frames=frames)


# ------------------------------------------------------------- train loops

@pytest.mark.parametrize("dispatch, frames, steps", [("none", 5, 2), ("meta", 6, 3)])
def test_train_epoch_ssv_steps(dispatch, frames, steps, tmp_path, monkeypatch):
    over = {"TRAIN": {"BUCKET_DISPATCH": dispatch}, "MULTI_PERSON": {"CANDIDATE_BUCKETS": [2]}}
    cfg = _tiny(**over)
    model = get_model(cfg, device="cpu", seed=0)
    state = create_train_state(cfg, model, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    writer, meters = RecordingWriter(), {}
    monkeypatch.setenv("SP3D_PROFILE", str(tmp_path / "profile"))
    monkeypatch.setenv("SP3D_PROFILE_STEPS", "1")
    train_epoch_ssv(cfg, model, state, _dataset(cfg, "train", frames), epoch=0, writer=writer,
                    meters_out=meters)
    assert meters["steps"] == steps and state.step == steps  # batch 2, drop_last
    # the SP3D_PROFILE trace covers step 2 of epoch 0
    assert (tmp_path / "profile" / "trace.json").exists() == (steps > 2)
    assert set(writer.series) == {f"train/{k}" for k in SSV_TERMS}
    for k, v in writer.series.items():
        assert len(v) == steps and np.isfinite(v).all(), k
    assert writer.series["train/loss_pose3d_ssv"][0] > 0
    changed = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert any(k.startswith("backbone.") for k in changed)
    assert any(k.startswith("pose_net.") for k in changed)
    assert meters["data_time"].count == steps and meters["batch_time"].count == steps


def test_bucket_dispatch_reads_the_host_batch():
    cfg = _tiny(TRAIN={"BUCKET_DISPATCH": "meta"}, MULTI_PERSON={"CANDIDATE_BUCKETS": [2, 3]})
    buckets = dispatch_buckets(cfg, posenet_stage=True)
    assert buckets == (2, 3, 5) and dispatch_buckets(cfg, posenet_stage=False) == ()
    assert dispatch_buckets(_tiny(), True) == ()
    caps = [pick_k_cap(buckets, torch.tensor(n, dtype=torch.int32), 5)
            for n in ([1, 1], [1, 2], [3, 1], [5, 4])]
    assert caps == [2, 3, None, None]


def test_train_epoch_supervised_steps():
    cfg = _tiny(MODEL="multi_person_posenet",
                NETWORK={"ROOTNET_ROOTHM": False, "TRAIN_BACKBONE": True})
    model = get_model(cfg, device="cpu", seed=0)
    state = create_train_state(cfg, model, 2)
    writer, meters = RecordingWriter(), {}
    train_epoch_supervised(cfg, model, state, _dataset(cfg, "train", 4), epoch=1,
                           writer=writer, meters_out=meters)
    assert meters["steps"] == 2 and state.step == 2
    assert {"train/loss_2d", "train/loss_3d", "train/loss_cord", "train/loss"} <= set(writer.series)
    assert all(np.isfinite(v).all() for v in writer.series.values())
    metrics = {}  # the supervised model validates through its forward
    precision = validate_3d(cfg, model, _dataset(cfg, "validation", 3), metrics_out=metrics)
    assert precision == float(np.mean(metrics["aps"])) and "recall500_root" in metrics


def test_debug_dumps_raise(tmp_path):
    """DEBUG.DEBUG with an output dir once raised (the dumps were not
    ported); now every PRINT_FREQ-th step writes them."""
    cfg = load_config(TINY)
    assert cfg.DEBUG.DEBUG and not cfg.DEBUG.SAVE_3D_POSES
    model = get_model(cfg, device="cpu")
    train_epoch_ssv(cfg, model, create_train_state(cfg, model), _dataset(cfg, "train", 2),
                    epoch=0, output_dir=str(tmp_path))
    dumps = sorted(os.listdir(tmp_path / "debug"))
    assert dumps == [f"train_0_0_{k}.jpg" for k in ("gt", "hm_pred", "views_pred")]


# ------------------------------------------------------ checkpoint, resume

def _train_state_dict(state):
    return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(), "step": state.step}


def _assert_bit_equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_equal(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def test_resume_equals_uninterrupted_run(tmp_path):
    cfg = _tiny(TRAIN={"LR_STEP": [1]})  # the LR decays at the resumed epoch
    ds = _dataset(cfg, "train", 2)  # one step an epoch
    model = get_model(cfg, device="cpu", seed=0)
    state = create_train_state(cfg, model, 1)
    train_epoch_ssv(cfg, model, state, ds, epoch=0)
    ckpt.save_checkpoint(str(tmp_path), state, 1, 0.25, is_best=True)
    saved = {k: v.clone() for k, v in _train_state_dict(state)["model"].items()}
    train_epoch_ssv(cfg, model, state, ds, epoch=1)

    fresh = get_model(cfg, device="cpu", seed=1)
    resumed, epoch, precision = ckpt.load_checkpoint(str(tmp_path),
                                                     create_train_state(cfg, fresh, 1))
    assert (epoch, precision, resumed.step) == (1, 0.25, 1)
    _assert_bit_equal(resumed.model.state_dict(), saved, "loaded")
    train_epoch_ssv(cfg, fresh, resumed, ds, epoch=1)
    _assert_bit_equal(_train_state_dict(resumed), _train_state_dict(state))
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(cfg.TRAIN.LR * 0.1)
    assert ckpt.latest_checkpoint_epoch(str(tmp_path)) == 1
    assert ckpt.best_checkpoint_epoch(str(tmp_path)) == 1
    assert ckpt.load_checkpoint(str(tmp_path / "none"), resumed)[1:] == (0, 0.0)


# ------------------------------------------------ staged reference loading

@pytest.fixture(scope="module")
def stage_models(tmp_path_factory):
    """The port's model of one config (ResNet-50 backbone and attention
    net, as the reference files are), the JAX package's variables of the
    same weights (the JAX package's own converter of reference-named state
    dicts), and fake reference checkpoints of the released layouts."""
    cfg = load_config(overrides={
        "MODEL": "multi_person_posenet_ssv", "DTYPE": "float32", "WITH_ATTN": True,
        "ATTN_NUM_LAYERS": 50, "POSE_RESNET": {"NUM_LAYERS": 50},
        "NETWORK": {"IMAGE_SIZE": [128, 64], "HEATMAP_SIZE": [32, 16], "ROOTNET_ROOTHM": True},
        "MULTI_PERSON": {"INITIAL_CUBE_SIZE": [16, 16, 8], "MAX_PEOPLE_NUM": 4},
        "PICT_STRUCT": {"CUBE_SIZE": [16, 16, 16]}, "DATASET": {"CAMERA_NUM": 2}})
    model = get_model(cfg, device="cpu", seed=4)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    sd = {k: v.numpy() for k, v in start.items()}
    parts = {"backbone": convert_pose_resnet(sd, prefix="backbone."),
             "attn": {k: {"backbone": v} for k, v in
                      convert_pose_resnet(sd, prefix="attn.backbone.").items()},
             "root_net": {k: {"v2v_net": v} for k, v in
                          convert_v2v_net(sd, prefix="root_net.v2v_net.").items()},
             "pose_net": {k: {"v2v_net": v} for k, v in
                          convert_v2v_net(sd, prefix="pose_net.v2v_net.").items()}}
    variables = {c: {net: parts[net][c] for net in parts} for c in ("params", "batch_stats")}
    roundtrip = from_jax(variables)
    assert set(roundtrip) == set(start)
    assert all(torch.equal(roundtrip[k], v) for k, v in start.items()
               if not k.endswith("num_batches_tracked"))
    files_dir = tmp_path_factory.mktemp("reference_files")
    files = {kind: _reference_file(files_dir / f"{kind}.pth.tar", kind)
             for kind in ("all", "coco", "same_count", "zero_keys", "partial")}
    files["missing"] = str(files_dir / "missing.pth")
    return cfg, variables, model, start, files


def _reference_file(path, kind):
    """A fake reference checkpoint of a released layout, all of its float
    entries drawn from a seeded normal (running statistics included)."""
    torch.manual_seed(0)
    if kind == "all":  # module.-wrapped full model under "state_dict"
        sd = {}
        for prefix, net in (("backbone.", TorchPoseResNet(15)), ("attn.backbone.", TorchPoseResNet(15)),
                            ("root_net.v2v_net.", TorchV2V(1, 1)),
                            ("pose_net.v2v_net.", TorchV2V(15, 15))):
            sd.update({f"module.{prefix}{k}": v for k, v in net.state_dict().items()})
        obj = {"state_dict": sd, "epoch": 3}
    elif kind in ("coco", "same_count"):  # a bare PoseResNet file
        obj = TorchPoseResNet(17 if kind == "coco" else 15).state_dict()
    elif kind == "zero_keys":
        obj = {"unrelated.weight": torch.zeros(3)}
    elif kind == "partial":
        obj = {f"backbone.{k}": v for k, v in TorchPoseResNet(15).state_dict().items()
               if k != "layer3.2.conv1.weight"}
    for v in (obj.get("state_dict", obj)).values():
        if v.dtype.is_floating_point:
            v.normal_()
    torch.save(obj, str(path))
    return str(path)


@pytest.mark.parametrize("kind, component", [
    ("all", "all"), ("all", "backbone"), ("all", "root_net"), ("all", "pose_net"),
    ("coco", "backbone"), ("same_count", "backbone"), ("coco", "pretrained")])
def test_load_torch_stage_equals_jax(stage_models, kind, component):
    cfg, variables, model, start, files = stage_models
    mapping = tuple(cfg.COCO_TO_PANOPTIC_MAPPING)
    want = from_jax(j_ckpt.load_torch_stage(variables, files[kind], component,
                                            coco_mapping=mapping))
    model.load_state_dict(start)
    assert ckpt.load_torch_stage(model, files[kind], component, coco_mapping=mapping) is model
    got = model.state_dict()
    assert set(got) == set(want)
    changed = set()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
            if not torch.equal(v, start[k]):
                changed.add(k.split(".")[0])
    expect = {"all": {"backbone", "attn", "root_net", "pose_net"}, "pretrained": {"backbone", "attn"}}
    assert changed == expect.get(component, {component})
    if kind == "same_count":
        assert not got["backbone.final_layer.weight"].any()


@pytest.mark.parametrize("kind, component, error", [
    ("zero_keys", "backbone", ckpt.CheckpointKeyError),
    ("zero_keys", "root_net", ckpt.CheckpointKeyError),
    ("zero_keys", "all", ckpt.CheckpointKeyError),
    ("partial", "backbone", ckpt.CheckpointKeyError),
    ("coco", "all", ckpt.CheckpointKeyError),
    ("all", "pretrained", ckpt.CheckpointKeyError),
    ("missing", "backbone", FileNotFoundError)])
def test_load_torch_stage_hard_errors_as_jax(stage_models, kind, component, error):
    cfg, variables, model, start, files = stage_models
    with pytest.raises(getattr(j_ckpt, error.__name__, error)):
        j_ckpt.load_torch_stage(variables, files[kind], component)
    model.load_state_dict(start)
    with pytest.raises(error):
        ckpt.load_torch_stage(model, files[kind], component)


# ------------------------------------------------------------- validation

def test_validate_3d_equals_jax():
    """The render mode's scenes, the port's rasteriser drawing both packages'
    images; weight seed 29, whose random proposals reach one of the twelve
    roots within 500 mm (no random weights bring a pose that near), so the
    root metrics are exercised."""
    over = {**NO_DEBUG, "NETWORK": {"SAMPLING": "gather"}, "TEST": {"BATCH_SIZE": 4},
            "DATASET": {"SYNTH_IMAGE_MODE": "render"}}
    cfg, jcfg = load_config(TINY, overrides=over), j_load_config(TINY, overrides=over)
    jm = j_get_model(jcfg)
    jb = j_make_branch(jcfg, batch_size=1, num_person=2, seed=1)[0]
    shapes = jax.eval_shape(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "synth": jax.random.PRNGKey(1)}, b, b, b,
        train_posenet_stage=True, use_l1_stage=True, method="ssv_losses"), jb)
    variables = random_variables(shapes, seed=29)
    variables["params"]["root_net"]["v2v_net"]["output_layer"]["bias"] += 1.0

    seen = {}

    def capture(name, evaluate):
        def wrapped(preds, roots=None, output_dir=""):
            seen[name] = (np.stack(preds), np.stack(roots))
            return evaluate(preds, roots, output_dir)
        return wrapped

    jds = JDataset(jcfg, "validation", False, num_frames=6)  # 4 + a padded batch of 2
    jds._render_image = lambda joints, vis, wh, rs: render_stick_figures(
        joints, vis, wh, rs, cfg.NETWORK.NUM_JOINTS)
    jds.evaluate = capture("jax", jds.evaluate)
    want = {}
    j_loop.validate_3d(jcfg, jm, types.SimpleNamespace(**variables), jds, metrics_out=want)

    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_jax(variables))
    model.train()
    modes = [m.training for m in model.modules()]
    ds = _dataset(cfg, "validation", 6)
    ds.evaluate = capture("port", ds.evaluate)
    got = {}
    precision = validate_3d(cfg, model, ds, metrics_out=got)
    assert [m.training for m in model.modules()] == modes  # modes restored

    (pp, rp), (pj, rj) = seen["port"], seen["jax"]
    assert pp.shape == pj.shape == (6, 5, 15, 5)
    np.testing.assert_array_equal(rp[..., 3], rj[..., 3])
    np.testing.assert_allclose(rp, rj, rtol=0, atol=1e-3 * np.abs(rj).max())
    np.testing.assert_allclose(pp, pj, rtol=0, atol=1e-3 * np.abs(pj).max())
    assert precision == pytest.approx(float(np.mean(want["aps"])))
    for k in ("recall500", "recall500_root", "recalls", "recalls_root"):
        assert got[k] == want[k], k
    for k in ("mpjpe", "mpjpe_root"):
        assert got[k] == want[k] or abs(got[k] - want[k]) <= 1.0, (k, got[k], want[k])
    assert got["recall500_root"] > 0 and np.isfinite(got["mpjpe_root"])


# -------------------------------------------------------------------- CLIs

def test_train_and_validate_cli(tmp_path, monkeypatch):
    # importing TensorBoard pulls in TensorFlow where that is installed
    # (some 16 s); the recorder takes the writer's place
    monkeypatch.setattr(train_3d, "TBWriter", lambda log_dir: RecordingWriter())

    def two_frames(cfg):  # each split cut to 2 frames
        splits = datasets(cfg)
        for ds in splits:
            ds.num_frames = 2
        return splits

    datasets = train_3d.datasets
    monkeypatch.setattr(train_3d, "datasets", two_frames)
    monkeypatch.setattr(evaluate_cli, "eval_dataset", lambda cfg: two_frames(cfg)[1])
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        _train_and_validate(tmp_path)
    finally:  # create_logger adds a file and a console handler a call
        for h in root.handlers[len(handlers):]:
            root.removeHandler(h)
            h.close()
        root.setLevel(level)


def _train_and_validate(tmp_path):
    with open(TINY) as f:
        raw = yaml.safe_load(f)
    raw.update(OUTPUT_DIR=str(tmp_path / "out"), LOG_DIR=str(tmp_path / "log"), WORKERS=1)
    raw["TRAIN"].update(END_EPOCH=1, BATCH_SIZE=2)
    path = tmp_path / "tiny_cli.yaml"
    path.write_text(yaml.safe_dump(raw))
    common = ["--cfg", str(path), "--device", "cpu"]
    best = train_3d.main(common)  # DEBUG.DEBUG is on in the YAML: writes the dumps
    out = tmp_path / "out" / "synthetic" / "multi_person_posenet_ssv_18" / "tiny_cli"
    assert ckpt.latest_checkpoint_epoch(str(out)) == 1
    train_3d.main(common + ["--set", "TRAIN.RESUME=true", "--set", "TRAIN.END_EPOCH=2"])
    assert ckpt.latest_checkpoint_epoch(str(out)) == 2
    payload = torch.load(out / "checkpoints" / "epoch_2.pt", weights_only=True)
    assert payload["meta"]["step"] == 2 and payload["meta"]["precision"] >= best
    assert validate_cli.main(common + ["--epoch", "2"]) is not None
    with pytest.raises(RuntimeError, match="CUDA"):
        train_3d.main(["--cfg", str(path), "--device", "cuda"])


def test_head_tail_means():
    assert head_tail_means([4.0, 3.0, 2.0, 1.0], k=10) == (3.5, 1.5)
    assert head_tail_means(list(range(30)), k=10) == (4.5, 24.5)
