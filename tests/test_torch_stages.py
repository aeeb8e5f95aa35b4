"""The SSV model's stage flags, its debug views and every config under
``configs/`` in the port against the JAX package, on the CPU at a small
float32 size (ResNet-18 backbone and attention net, 2 views at 128x64, a
16x16x8 root space, 16^3 cubes, K = 4): the same numpy-seeded weights (JAX
tree -> ``from_jax``), scenes and injected synthetic-root draws go through
both.

The flags are those of the paper's three SSL training stages:
TRAIN_ONLY_2D (stage 1), TRAIN_ONLY_ROOTNET (stage 2), and
USE_GT and SINGLE_AUG_TRAINING_POSENET (variants of stage 3). Bars: loss
terms rel 1e-4 / abs 1e-7 (tests/test_ssv_loss_parity.py), with running
BatchNorm statistics; inference as tests/test_torch_inference.py holds it
(proposals to 1e-3 mm with equal flags, poses < 1 mm per joint); maps rel
1e-4 of their largest entry. The JAX package samples through its exact
gather path (NETWORK.SAMPLING = 'gather').
"""

import dataclasses
import glob
from pathlib import Path

import numpy as np
import pytest
import torch
import jax

from selfpose3d_tpu.config import load_config as j_load_config
from selfpose3d_tpu.data.synthetic import make_synthetic_branch as j_make_branch
from selfpose3d_tpu.models import get_model as j_get_model
from selfpose3d_tpu.train.step import make_ssv_debug_forward as j_make_ssv_debug_forward

from selfpose3d_tpu_torch.config import load_config
from selfpose3d_tpu_torch.convert.from_jax import from_jax
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.ops import slicewarp, unproject
from selfpose3d_tpu_torch.train import (
    create_train_state,
    make_inference_step,
    make_ssv_debug_forward,
    make_ssv_train_step,
    make_supervised_train_step,
)

from tests.test_multi_person import small_cfg
from tests.test_torch_models import random_variables
from tests.test_torch_train import _inject

REPO = Path(__file__).resolve().parents[1]
B = 2
ROTS = (15.0, -12.0, 0.0)
FLAGS = ("TRAIN_ONLY_2D", "TRAIN_ONLY_ROOTNET", "USE_GT", "SINGLE_AUG_TRAINING_POSENET")
# the loss terms of ssv_losses under each flag (train stage, L1 stage on)
FLAG_TERMS = {
    "TRAIN_ONLY_2D": {"loss_2d"},
    "TRAIN_ONLY_ROOTNET": {"loss_2d", "loss_root_syn", "loss_root_reg"},
    "USE_GT": {"loss_2d", "loss_pose3d_ssv", "loss_attn_ssv", "loss_pose3d_l1_ssv"},
    "SINGLE_AUG_TRAINING_POSENET": {"loss_2d", "loss_root_syn", "loss_root_reg",
                                    "loss_pose3d_ssv"},
}
# what a reduced width changes in a config under configs/
REDUCED = {"DTYPE": "float32", "POSE_RESNET": {"NUM_LAYERS": 18}, "ATTN_NUM_LAYERS": 18,
           "NETWORK": {"IMAGE_SIZE": [128, 64], "HEATMAP_SIZE": [32, 16]},
           "MULTI_PERSON": {"INITIAL_CUBE_SIZE": [16, 16, 8], "MAX_PEOPLE_NUM": 4},
           "PICT_STRUCT": {"CUBE_SIZE": [16, 16, 16]}, "DATASET": {"CAMERA_NUM": 2}}
CONFIGS = sorted(str(Path(p).relative_to(REPO))
                 for p in glob.glob(str(REPO / "configs" / "**" / "*.yaml"), recursive=True))


def _cfg(**network):
    return small_cfg(
        WITH_ATTN=True, USE_L1=True, L1_ATTN=True,
        NETWORK={"SAMPLING": "gather", "IMAGE_SIZE": [128, 64], "HEATMAP_SIZE": [32, 16],
                 **network},
        MULTI_PERSON={"MAX_PEOPLE_NUM": 4, "THRESHOLD": -100.0},
        DATASET={"CAMERA_NUM": 2})


def _branches(cfg, seed=3):
    jb, tb = [], []
    for rot in ROTS:
        kw = dict(batch_size=B, num_person=3, seed=seed, with_images=True, rot_deg=rot)
        jb.append(j_make_branch(cfg, **kw)[0])
        tb.append(make_synthetic_branch(cfg, device="cpu", **kw)[0])
    return jb, tb


def _variables(jm, jb, seed):
    """Numpy-seeded JAX variables of every sub-network ``ssv_losses`` calls
    under the config's flags."""
    shapes = jax.eval_shape(
        lambda b1, b2, b3: jm.init(
            {"params": jax.random.PRNGKey(0), "synth": jax.random.PRNGKey(1)}, b1, b2, b3,
            train_posenet_stage=True, use_l1_stage=True, method="ssv_losses"),
        *jb)
    var = random_variables(shapes, seed=seed)
    if "root_net" in var["params"]:
        # lift the root detection volume positive so top-k is not tie-bound
        var["params"]["root_net"]["v2v_net"]["output_layer"]["bias"] += 1.0
    return var


def _port(cfg, var):
    port = get_model(cfg, device="cpu")
    assert set(port.state_dict()) == set(from_jax(var))
    port.load_state_dict(from_jax(var))
    return port


def _max_rel(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (name, err)


def _same_candidates(gt, gj):
    """Equal flags in the same slots, locations to 1e-3 mm, scores rel 1e-4."""
    gt, gj = gt.detach().numpy(), np.asarray(gj)
    np.testing.assert_array_equal(gt[..., 3], gj[..., 3])
    np.testing.assert_allclose(gt[..., :3], gj[..., :3], rtol=0, atol=1e-3)
    np.testing.assert_allclose(gt[..., 4], gj[..., 4], rtol=1e-4, atol=1e-6)


def _same_poses(pt, pj):
    """Poses < 1 mm per joint; flag and score columns equal to round-off."""
    pt, pj = pt.detach().numpy(), np.asarray(pj)
    assert pt.shape == pj.shape
    err = np.linalg.norm(pt[..., :3] - pj[..., :3], axis=-1)
    assert err.max() < 1.0, err.max()
    np.testing.assert_array_equal(pt[..., 3], pj[..., 3])
    np.testing.assert_allclose(pt[..., 4], pj[..., 4], rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def scene():
    """Three augmentation branches of one scene in both packages (the stage
    flags do not change the data)."""
    return _branches(_cfg())


@pytest.mark.parametrize("flag", FLAGS)
def test_stage_flag_matches_jax(scene, flag):
    """Under one stage flag: the sub-networks built (the state dict's keys
    are ``from_jax``'s for the JAX variables), ``ssv_losses``' terms and
    outputs with running BatchNorm statistics, and ``make_inference_step``
    (``do_inference``), against the JAX package."""
    cfg = _cfg(**{flag: True})
    jm = j_get_model(cfg)
    jb, tb = scene
    var = _variables(jm, jb, seed=17)
    port = _port(cfg, var)
    nets = {n for n, _ in port.named_children()}
    assert ("root_net" in nets) == (flag not in ("TRAIN_ONLY_2D", "USE_GT"))
    assert ("pose_net" in nets) == (flag not in ("TRAIN_ONLY_2D", "TRAIN_ONLY_ROOTNET"))

    V, (Hh, Wh) = tb[0].num_views, tb[0].target_2d.shape[2:4]
    kw = dict(train_posenet_stage=True, use_l1_stage=True, train=True, bn_eval=True,
              synth_inject=_inject(cfg, B, V, (Hh, Wh)))
    pj, hj, gj, lj = jax.jit(lambda v, *b: jm.apply(v, *b, method="ssv_losses", **kw))(var, *jb)
    pt, ht, gt, lt = port.ssv_losses(*tb, **kw)
    assert set(lt) == set(lj) == FLAG_TERMS[flag], (sorted(lt), sorted(lj))
    for k in lj:
        np.testing.assert_allclose(float(lt[k].detach()), float(lj[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert float(lt["loss_2d"].detach()) > 0
    if "loss_pose3d_ssv" in lt:
        assert float(lt["loss_pose3d_ssv"].detach()) > 0
    _max_rel(ht.detach().numpy(), hj, 1e-4, "heatmaps3")
    if flag == "TRAIN_ONLY_2D":
        assert pt is None and pj is None and gt is None and gj is None
    else:
        _same_candidates(gt, gj)
    if flag == "TRAIN_ONLY_ROOTNET":
        assert pt is None and pj is None
    elif flag != "TRAIN_ONLY_2D":
        _same_poses(pt, pj)
    if flag == "USE_GT":  # branch 3's GT roots are the candidates
        np.testing.assert_allclose(gt[:, :3, :3].numpy(), tb[2].roots_3d[:, :3].numpy())
        np.testing.assert_array_equal(gt[..., 3].numpy(), [[0, 1, 2, -1]] * B)

    pj, hj, gj = jax.jit(lambda v, b: jm.apply(v, b, method="do_inference"))(var, jb[2])
    pt, ht, gt = make_inference_step(port)(tb[2])
    assert not pt.requires_grad and not port.training
    _max_rel(ht.numpy(), hj, 1e-4, "heatmaps")
    _same_candidates(gt, gj)
    _same_poses(pt, pj)
    if flag in ("TRAIN_ONLY_2D", "TRAIN_ONLY_ROOTNET"):  # no PoseNet
        assert not pt[..., :3].any()


@pytest.fixture(scope="module")
def ssv_models(scene):
    """The SSV model with every sub-network and no stage flag."""
    cfg = _cfg()
    jm = j_get_model(cfg)
    jb, tb = scene
    var = _variables(jm, jb, seed=23)
    return cfg, jm, var, _port(cfg, var), jb, tb


@pytest.mark.parametrize("view", ["visualize_attn", "ssv_debug_forward"])
def test_debug_views_match_jax(ssv_models, view):
    """``do_inference(visualize_attn=True)``: the attention maps of the
    attention net in eval mode (rel 1e-4 of their largest entry) beside the
    usual outputs. ``make_ssv_debug_forward``: ``ssv_losses(train=False)``'s
    (pred2, heatmaps3, grid_centers) against the JAX package's debug
    forward."""
    cfg, jm, var, port, jb, tb = ssv_models
    if view == "visualize_attn":
        pj, hj, gj, aj = jax.jit(lambda v, b: jm.apply(
            v, b, visualize_attn=True, method="do_inference"))(var, jb[2])
        pt, ht, gt, at = port.do_inference(tb[2], visualize_attn=True)
        assert not port.attn.training
        assert at.shape == ht.shape and 0.0 <= float(at.min()) and float(at.max()) <= 1.0
        _max_rel(at.numpy(), aj, 1e-4, "attns")
    else:
        fwd = j_make_ssv_debug_forward(jm, train_posenet_stage=True, use_l1_stage=True)
        pj, hj, gj = fwd(var["params"], var["batch_stats"], *jb, jax.random.PRNGKey(2))
        pt, ht, gt = make_ssv_debug_forward(port, train_posenet_stage=True,
                                            use_l1_stage=True)(*tb)
        assert not pt.requires_grad and tb[0].target_3d is not None
    _max_rel(ht.numpy(), hj, 1e-4, "heatmaps")
    _same_candidates(gt, gj)
    _same_poses(pt, pj)


def _fields(cfg):
    """A config as nested dicts, the keys that steer only the JAX package
    (``NETWORK.SAMPLING``, ``MESH_DATA_AXIS``) left out."""
    d = dataclasses.asdict(cfg)
    d["NETWORK"].pop("SAMPLING")
    d.pop("MESH_DATA_AXIS", None)
    return d


@pytest.mark.parametrize("path", CONFIGS)
def test_every_config_loads_and_builds(path):
    """Each YAML under configs/: the port's ``load_config`` equals the JAX
    package's field by field, and ``get_model(cfg, device="cpu")`` builds it
    at a reduced width (REDUCED) with the state-dict keys that ``from_jax``
    gives for the JAX model's variables of the same config."""
    cfg, jcfg = load_config(str(REPO / path)), j_load_config(str(REPO / path))
    assert _fields(cfg) == _fields(jcfg)
    cfg = load_config(str(REPO / path), overrides=REDUCED)
    jcfg = j_load_config(str(REPO / path), overrides={
        **REDUCED, "NETWORK": {**REDUCED["NETWORK"], "SAMPLING": "gather"}})
    jm = j_get_model(jcfg)
    jb = j_make_branch(jcfg, batch_size=1, num_person=2, seed=1)[0]
    rngs = {"params": jax.random.PRNGKey(0), "synth": jax.random.PRNGKey(1)}
    if jcfg.MODEL == "multi_person_posenet":
        shapes = jax.eval_shape(lambda b: jm.init(rngs, b, train=True), jb)
    else:
        shapes = jax.eval_shape(lambda b: jm.init(
            rngs, b, b, b, train_posenet_stage=True, use_l1_stage=True, method="ssv_losses"), jb)
    want = from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    port = get_model(cfg, device="cpu")
    assert set(port.state_dict()) == set(want)
    for k, v in port.state_dict().items():
        assert tuple(v.shape) == tuple(want[k].shape), k


# (config, flags) -> sampler calls of one train step: sample_view,
# sample_views_mean, sample_view_adjoint
STEP_SAMPLERS = {
    "supervised": (2, 1, 0),                 # RootNet on all J; PoseNet fused
    "supervised_train_backbone": (4, 0, 4),  # RootNet and PoseNet, both back
    "stage1_train_only_2d": (0, 0, 0),
    "stage2_train_only_rootnet": (4, 0, 0),  # main + synthetic, root channel detached
}


@pytest.mark.parametrize("case", list(STEP_SAMPLERS))
def test_train_step_sampler_calls_follow_requires_grad(case, monkeypatch):
    """The samplers a train step calls (2 views) and the sub-networks it
    moves, under each stage: a gradient reaches the heatmaps only where the
    backbone trains, so only then are RootNet and PoseNet sampled per view
    with the adjoint behind them. Counted on the plain versions (CPU
    tensors launch no kernel); ``chip_smoke.py`` asserts the same counts
    of kernel launches at full width."""
    calls = dict.fromkeys(("sample_view", "sample_views_mean", "sample_view_adjoint"), 0)
    for mod, name in ((unproject, "sample_view"), (unproject, "sample_views_mean"),
                      (slicewarp, "sample_view_adjoint")):
        def counted(*a, _f=getattr(mod, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    over = {"NETWORK": {"IMAGE_SIZE": [128, 64], "HEATMAP_SIZE": [32, 16]},
            "MULTI_PERSON": {"MAX_PEOPLE_NUM": 4, "THRESHOLD": -100.0}}
    if case.startswith("supervised"):
        cfg = load_config(overrides={
            "MODEL": "multi_person_posenet", "DTYPE": "float32",
            "POSE_RESNET": {"NUM_LAYERS": 18},
            "NETWORK": {**over["NETWORK"], "TRAIN_BACKBONE": case.endswith("backbone")},
            "MULTI_PERSON": {**over["MULTI_PERSON"], "INITIAL_CUBE_SIZE": [16, 16, 8]},
            "PICT_STRUCT": {"CUBE_SIZE": [16, 16, 16]}, "DATASET": {"CAMERA_NUM": 2}})
    else:
        path = ("configs/panoptic_ssl/resnet50/backbone_pseudo_hrnet_soft_9videos.yaml"
                if case.startswith("stage1") else "configs/panoptic_ssl/resnet50/cam5_rootnet.yaml")
        cfg = load_config(str(REPO / path), overrides={**REDUCED, **over})
    port = get_model(cfg, device="cpu")
    state = create_train_state(cfg, port)
    start = {k: v.clone() for k, v in port.named_parameters()}
    kw = dict(batch_size=1, num_person=2, seed=1, with_images=True, device="cpu")
    if cfg.MODEL == "multi_person_posenet":
        metrics = make_supervised_train_step(port)(state, make_synthetic_branch(cfg, **kw)[0])
    else:
        brs = [make_synthetic_branch(cfg, rot_deg=r, **kw)[0] for r in ROTS]
        metrics = make_ssv_train_step(port, True, True)(
            state, *brs, generator=torch.Generator().manual_seed(0))
    assert (calls["sample_view"], calls["sample_views_mean"],
            calls["sample_view_adjoint"]) == STEP_SAMPLERS[case], calls
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    moved = {n for n, _ in port.named_children()
             if any(not torch.equal(p.detach(), start[f"{n}.{k}"])
                    for k, p in getattr(port, n).named_parameters())}
    want = {"supervised": {"root_net"},
            "supervised_train_backbone": {"backbone", "root_net"},
            "stage1_train_only_2d": {"backbone"},
            "stage2_train_only_rootnet": {"root_net"}}[case]
    if float(metrics.get("loss_cord", 0.0)) > 0:
        want.add("pose_net")  # a proposal matched a GT root: PoseNet has a gradient
    assert moved == want, moved
