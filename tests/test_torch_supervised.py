"""The port's supervised VoxelPose baseline (``MultiPersonPoseNet``), its
GT matching and its train step against the JAX package, on the CPU at the
small float32 size of tests/test_supervised.py (ResNet-18, 2 views at
128x64, a 16x16x8 root space, 16^3 cubes, K = 5): the same numpy-seeded
weights (JAX tree -> ``from_jax``) and scenes go through both.

Bars: the matching exactly, ties included; eval mode (running BatchNorm
statistics) rel 1e-4, train mode (batch statistics) rel 1e-3, each of the
loss terms and, for a tensor (predictions, candidate locations), of its
largest entry; flags equal. Gradients of ``loss_2d`` and ``loss_3d`` on
running statistics as tests/test_torch_train_grads.py holds them.
The JAX package samples through its exact gather path
(NETWORK.SAMPLING = 'gather'), as the port's samplers are exact everywhere.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import selfpose3d_tpu.models.norm as j_norm
from selfpose3d_tpu.data.synthetic import make_synthetic_branch as j_make_branch
from selfpose3d_tpu.models import MultiPersonPoseNet as JMultiPersonPoseNet
from selfpose3d_tpu.models.root_net import SupervisedProposal as JSupervisedProposal
from selfpose3d_tpu.ops.proposal import match_proposals_to_gt as j_match

from selfpose3d_tpu_torch.convert.from_jax import from_jax
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
from selfpose3d_tpu_torch.models import MultiPersonPoseNet, SupervisedProposal, get_model
from selfpose3d_tpu_torch.ops.proposal import match_proposals_to_gt
from selfpose3d_tpu_torch.train import (
    create_train_state,
    make_supervised_train_step,
    trainable_labels,
)

from tests.test_supervised import sup_cfg
from tests.test_torch_models import random_variables
from tests.test_torch_train import _net_rel_l2, _tensor_errors

B = 2
TERMS_TRAIN = ("loss_2d", "loss_3d", "loss_cord")


def _cfg(**network):
    return sup_cfg(NETWORK={"SAMPLING": "gather", **network})


def _branches(cfg, seed=3):
    kw = dict(batch_size=B, num_person=3, seed=seed, with_images=True)
    return j_make_branch(cfg, **kw)[0], make_synthetic_branch(cfg, device="cpu", **kw)[0]


def _close(got, want, rel, name):
    """Within ``rel`` of the reference's largest entry (a scalar: of itself)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (name, err, scale)


# ------------------------------------------------------------------ matching

@pytest.mark.parametrize("case", ["random", "ties", "no_valid_gt"])
def test_match_proposals_to_gt_equals_jax(case):
    rs = np.random.RandomState(0)
    loc = rs.uniform(-1000, 1000, (3, 6, 3)).astype(np.float32)
    gt = rs.uniform(-1000, 1000, (3, 4, 3)).astype(np.float32)
    num = np.array([4, 2, 3], np.int32)
    if case == "ties":
        # candidate 0 of each sample halfway between GT 1 and GT 2 (exact
        # equal distances): the first index wins; GT 3 of sample 1 lies at
        # candidate 1 but is padding (num_person 2)
        loc[:, 0] = 0.0
        gt[:, 1] = [100.0, 0.0, 0.0]
        gt[:, 2] = [-100.0, 0.0, 0.0]
        gt[1, 3] = loc[1, 1]
        loc[2, 2] = gt[2, 0] + [0.0, 500.0, 0.0]  # exactly at max_dist: matched
        loc[2, 3] = gt[2, 0] + [0.0, 500.5, 0.0]  # beyond it: -1
    elif case == "no_valid_gt":
        num[:] = [0, 1, 0]
    want = np.asarray(j_match(jnp.asarray(loc), jnp.asarray(gt), jnp.asarray(num)))
    got = match_proposals_to_gt(torch.from_numpy(loc), torch.from_numpy(gt), torch.from_numpy(num))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "ties":
        assert (got[:, 0] == 1.0).all() and got[1, 1] != 3.0
        assert got[2, 2] == 0.0 and got[2, 3] == -1.0
    elif case == "no_valid_gt":
        assert (got[[0, 2]] == -1.0).all()
    else:
        assert (got >= 0).any() and (got == -1.0).any()


@pytest.mark.parametrize("training", [False, True])
def test_supervised_proposal_equals_jax(training):
    rs = np.random.RandomState(1)
    cubes = rs.rand(2, 16, 16, 8).astype(np.float32)
    gt = rs.uniform(-3000, 3000, (2, 5, 3)).astype(np.float32)
    num = np.array([3, 5], np.int32)
    kw = dict(space_size=(8000.0, 8000.0, 2000.0), space_center=(0.0, -500.0, 800.0),
              cube_size=(16, 16, 8), max_people=5, threshold=0.9)
    # GT 0 of sample 0 next to the top proposal, so training matches something
    top = np.unravel_index(int(np.argmax(cubes[0])), cubes.shape[1:])
    gt[0, 0] = [top[0] / 15 * 8000 - 4000 + 50, top[1] / 15 * 8000 - 4500, top[2] / 7 * 2000 - 200]
    jp = JSupervisedProposal(**kw)
    want = np.asarray(jp.apply({}, jnp.asarray(cubes), jnp.asarray(gt), jnp.asarray(num),
                               training=training))
    got = SupervisedProposal(**kw)(torch.from_numpy(cubes), torch.from_numpy(gt),
                                   torch.from_numpy(num), training=training)
    assert got.shape == (2, 5, 5) and not list(SupervisedProposal(**kw).parameters())
    np.testing.assert_array_equal(got[..., 3].numpy(), want[..., 3])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)
    if training:
        assert got[0, 0, 3] == 0.0
    else:  # no GT: the threshold flag
        np.testing.assert_array_equal(got[..., 3].numpy(), (got[..., 4].numpy() > 0.9) - 1.0)


# ---------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def models():
    """The supervised model with every sub-network (TRAIN_BACKBONE true),
    seeded JAX variables carried to the port by ``from_jax`` with strict
    keys, one scene in both packages, and the JAX model's jitted apply in
    eval and in train mode."""
    cfg = _cfg()
    jm = JMultiPersonPoseNet(cfg=cfg)
    jb, tb = _branches(cfg)
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b, train=True), jb)
    var = random_variables(shapes, seed=5)
    # lift the root detection volume positive so top-k is not tie-bound
    var["params"]["root_net"]["v2v_net"]["output_layer"]["bias"] += 1.0
    port = get_model(cfg, device="cpu")
    assert isinstance(port, MultiPersonPoseNet)
    port.load_state_dict(from_jax(var))  # strict: the same keys
    j_apply = {
        False: jax.jit(lambda v, b: jm.apply(v, b, train=False)),
        True: jax.jit(lambda v, b: jm.apply(v, b, train=True, mutable=["batch_stats"])),
    }
    return cfg, jm, var, port, jb, tb, j_apply


def test_supervised_eval_mode_matches_jax(models):
    cfg, jm, var, port, jb, tb, j_apply = models
    pj, hj, gj, lj = j_apply[False](var, jb)
    with torch.no_grad():
        pt, ht, gt, lt = port(tb, train=False)
    assert not port.root_net.training and set(lt) == set(lj) == {"loss_2d", "loss_3d"}
    for k in lj:
        _close(float(lt[k]), float(lj[k]), 1e-4, k)
    np.testing.assert_array_equal(gt[..., 3].numpy(), np.asarray(gj[..., 3]))
    assert (gt[..., 3] >= 0).all()  # THRESHOLD -100: every candidate valid
    _close(ht.numpy(), hj, 1e-4, "heatmaps")
    _close(gt.numpy(), gj, 1e-4, "grid_centers")
    _close(pt.numpy(), pj, 1e-4, "pred")
    assert pt.shape == (B, 5, 15, 5) and not pt.requires_grad


def _matched(port, var, jb, tb):
    """The scene with GT roots (and their skeletons) moved next to some of
    ``port``'s train-mode proposals, so the matching leaves holes: sample 0
    matches candidates 2 and 4, sample 1 candidate 1 (the proposals do not
    depend on the GT, so they stay where they were)."""
    _, _, gc, _ = port(tb, train=True)
    port.load_state_dict(from_jax(var))  # train mode moved the statistics
    loc = gc[..., :3].detach().numpy()
    roots = np.asarray(jb.roots_3d).copy()
    joints = np.asarray(jb.joints_3d).copy()
    for b, p, k, off in ((0, 0, 2, (100.0, 0.0, 0.0)), (0, 1, 4, (0.0, 150.0, 0.0)),
                         (1, 1, 1, (0.0, 0.0, 120.0))):
        new = loc[b, k] + np.asarray(off, np.float32)
        joints[b, p] += new - roots[b, p]
        roots[b, p] = new
    return (jb.replace(roots_3d=jnp.asarray(roots), joints_3d=jnp.asarray(joints)),
            dataclasses.replace(tb, roots_3d=torch.from_numpy(roots),
                                joints_3d=torch.from_numpy(joints)))


@pytest.fixture(scope="module")
def matched(models):
    """The matched scene (``_matched``) and the JAX package's train-mode
    outputs on it."""
    cfg, jm, var, port, jb, tb, j_apply = models
    jb, tb = _matched(port, var, jb, tb)
    # the JAX package's poses once more with its BatchNorm variance in two
    # passes (in the test only): its one-pass E[x^2] - E[x]^2 over the few
    # valid cubes moves its own poses by about 1e-3 of their largest entry
    compute_stats = j_norm._fnz._compute_stats
    j_norm._fnz._compute_stats = lambda *a, **k: compute_stats(
        *a, **{**k, "use_fast_variance": False})
    try:
        (pred_two_pass, _, _, _), _ = jax.jit(
            lambda v, b: jm.apply(v, b, train=True, mutable=["batch_stats"]))(var, jb)
    finally:
        j_norm._fnz._compute_stats = compute_stats
    return jb, tb, j_apply[True](var, jb), pred_two_pass


def test_supervised_train_mode_matches_jax(models, matched):
    """Train mode (batch statistics), GT matching with holes: loss terms,
    flags, candidate locations and the moved running statistics against the
    JAX package; poses against it with its BatchNorm variance in two passes
    (``matched``)."""
    cfg, jm, var, port, _, _, _ = models
    jb, tb, ((_, _, gj, lj), mut), pj = matched
    try:
        pt, _, gt, lt = port(tb, train=True)
        assert port.root_net.training and port.pose_net.training and port.backbone.training
        flags = gt[..., 3]
        np.testing.assert_array_equal(flags.numpy(), np.asarray(gj[..., 3]))
        valid = (flags >= 0).numpy()
        # a hole: an invalid slot before a valid one
        assert any(not valid[b, i] and valid[b, i + 1:].any() for b in range(B) for i in range(5))
        assert set(lt) == set(lj) == set(TERMS_TRAIN)
        for k in lj:
            _close(float(lt[k].detach()), float(lj[k]), 1e-3, k)
        assert float(lt["loss_cord"].detach()) > 0
        _close(gt.numpy(), gj, 1e-3, "grid_centers")
        _close(pt.numpy(), pj, 1e-3, "pred")
        want_stats = from_jax({"params": var["params"], "batch_stats": mut["batch_stats"]})
        for k, v in port.state_dict().items():
            if "running_" in k:
                _close(v.numpy(), want_stats[k].numpy(), 1e-3, k)
    finally:
        port.load_state_dict(from_jax(var))
        port.eval()


def test_supervised_gradients_match_jax(models):
    """The gradient of ``loss_2d`` and of ``loss_3d`` on running statistics
    (JAX ``train=False``, where both terms are computed), every parameter,
    against ``jax.grad``. ``loss_3d`` reaches the backbone through RootNet,
    which reads all 15 heatmap channels undetached: the transpose of its
    sampler. Bars of tests/test_torch_train_grads.py: every tensor within
    5e-3 of its largest JAX gradient, 95 % of each net's within 1e-3, each
    net's whole gradient within 1e-3 in relative L2 norm."""
    cfg, jm, var, port, jb, tb, _ = models

    def terms(params):
        _, _, _, losses = jm.apply({"params": params, "batch_stats": var["batch_stats"]}, jb,
                                   train=False)
        return jnp.stack([losses["loss_2d"], losses["loss_3d"]])

    jac = jax.jit(jax.jacrev(terms))(var["params"])
    _, _, _, lt = port(tb, train=False)
    nets = {"loss_2d": ("backbone.",), "loss_3d": ("backbone.", "root_net.")}
    for i, term in enumerate(("loss_2d", "loss_3d")):
        want = from_jax({"params": jax.tree.map(lambda g, i=i: g[i], jac)})
        got = dict(zip([k for k, _ in port.named_parameters()],
                       torch.autograd.grad(lt[term], list(port.parameters()), retain_graph=True,
                                           allow_unused=True)))
        for k, g in got.items():
            if k.startswith("pose_net."):  # no term here reaches PoseNet
                assert g is None and float(want[k].abs().max()) == 0.0, k
            elif term == "loss_2d" and k.startswith("root_net."):
                assert g is None and float(want[k].abs().max()) == 0.0, k
        got = {k: g for k, g in got.items() if g is not None}
        for net in nets[term]:
            errs, zeros = _tensor_errors(got, {k: want[k] for k in got}, net)
            worst = max(errs.items(), key=lambda kv: kv[1])
            assert worst[1] <= 5e-3, (term, net, worst)
            assert np.mean([e <= 1e-3 for e in errs.values()]) >= 0.95, (term, net)
            assert _net_rel_l2(got, want, net) <= 1e-3, (term, net)
            for k, e in zeros.items():
                assert e <= 1e-5, (term, k, e)


@pytest.mark.parametrize("train_backbone", [False, True])
def test_supervised_train_step(models, matched, train_backbone):
    """One ``make_supervised_train_step`` step from the fixture's weights on
    the config's matched scene (``_matched``): its metrics are the JAX package's train-mode losses
    of the same config (rel 1e-3) and their sum; a frozen backbone runs on
    its running statistics, leaves the heatmaps without ``requires_grad``
    and does not move; RootNet and PoseNet move."""
    _, _, var, _, jb, tb, _ = models
    cfg = _cfg(TRAIN_BACKBONE=train_backbone)
    port = get_model(cfg, device="cpu")
    port.load_state_dict(from_jax(var))
    if train_backbone:
        _, tb, ((_, _, _, lj), _), _ = matched
    else:  # the backbone on its running statistics: other proposals
        jb, tb = _matched(port, var, jb, tb)
        jm = JMultiPersonPoseNet(cfg=cfg)
        (_, _, _, lj), _ = jax.jit(
            lambda v, b: jm.apply(v, b, train=True, mutable=["batch_stats"]))(var, jb)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    state = create_train_state(cfg, port)
    assert trainable_labels(cfg)["backbone"] == train_backbone
    assert port.backbone(tb.views[:, 0]).requires_grad == train_backbone
    metrics = make_supervised_train_step(port)(state, tb)
    assert port.backbone.training == train_backbone
    assert set(metrics) == set(TERMS_TRAIN) | {"loss"}
    for k in TERMS_TRAIN:
        _close(float(metrics[k]), float(lj[k]), 1e-3, k)
    _close(float(metrics["loss"]), sum(float(lj[k]) for k in TERMS_TRAIN), 1e-3, "loss")
    after = port.state_dict()
    for net, moves in (("backbone.", train_backbone), ("root_net.", True), ("pose_net.", True)):
        moved = any(not torch.equal(after[k], v) for k, v in start.items()
                    if k.startswith(net) and "running_" not in k and "num_batches" not in k)
        assert moved == moves, net
    assert state.step == 1


def test_use_gt_candidates_and_cord_loss(models):
    """USE_GT: no RootNet (no root_net parameters, as in the JAX variables),
    the candidates are the GT roots, ``loss_cord`` over every person."""
    _, _, var, _, jb, tb, _ = models
    cfg = _cfg(USE_GT=True)
    jm = JMultiPersonPoseNet(cfg=cfg)
    v = {"params": {k: x for k, x in var["params"].items() if k != "root_net"},
         "batch_stats": {k: x for k, x in var["batch_stats"].items() if k != "root_net"}}
    port = get_model(cfg, device="cpu")
    port.load_state_dict(from_jax(v))  # strict: no root_net keys either side
    assert not hasattr(port, "root_net")
    (pj, _, gj, lj), _ = jax.jit(
        lambda v, b: jm.apply(v, b, train=True, mutable=["batch_stats"]))(v, jb)
    pt, _, gt, lt = port(tb, train=True)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(gt[..., 3].numpy(), [[0, 1, 2, -1, -1]] * B)
    assert set(lt) == set(lj) == {"loss_2d", "loss_cord"}
    for k in lj:
        _close(float(lt[k].detach()), float(lj[k]), 1e-3, k)
    assert float(lt["loss_cord"].detach()) > 0
    _close(pt.detach().numpy(), pj, 1e-3, "pred")
