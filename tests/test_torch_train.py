"""The port's SSV train step against the JAX package, on the CPU at a small
float32 size: the same numpy-seeded weights (JAX tree -> ``from_jax``),
scenes and injected random draws go through both.

Here: the modules one by one and the loss composition on the
``input_heatmaps`` path. Bars: loss terms rel 1e-4 / abs 1e-7 (the bar of
tests/test_ssv_loss_parity.py); the optimizers 1e-6. The parameter
gradients and the train step end to end, images through every sub-network,
are held in tests/test_torch_train_step.py.
The JAX package samples through its exact gather path here
(NETWORK.SAMPLING = 'gather'), as the port's samplers are exact everywhere.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.optimize import linear_sum_assignment

from selfpose3d_tpu.data.synthetic import make_synthetic_branch as j_make_branch
from selfpose3d_tpu.models import get_model as j_get_model
from selfpose3d_tpu.models.norm import FastBatchNorm
from selfpose3d_tpu.ops.gaussian import render_gaussian_cube_3d as j_cube_3d
from selfpose3d_tpu.ops.matching import (
    hungarian as j_hungarian,
    masked_assignment_cost as j_masked_cost,
)
from selfpose3d_tpu.train.schedule import multistep_lr as j_multistep_lr
from selfpose3d_tpu.train.train_state import create_train_state as j_create_train_state

from selfpose3d_tpu_torch.convert.from_jax import from_jax
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.models.norm import BatchNorm3d
from selfpose3d_tpu_torch.ops.gaussian import render_gaussian_cube_3d
from selfpose3d_tpu_torch.ops.matching import hungarian, masked_assignment_cost
from selfpose3d_tpu_torch.train import create_train_state, multistep_lr

from tests.test_multi_person import small_cfg
from tests.test_torch_models import random_variables

TERMS = ("loss_2d", "loss_root_syn", "loss_root_reg", "loss_pose3d_ssv", "loss_attn_ssv",
         "loss_pose3d_l1_ssv")
ROTS = (15.0, -12.0, 0.0)


def _cfg(**over):
    net = {"SAMPLING": "gather", **over.pop("NETWORK", {})}
    return small_cfg(
        WITH_ATTN=True, USE_L1=True, L1_ATTN=True, NETWORK=net,
        MULTI_PERSON={"MAX_PEOPLE_NUM": 4, "THRESHOLD": -100.0}, **over)


def _branches(cfg, with_images, B, seed, hflips=(False, False, False)):
    jb, tb = [], []
    for rot, hf in zip(ROTS, hflips):
        kw = dict(batch_size=B, num_person=3, seed=seed, with_images=with_images,
                  rot_deg=rot, hflip=hf)
        jb.append(j_make_branch(cfg, **kw)[0])
        tb.append(make_synthetic_branch(cfg, device="cpu", **kw)[0])
    return jb, tb


def _inject(cfg, B, V, hw, seed=11):
    """Synthetic-root draws shared by both packages: one count per branch,
    roots in the capture space, heatmap noise."""
    P = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
    rs = np.random.RandomState(seed)
    ss, sc = cfg.MULTI_PERSON.SPACE_SIZE, cfg.MULTI_PERSON.SPACE_CENTER
    lo = np.array([sc[d] - ss[d] / 4 for d in range(3)])
    hi = np.array([sc[d] + ss[d] / 4 for d in range(3)])
    return {"counts": rs.randint(1, P, size=(3,)),
            "roots": rs.uniform(lo, hi, size=(3 * B, P, 3)).astype(np.float32),
            "noise": (0.02 * rs.randn(3 * B, V, 1, hw[0], hw[1])).astype(np.float32)}


def _variables(jm, jb, seed):
    """Numpy-seeded JAX variables of every sub-network ``ssv_losses`` uses
    (without images: no backbone and no attention net, the maps are given)."""
    attn = None
    if jb[0].views is None:
        attn = jnp.ones((2 * jb[0].batch_size,) + jb[0].input_heatmaps.shape[1:])
    shapes = jax.eval_shape(
        lambda b1, b2, b3: jm.init(
            {"params": jax.random.PRNGKey(0), "synth": jax.random.PRNGKey(1)}, b1, b2, b3,
            train_posenet_stage=True, use_l1_stage=True, attn_inject=attn,
            method="ssv_losses"),
        *jb)
    var = random_variables(shapes, seed=seed)
    # lift the root detection volume positive so top-k is not tie-bound
    var["params"]["root_net"]["v2v_net"]["output_layer"]["bias"] += 1.0
    return var


def _assert_losses(lt, lj):
    assert set(lj) == set(lt) and set(TERMS) <= set(lt), (sorted(lj), sorted(lt))
    for k in lj:
        got = float(lt[k].detach())
        np.testing.assert_allclose(got, float(lj[k]), rtol=1e-4, atol=1e-7, err_msg=k)
        assert np.isfinite(got)


# ------------------------------------ shared by the image-path test files

NETS = ("backbone.", "attn.backbone.", "root_net.", "pose_net.")
def _setup(weights_seed):
    cfg = _cfg(TRAIN={"OPTIMIZER": "sgd", "LR": 1e-3, "MOMENTUM": 0.9})
    jm = j_get_model(cfg)
    jb, tb = _branches(cfg, True, 1, seed=3)
    var = _variables(jm, jb, seed=weights_seed)
    inject = _inject(cfg, 1, 3, (32, 64), seed=13)
    return cfg, jm, var, jb, tb, inject


def _jax_grad(jm, var, jb, weights, **kw):
    """(losses, gradient tree of sum_k weights[k] * mean(term_k), new batch_stats)."""

    def loss_fn(params):
        (_, _, _, losses), mut = jm.apply(
            {"params": params, "batch_stats": var["batch_stats"]}, *jb,
            method="ssv_losses", mutable=["batch_stats"], **kw)
        return sum(weights[k] * jnp.mean(v) for k, v in losses.items()), (losses, mut)

    (_, (losses, mut)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(var["params"])
    return losses, grads, mut


def _port_grad(port, tb, weights, **kw):
    _, _, _, losses = port.ssv_losses(*tb, **kw)
    sum(weights[k] * v.mean() for k, v in losses.items()).backward()
    grads = {k: p.grad.clone() for k, p in port.named_parameters()}
    port.zero_grad(set_to_none=True)
    return {k: v.detach() for k, v in losses.items()}, grads


def _tensor_errors(got, want, net, zero_share=1e-5):
    """Per tensor of ``net``: largest absolute difference over the largest
    reference gradient of that tensor. Tensors whose reference gradient is
    below ``zero_share`` of the net's largest (zero in exact arithmetic)
    are returned apart, as a share of the net's largest."""
    names = [k for k in want if k.startswith(net)]
    top = max(float(want[k].abs().max()) for k in names)
    assert top > 0, net
    errs, zeros = {}, {}
    for k in names:
        diff = float((got[k] - want[k]).abs().max())
        scale = float(want[k].abs().max())
        if scale < zero_share * top:
            zeros[k] = diff / top
        else:
            errs[k] = diff / scale
    return errs, zeros


def _net_rel_l2(got, want, net):
    names = [k for k in want if k.startswith(net)]
    num = sum(float(((got[k] - want[k]).double() ** 2).sum()) for k in names)
    den = sum(float((want[k].double() ** 2).sum()) for k in names)
    return (num / den) ** 0.5


# --------------------------------------------------------------- modules

@pytest.mark.parametrize("masked", [False, True])
def test_train_mode_batchnorm_matches_flax(masked):
    """Output, running mean and the *biased* running variance, with the
    statistics over every example or over a masked subset."""
    rs = np.random.RandomState(0)
    x = (rs.randn(5, 4, 3, 6, 7) * 2 + 1).astype(np.float32)  # NDHWC
    x[3:] += 10.0  # what the mask excludes shifts the statistics
    var = {"params": {"scale": (0.5 + rs.rand(7)).astype(np.float32),
                      "bias": rs.randn(7).astype(np.float32)},
           "batch_stats": {"mean": rs.randn(7).astype(np.float32),
                           "var": (0.5 + rs.rand(7)).astype(np.float32)}}
    mask = np.array([True, True, True, False, False])
    jbn = FastBatchNorm(use_running_average=False, momentum=0.9, dtype=jnp.float32)
    want, mut = jbn.apply(
        var, jnp.asarray(x), mask=jnp.asarray(mask).reshape(5, 1, 1, 1, 1) if masked else None,
        mutable=["batch_stats"])

    bn = BatchNorm3d(7)
    bn.load_state_dict({"weight": torch.from_numpy(var["params"]["scale"]),
                        "bias": torch.from_numpy(var["params"]["bias"]),
                        "running_mean": torch.from_numpy(var["batch_stats"]["mean"].copy()),
                        "running_var": torch.from_numpy(var["batch_stats"]["var"].copy()),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train()
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    got = bn(xt, torch.from_numpy(mask) if masked else None).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    sel = x[mask] if masked else x
    biased = 0.9 * var["batch_stats"]["var"] + 0.1 * sel.reshape(-1, 7).var(0)
    np.testing.assert_allclose(bn.running_var.numpy(), biased, rtol=1e-4)
    # eval mode afterwards applies the moved statistics and moves nothing
    bn.eval()
    before = bn.running_mean.clone()
    bn(xt)
    assert torch.equal(bn.running_mean, before)


def test_batchnorm_gradient_flows_through_batch_statistics():
    rs = np.random.RandomState(1)
    x = rs.randn(4, 3, 2, 2, 5).astype(np.float32)
    w = rs.randn(4, 3, 2, 2, 5).astype(np.float32)
    var = {"params": {"scale": np.ones(5, np.float32), "bias": np.zeros(5, np.float32)},
           "batch_stats": {"mean": np.zeros(5, np.float32), "var": np.ones(5, np.float32)}}
    mask = np.array([True, False, True, True])
    jbn = FastBatchNorm(use_running_average=False, momentum=0.9, dtype=jnp.float32)
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m).reshape(4, 1, 1, 1, 1)
        want = jax.grad(lambda a: jnp.sum(
            jbn.apply(var, a, mask=jm, mutable=["batch_stats"])[0] * w))(jnp.asarray(x))
        bn = BatchNorm3d(5).train()
        xt = torch.from_numpy(x).requires_grad_()
        y = bn(xt.permute(0, 4, 1, 2, 3), None if m is None else torch.from_numpy(m))
        (y.permute(0, 2, 3, 4, 1) * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kind", ["random", "tied", "integer"])
def test_hungarian_matches_jax_and_scipy(kind):
    rs = np.random.RandomState(3)
    for K in (1, 2, 4, 10):
        for _ in range(6):
            c = rs.rand(K, K).astype(np.float32)
            if kind == "tied":
                c[rs.rand(K, K) < 0.5] = 0.25
            elif kind == "integer":
                c = rs.randint(0, 3, (K, K)).astype(np.float32)
            r2c = hungarian(torch.from_numpy(c)).numpy()
            assert sorted(r2c.tolist()) == list(range(K))
            np.testing.assert_array_equal(r2c, np.asarray(j_hungarian(jnp.asarray(c))))
            rows, cols = linear_sum_assignment(c)
            np.testing.assert_allclose(c[np.arange(K), r2c].sum(), c[rows, cols].sum(), atol=1e-5)


def test_masked_assignment_cost_matches_jax_and_is_differentiable():
    rs = np.random.RandomState(4)
    M = 5
    cost = rs.rand(7, M, M).astype(np.float32)
    rv = rs.rand(7, M) < 0.6
    cv = rs.rand(7, M) < 0.6
    rv[0], cv[1] = False, False  # no valid row / no valid column: zero
    want = np.stack([np.asarray(j_masked_cost(jnp.asarray(c), jnp.asarray(r), jnp.asarray(v)))
                     for c, r, v in zip(cost, rv, cv)])
    ct = torch.from_numpy(cost).requires_grad_()
    got = masked_assignment_cost(ct, torch.from_numpy(rv), torch.from_numpy(cv))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    assert got[0] == 0 and got[1] == 0
    got.sum().backward()
    g = ct.grad.numpy()  # one for every picked real pair, zero elsewhere
    assert set(np.unique(g)) <= {0.0, 1.0}
    np.testing.assert_allclose((g * cost).sum((1, 2)), want, atol=1e-6)
    assert (g.sum((1, 2)) == np.minimum(rv.sum(1), cv.sum(1))).all()


def test_render_gaussian_cube_3d_matches_jax():
    rs = np.random.RandomState(5)
    roots = rs.uniform(-1500, 1500, (2, 4, 3)).astype(np.float32)
    mask = np.array([[1, 1, 0, 0], [1, 1, 1, 0]], np.float32)
    axes = [np.linspace(-2000, 2000, n).astype(np.float32) for n in (12, 10, 6)]
    want = np.asarray(j_cube_3d(jnp.asarray(roots), *map(jnp.asarray, axes), sigma=200.0,
                                mask=jnp.asarray(mask)))
    got = render_gaussian_cube_3d(torch.from_numpy(roots), *map(torch.from_numpy, axes),
                                  sigma=200.0, mask=torch.from_numpy(mask))
    assert got.shape == (2, 12, 10, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert (got == 0).float().mean() > 0.5 and got.max() > 0.3  # the 3-sigma window


def test_clip01_has_the_gradient_of_jnp_clip_at_the_bounds():
    from selfpose3d_tpu_torch.ops.gaussian import clip01

    x = np.array([-0.5, 0.0, 0.25, 1.0, 1.5], np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = clip01(xt)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.clip(x, 0.0, 1.0))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


def test_multistep_lr_matches_optax_schedule():
    want = j_multistep_lr(1e-3, (2, 3), 0.1, steps_per_epoch=4)
    got = multistep_lr(1e-3, (2, 3), 0.1, steps_per_epoch=4)
    for step in range(16):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    assert got(7) == 1e-3 and got(8) < 1.1e-4 and got(12) < 1.1e-5


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_optimizer_matches_optax_on_a_synthetic_gradient_tree(opt):
    """Three updates from identical parameters and gradients, across an LR
    boundary: torch.optim against the JAX package's optax transform."""
    rs = np.random.RandomState(6)
    cfg = _cfg(TRAIN={"OPTIMIZER": opt, "LR": 0.01, "LR_STEP": [2], "LR_FACTOR": 0.5,
                      "MOMENTUM": 0.9})
    params = {"pose_net": {"a": rs.randn(4, 3).astype(np.float32)},
              "root_net": {"b": rs.randn(5).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rs.randn(*p.shape).astype(np.float32), params)
             for _ in range(3)]
    jstate = j_create_train_state(cfg, {"params": params}, steps_per_epoch=1)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.pose_net = torch.nn.ParameterDict({"a": torch.nn.Parameter(
                torch.from_numpy(params["pose_net"]["a"].copy()))})
            self.root_net = torch.nn.ParameterDict({"b": torch.nn.Parameter(
                torch.from_numpy(params["root_net"]["b"].copy()))})

    net = Net()
    state = create_train_state(cfg, net, steps_per_epoch=1)
    for g in grads:
        jstate = jstate.apply_gradients(g)
        net.pose_net["a"].grad = torch.from_numpy(g["pose_net"]["a"].copy())
        net.root_net["b"].grad = torch.from_numpy(g["root_net"]["b"].copy())
        state.apply_gradients()
        np.testing.assert_allclose(net.pose_net["a"].detach().numpy(),
                                   np.asarray(jstate.params["pose_net"]["a"]), atol=1e-6)
        np.testing.assert_allclose(net.root_net["b"].detach().numpy(),
                                   np.asarray(jstate.params["root_net"]["b"]), atol=1e-6)
    assert state.step == 3 and net.pose_net["a"].grad is None
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.005)


# ------------------------------------------------- the loss composition

@pytest.fixture(scope="module")
def heatmap_models():
    """input_heatmaps path (no backbone): RootNet + PoseNet weights shared."""
    cfg = _cfg(BACKBONE_MODEL="")
    jm = j_get_model(cfg)
    jb, _ = _branches(cfg, False, 1, seed=7)
    var = _variables(jm, jb, seed=21)
    port = get_model(cfg, device="cpu")
    missing, unexpected = port.load_state_dict(from_jax(var), strict=False)
    assert not unexpected and all(k.startswith("attn.") for k in missing), (missing, unexpected)
    return cfg, jm, var, port


@pytest.mark.parametrize("hflips, k_cap", [
    ((False, False, False), None),
    ((True, False, False), None),   # a flipped branch through RootNet and PoseNet
    ((False, False, False), 2),     # the PoseNet candidate cap
])
def test_ssv_losses_match_jax(heatmap_models, hflips, k_cap):
    cfg, jm, var, port = heatmap_models
    B = 2
    jb, tb = _branches(cfg, False, B, seed=7, hflips=hflips)
    V, (Hh, Wh) = tb[0].num_views, tb[0].input_heatmaps.shape[2:4]
    inject = _inject(cfg, B, V, (Hh, Wh))
    attns = np.random.RandomState(31).uniform(
        0.05, 0.95, (2 * B, V, Hh, Wh, cfg.NETWORK.NUM_JOINTS)).astype(np.float32)
    kw = dict(train_posenet_stage=True, use_l1_stage=True, train=True, bn_eval=True,
              synth_inject=inject, k_cap=k_cap)
    pj, _, gcj, lj = jm.apply(var, *jb, attn_inject=jnp.asarray(attns), method="ssv_losses", **kw)
    pt, hm3, gct, lt = port.ssv_losses(*tb, attn_inject=torch.from_numpy(attns), **kw)
    assert not port.pose_net.training and not port.root_net.training  # bn_eval
    np.testing.assert_array_equal(gct[..., 3].numpy(), np.asarray(gcj[..., 3]))
    np.testing.assert_allclose(gct.numpy(), np.asarray(gcj), atol=1e-3)
    _assert_losses(lt, lj)
    assert float(lt["loss_pose3d_ssv"].detach()) > 0 and float(lt["loss_pose3d_l1_ssv"].detach()) > 0
    assert pt.shape == (B, 4, 15, 5) and not pt.requires_grad
    err = np.linalg.norm(pt.numpy()[..., :3] - np.asarray(pj)[..., :3], axis=-1)
    assert err.max() < 1.0, err.max()
    if k_cap:
        assert (pt[:, k_cap:] == 0).all()
    assert hm3 is tb[2].input_heatmaps or torch.equal(hm3, tb[2].input_heatmaps)


def test_rootnet_stage_only_and_unflipped_differs(heatmap_models):
    """train_posenet_stage=False: no prediction, the pose term is a constant
    zero and the RootNet terms are those of the full stage; and the flip
    really changes the sampled cubes."""
    cfg, _, _, port = heatmap_models
    _, tb = _branches(cfg, False, 1, seed=7)
    inject = _inject(cfg, 1, 3, tb[0].input_heatmaps.shape[2:4])
    attns = torch.ones((2,) + tuple(tb[0].input_heatmaps.shape[1:]))
    kw = dict(bn_eval=True, synth_inject=inject, attn_inject=attns)
    pred, _, _, lr = port.ssv_losses(*tb, train_posenet_stage=False, **kw)
    _, _, _, lf = port.ssv_losses(*tb, train_posenet_stage=True, **kw)
    assert pred is None and float(lr["loss_pose3d_ssv"].detach()) == 0.0
    assert set(lr) == {"loss_2d", "loss_root_syn", "loss_root_reg", "loss_pose3d_ssv"}
    for k in ("loss_2d", "loss_root_syn", "loss_root_reg"):
        assert float(lr[k].detach()) == float(lf[k].detach()) >= 0
    hm = tb[0].input_heatmaps[..., 2:3]
    plain = port.root_net.unproject(hm, tb[0].cam, tb[0].trans, tb[0].orig_wh)
    flipped = port.root_net.unproject(hm, tb[0].cam, tb[0].trans, tb[0].orig_wh,
                                      hflip=torch.tensor([True]))
    assert float((plain - flipped).abs().max()) > 0.1


def test_train_synth_matches_jax_with_injected_draws(heatmap_models):
    cfg, jm, var, port = heatmap_models
    B = 3
    jb, tb = _branches(cfg, False, 1, seed=7, hflips=(False, True, False))
    from selfpose3d_tpu_torch.models.multi_person import cat_branches

    t_all = cat_branches(*tb)
    j_all = jax.tree.map(lambda *xs: jnp.concatenate(xs, 0), *jb)
    inject = _inject(cfg, 1, 3, (32, 64), seed=12)

    def synth(mdl, br):
        return mdl.root_net.train_synth(br.cam, br.trans, br.orig_wh, (64, 32), hflip=br.hflip,
                                        train=True, groups=3, inject=inject)

    (syn_j, tgt_j), mut = jm.apply(var, j_all, method=synth, mutable=["batch_stats", "intermediates"])
    port.root_net.train()
    syn_t, tgt_t = port.root_net.train_synth(t_all.cam, t_all.trans, t_all.orig_wh, (64, 32),
                                             hflip=t_all.hflip, groups=3, inject=inject)
    port.load_state_dict(from_jax(var), strict=False)  # undo the moved statistics
    assert syn_t.shape == tgt_t.shape == (B, 16, 16, 8)
    np.testing.assert_allclose(tgt_t.numpy(), np.asarray(tgt_j), atol=1e-6)
    np.testing.assert_allclose(syn_t.detach().numpy(), np.asarray(syn_j), rtol=1e-3, atol=1e-3)


def test_train_synth_draws_from_the_generator(heatmap_models):
    cfg, _, _, port = heatmap_models
    _, tb = _branches(cfg, False, 1, seed=7)
    b = tb[0]
    port.root_net.eval()

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return port.root_net.train_synth(b.cam, b.trans, b.orig_wh, (64, 32), generator=g)

    (s0, t0), (s0b, t0b), (s1, t1) = run(0), run(0), run(1)
    assert torch.equal(t0, t0b) and torch.equal(s0, s0b) and not torch.equal(t0, t1)
    # targets peak at a root inside the syn_range-shrunk space
    assert 0.3 < float(t0.max()) <= 1.0 and float(t0.min()) == 0.0
    with pytest.raises(ValueError, match="split evenly"):
        port.root_net.train_synth(b.cam, b.trans, b.orig_wh, (64, 32), groups=2)


@pytest.mark.parametrize("training", [False, True])
def test_posenet_picks_its_sampler_by_the_gradient_alone(heatmap_models, monkeypatch, training):
    """One ``sample_view`` per view where a gradient must reach the
    heatmaps, one ``sample_views_mean`` otherwise, whatever the module's
    mode; and both ways give the same poses."""
    from selfpose3d_tpu_torch.ops import unproject

    cfg, _, _, port = heatmap_models
    _, tb = _branches(cfg, False, 1, seed=7)
    b = tb[0]
    V = b.num_views
    calls = {"sample_view": 0, "sample_views_mean": 0}
    for name in calls:
        def counted(*a, _f=getattr(unproject, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(unproject, name, counted)
    port.root_net.eval()
    with torch.no_grad():
        _, gc = port.root_net(b.input_heatmaps[..., 2:3], b.cam, b.trans, b.orig_wh)
    before = {k: v.clone() for k, v in port.pose_net.state_dict().items()}
    port.pose_net.train(training)

    def run(hm):
        for k in calls:
            calls[k] = 0
        pred, _ = port.pose_net(hm, b.cam, b.trans, b.orig_wh, gc)
        return pred, dict(calls)

    hm = b.input_heatmaps
    plain, n = run(hm)
    assert n == {"sample_view": 0, "sample_views_mean": 1}
    hm_tracked = hm.clone().requires_grad_()
    tracked, n = run(hm_tracked)
    assert n == {"sample_view": V, "sample_views_mean": 0}
    (grad,) = torch.autograd.grad(tracked.sum(), hm_tracked)
    assert float(grad.abs().max()) > 0
    with torch.no_grad():
        _, n = run(hm.clone().requires_grad_())
    assert n == {"sample_view": 0, "sample_views_mean": 1}
    np.testing.assert_allclose(tracked.detach().numpy(), plain.detach().numpy(), atol=1e-2)
    port.pose_net.load_state_dict(before)  # train mode moved the statistics
    port.pose_net.eval()
