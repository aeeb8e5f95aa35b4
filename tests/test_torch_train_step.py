"""One SSV train step of the port in train mode (batch-statistics
BatchNorm), images through every sub-network, against the JAX package, on
the CPU at a small float32 size: the same numpy-seeded weights (JAX tree ->
``from_jax``), scenes and injected random draws go through both.

Bars: loss terms rel 1e-4 / abs 1e-7 (the bar of
tests/test_ssv_loss_parity.py); running statistics rel 1e-4; updated
parameters after one SGD step 1e-5.

Gradients are held tightly to ``jax.grad`` in
tests/test_torch_train_grads.py, on running statistics. Here, with batch
statistics, two float32 gradients agree only loosely: the weight gradient
of a convolution that feeds a train-mode BatchNorm is what is left after
two projections cancel most of the incoming gradient, over batches of a
few examples. The JAX package adds to that with its one-pass variance
(flax ``use_fast_variance``, E[x^2] - E[x]^2): switched to the two-pass
form, in the test only, its gradient comes several times closer to the
port's in the backbone and in PoseNet
(``test_train_mode_gradients_agree_with_jax``).

The JAX package samples through its exact gather path here
(NETWORK.SAMPLING = 'gather'), as the port's samplers are exact everywhere.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import selfpose3d_tpu.models.norm as j_norm
from selfpose3d_tpu.train.train_state import create_train_state as j_create_train_state

from selfpose3d_tpu_torch.convert.from_jax import from_jax
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.train import (
    create_train_state,
    make_ssv_train_step,
    trainable_labels,
)

from tests.test_torch_train import (
    NETS,
    TERMS,
    _assert_losses,
    _branches,
    _cfg,
    _jax_grad,
    _net_rel_l2,
    _port_grad,
    _setup,
    _tensor_errors,
)


@pytest.fixture(scope="module")
def image_run():
    """One train-mode forward and backward through every sub-network
    (backbone and attention net on images), in both packages; the JAX
    package's gradient a second time with its BatchNorm variance computed
    in two passes."""
    cfg, jm, var, jb, tb, inject = _setup(weights_seed=17)
    kw = dict(train_posenet_stage=True, use_l1_stage=True, train=True, synth_inject=inject)
    ones = dict.fromkeys(TERMS, 1.0)
    lj, gj, mut = _jax_grad(jm, var, jb, ones, **kw)

    compute_stats = j_norm._fnz._compute_stats
    j_norm._fnz._compute_stats = lambda *a, **k: compute_stats(
        *a, **{**k, "use_fast_variance": False})
    try:
        _, gj_two_pass, _ = _jax_grad(jm, var, jb, ones, **kw)
    finally:
        j_norm._fnz._compute_stats = compute_stats

    port = get_model(cfg, device="cpu")
    port.load_state_dict(from_jax(var))
    lt, grads = _port_grad(port, tb, ones, **kw)
    stats = {k: v.clone() for k, v in port.named_buffers()}
    port.load_state_dict(from_jax(var))  # back to the start for the step test
    return cfg, var, (jb, tb), inject, (lj, gj, mut, gj_two_pass), (lt, grads, stats), port


def test_train_mode_losses_match_jax(image_run):
    _, _, _, _, (lj, _, _, _), (lt, _, _), _ = image_run
    _assert_losses(lt, lj)


def test_train_mode_gradients_agree_with_jax(image_run):
    """With batch statistics two float32 gradients agree only loosely
    (module docstring). Per net, as a share of each tensor's largest
    gradient in the port:

      JAX as it is:            every tensor <= 0.5,  median <= 0.1
      JAX, two-pass variance:  every tensor <= 0.15, median <= 2e-2
      RootNet (shallow, three 16x16x8 grids): every tensor <= 0.5 and
      median <= 1e-3 either way

    Reached (worst tensor / median / whole-net relative L2), as it is:
    backbone 0.27 / 4.3e-2 / 4.0e-2, attention net 0.087 / 1.1e-2 / 7.7e-3,
    PoseNet 0.072 / 3.8e-2 / 3.7e-2, RootNet 0.24 / 8.8e-5 / 2.6e-2; two-pass:
    backbone 0.044 / 7.9e-3 / 8.0e-3, attention net 0.086 / 6.4e-3 / 5.2e-3,
    PoseNet 0.030 / 5.5e-3 / 6.5e-3, RootNet 0.41 / 6.6e-5 / 1.6e-2 (its
    worst tensors lie in one block whose gradients are below 1% of the
    net's largest).

    and the whole-net relative L2 distance shrinks from the first to the
    second in the three deep nets, to less than half in the backbone and
    in PoseNet. A bias in front of a train-mode BatchNorm has a gradient
    of zero in exact arithmetic (the port's is below 1e-3 of its net's
    largest): the JAX package's is held to 1e-2 of the net's largest."""
    _, _, _, _, (_, gj, _, gj2), (_, grads, _), _ = image_run
    fast, two_pass = from_jax({"params": gj}), from_jax({"params": gj2})
    for net in NETS:
        e1, z1 = _tensor_errors(fast, grads, net, zero_share=1e-3)
        e2, z2 = _tensor_errors(two_pass, grads, net, zero_share=1e-3)
        assert len(e1) > 40 and set(e1) == set(e2), net
        assert max(list(z1.values()) + list(z2.values()) + [0.0]) <= 1e-2, net
        shallow = net == "root_net."
        assert max(e1.values()) <= 0.5, net
        assert np.median(list(e1.values())) <= (1e-3 if shallow else 0.1), net
        assert max(e2.values()) <= (0.5 if shallow else 0.15), net
        assert np.median(list(e2.values())) <= (1e-3 if shallow else 2e-2), net
        if net != "root_net.":
            share = 1.0 if net == "attn.backbone." else 0.5
            assert _net_rel_l2(two_pass, grads, net) < share * _net_rel_l2(fast, grads, net), net


def test_running_statistics_after_a_train_forward_match_jax(image_run):
    _, _, _, _, (_, _, mut, _), (_, _, stats), _ = image_run
    want = from_jax({"params": image_run[1]["params"], "batch_stats": mut["batch_stats"]})
    checked = 0
    for k, v in stats.items():
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
            checked += 1
    assert checked > 100


def test_one_sgd_train_step_matches_jax(image_run):
    """``make_ssv_train_step`` end to end in train mode: its losses are the
    JAX package's; its parameters equal (start - lr * the gradient of the
    same forward and backward) to 1e-6; and the port's train state fed the
    JAX package's gradient lands on the JAX package's updated parameters
    to 1e-5. (The step's own gradient is held to ``jax.grad`` by the two
    gradient tests above.)"""
    cfg, var, (jb, tb), inject, (lj, gj, mut, _), (_, grads, _), port = image_run
    start = {k: p.detach().clone() for k, p in port.named_parameters()}
    jstate = jax.jit(lambda st, g: st.apply_gradients(g))(j_create_train_state(cfg, var), gj)
    want = from_jax({"params": jstate.params, "batch_stats": mut["batch_stats"]})
    state = create_train_state(cfg, port)
    step = make_ssv_train_step(port, train_posenet_stage=True, use_l1_stage=True)
    metrics = step(state, *tb, synth_inject=inject)
    _assert_losses({k: v for k, v in metrics.items() if k != "loss"}, lj)
    np.testing.assert_allclose(float(metrics["loss"]), sum(float(jnp.mean(v)) for v in lj.values()),
                               rtol=1e-4)
    assert state.step == 1 and all(p.grad is None for p in port.parameters())
    moved = 0.0
    for k, p in port.named_parameters():
        own = start[k] - cfg.TRAIN.LR * grads[k]
        np.testing.assert_allclose(p.detach().numpy(), own.numpy(), atol=1e-6, err_msg=k)
        moved = max(moved, float((p.detach() - start[k]).abs().max()))
    assert moved > 1e-3  # the update is far above the tolerances
    assert port.backbone.training and port.pose_net.training

    twin = get_model(cfg, device="cpu")
    twin.load_state_dict(from_jax(var))
    tstate = create_train_state(cfg, twin)
    gjax = from_jax({"params": gj})
    for k, p in twin.named_parameters():
        p.grad = gjax[k].clone()
    tstate.apply_gradients()
    for k, p in twin.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("flag, frozen", [
    ({"FREEZE_ROOTNET": True}, "root_net"),
    ({"TRAIN_BACKBONE": False}, "backbone"),
])
def test_frozen_subtrees_get_no_update_and_no_optimizer_state(flag, frozen):
    cfg = _cfg(NETWORK=flag)
    assert trainable_labels(cfg)[frozen] is False
    port = get_model(cfg, device="cpu", seed=1)
    with torch.no_grad():
        port.root_net.v2v_net.output_layer.bias += 1.0
    _, tb = _branches(cfg, True, 1, seed=3)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state = create_train_state(cfg, port)
    step = make_ssv_train_step(port, train_posenet_stage=True, use_l1_stage=True)
    metrics = step(state, *tb, generator=torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = port.state_dict()
    for k, v in before.items():
        if k.startswith(frozen + "."):
            assert torch.equal(after[k], v), k  # parameters and BatchNorm statistics
    for net in {"backbone", "attn", "root_net", "pose_net"} - {frozen}:
        changed = [k for k, v in before.items()
                   if k.startswith(net + ".") and k.endswith("weight") and not torch.equal(after[k], v)]
        assert changed, net
    held = {id(p) for group in state.optimizer.param_groups for p in group["params"]}
    for k, p in port.named_parameters():
        assert (id(p) in held) == (not k.startswith(frozen + ".")), k
        assert p.requires_grad == (not k.startswith(frozen + ".")), k
    if frozen == "root_net":
        assert "loss_root_syn" not in metrics  # no RootNet loss when it is frozen
