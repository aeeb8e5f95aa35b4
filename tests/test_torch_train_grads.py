"""Parameter gradients of the port's SSV train-stage losses against
``jax.grad`` of the JAX package, on the CPU at a small float32 size, images
through every sub-network: the same numpy-seeded weights (JAX tree ->
``from_jax``, which also maps the gradient tree onto the port's names),
scenes and injected synthetic-root draws go through both.

BatchNorm runs on its running statistics here (``bn_eval``): the loss
composition, every ``detach`` and the samplers' adjoint are those of the
train step, and two float32 runs agree to about 1e-3 of each tensor's
largest gradient. With batch statistics they cannot; that comparison, and
the train step end to end, is in tests/test_torch_train_step.py.

The JAX package samples through its exact gather path
(NETWORK.SAMPLING = 'gather'), as the port's samplers are exact everywhere.
"""

import numpy as np
import pytest
import jax

from selfpose3d_tpu.train.train_state import create_train_state as j_create_train_state

from selfpose3d_tpu_torch.convert.from_jax import from_jax
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.train import create_train_state

from tests.test_torch_train import (
    NETS,
    TERMS,
    _assert_losses,
    _jax_grad,
    _net_rel_l2,
    _port_grad,
    _setup,
    _tensor_errors,
)

# Weights of the six terms in the tight gradient test, chosen so that every
# term weighs about 1 at these weights and inputs (unweighted they span
# 1.7e-4 .. 452): each term's gradient then shows in every tensor it reaches.
BALANCED = {"loss_2d": 20.0, "loss_root_syn": 2e-3, "loss_root_reg": 5e3,
            "loss_pose3d_ssv": 15.0, "loss_attn_ssv": 20.0, "loss_pose3d_l1_ssv": 7.0}
# Bar of every single tensor in the tight gradient test. Reached: 2.8e-3
# (three tensors of one PoseNet encoder block, one channel each: a ReLU
# whose input is within round-off of zero falls on the other side in the
# two packages) and 1.7e-3 (one deconvolution of the backbone); the other
# 320 tensors are within 1e-3, the median is 1e-4.
EVERY = 5e-3


@pytest.fixture(scope="module")
def eval_run():
    """Forward and backward of the train-stage losses on running BatchNorm
    statistics, images through every sub-network (the attention maps come
    from the attention net, so it trains too), in both packages, on the
    balanced sum of the six terms."""
    cfg, jm, var, jb, tb, inject = _setup(weights_seed=17)
    kw = dict(train_posenet_stage=True, use_l1_stage=True, train=True, bn_eval=True,
              synth_inject=inject)
    lj, gj, _ = _jax_grad(jm, var, jb, BALANCED, **kw)
    port = get_model(cfg, device="cpu")
    port.load_state_dict(from_jax(var))
    lt, gt = _port_grad(port, tb, BALANCED, **kw)
    return cfg, var, port, (lj, gj), (lt, gt)


def test_bn_eval_losses_match_jax(eval_run):
    _, _, _, (lj, _), (lt, _) = eval_run
    _assert_losses(lt, lj)
    for k in TERMS:  # every term is live, and the weights balance them
        assert 0.5 < BALANCED[k] * float(lt[k]) < 2.0, (k, float(lt[k]))


def test_gradients_of_every_parameter_match_jax(eval_run):
    """Every parameter's gradient of the balanced sum of the six terms
    against ``jax.grad``, mapped by ``from_jax``, float32 against float32.
    Error: largest absolute difference over the tensor's largest JAX
    gradient. Held:

      every tensor              <= EVERY (stated below with what was reached)
      95% of each net's tensors <= 1e-3
      each net's whole gradient <= 1e-3 in relative L2 norm

    The one tensor whose gradient is zero in exact arithmetic (PoseNet's
    output bias: the soft-argmax ignores a shift of its input) is held to
    1e-5 of PoseNet's largest gradient."""
    _, _, port, (_, gj), (_, gt) = eval_run
    gjax = from_jax({"params": gj})
    assert set(gjax) == set(gt) == {k for k, _ in port.named_parameters()}
    zero_names = []
    for net in NETS:
        errs, zeros = _tensor_errors(gt, gjax, net)
        worst = max(errs.items(), key=lambda kv: kv[1])
        assert worst[1] <= EVERY, (net, worst)
        assert np.mean([e <= 1e-3 for e in errs.values()]) >= 0.95, net
        assert _net_rel_l2(gt, gjax, net) <= 1e-3, net
        for k, e in zeros.items():
            assert e <= 1e-5, (k, e)
        zero_names += list(zeros)
    assert zero_names == ["pose_net.v2v_net.output_layer.bias"], zero_names


def test_sgd_update_from_own_gradient_matches_jax(eval_run):
    """Each package's train state applies its own gradient (SGD with
    momentum, one update): updated parameters agree to 1e-5, and the
    applied update (start - new) / lr agrees with the JAX package's to
    the bar of the gradient test."""
    cfg, var, port, (_, gj), (_, gt) = eval_run
    start = from_jax(var)
    jstate = jax.jit(lambda st, g: st.apply_gradients(g))(j_create_train_state(cfg, var), gj)
    want = from_jax({"params": jstate.params})
    port.load_state_dict(start)
    state = create_train_state(cfg, port)
    for k, p in port.named_parameters():
        p.grad = gt[k].clone()
    state.apply_gradients()
    moved = 0.0
    for k, p in port.named_parameters():
        new = p.detach()
        np.testing.assert_allclose(new.numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
        moved = max(moved, float((new - start[k]).abs().max()))
    assert moved > 1e-4  # the update is above the tolerance
    port.load_state_dict(start)
