"""The port's optimizer steps every trainable parameter on every step, as
optax steps every leaf labelled 'train' (selfpose3d_tpu/train/train_state.py:
65-73): a parameter whose sub-network sat out a step (no ``.grad``) is
stepped on a zero gradient, so Adam's moments decay and its step count,
which bias-corrects the next update, moves on. Held against optax on a toy
module whose second sub-network first gets a gradient at step 3, to 1e-6.
"""

import numpy as np
import optax
import pytest
import torch
import torch.nn as nn
import jax
import jax.numpy as jnp

from selfpose3d_tpu_torch.config import load_config
from selfpose3d_tpu_torch.train import create_train_state

LR, STEPS, LATE = 1e-2, 5, 3


def _toy():
    toy = nn.Module()
    toy.first = nn.Linear(3, 2)
    toy.second = nn.Linear(2, 1)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in toy.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return toy


def _grads(step, names, shapes):
    """Step ``step``'s gradients (1-based): the second sub-network's from step LATE."""
    rs = np.random.RandomState(step)
    return {k: (rs.randn(*shapes[k]).astype(np.float32)
                if k.startswith("first") or step >= LATE else None) for k in names}


@pytest.mark.parametrize("optimizer, reference", [
    ("adam", lambda: optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)),
    ("sgd", lambda: optax.sgd(LR, momentum=0.9, nesterov=False)),
])
def test_every_trainable_parameter_steps_every_step_as_optax(optimizer, reference):
    cfg = load_config(overrides={"TRAIN": {"OPTIMIZER": optimizer, "LR": LR, "MOMENTUM": 0.9,
                                           "NESTEROV": False, "LR_STEP": [100]}})
    toy = _toy()
    params = {k: jnp.array(p.detach().numpy(), copy=True) for k, p in toy.named_parameters()}
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    state = create_train_state(cfg, toy)
    tx = reference()
    opt_state = tx.init(params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for step in range(1, STEPS + 1):
        grads = _grads(step, list(params), shapes)
        for k, p in toy.named_parameters():
            p.grad = None if grads[k] is None else torch.from_numpy(grads[k])
        state.apply_gradients()
        # optax sees zeros where the port's parameter had no gradient
        jgrads = {k: jnp.asarray(v if v is not None else np.zeros(shapes[k], np.float32))
                  for k, v in grads.items()}
        params, opt_state = update(jgrads, opt_state, params)
        for k, p in toy.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{k} after step {step}")
    if optimizer == "adam":  # Adam's shared count: every parameter at step STEPS
        assert {int(s["step"]) for s in state.optimizer.state.values()} == {STEPS}
