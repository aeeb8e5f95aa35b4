"""The port against the JAX package at bfloat16, the flagship's dtype.

The small inference config of ``tests/test_torch_inference.py`` runs at
``DTYPE="bfloat16"`` and at float32 in both packages, with the same
numpy-seeded weights (JAX tree -> ``convert.from_jax``) and the same
synthetic scene, on the CPU. Three tensors are held: the backbone
heatmaps, the RootNet root cubes, and PoseNet's V2V input cubes (the
bf16 output of the port's ``sample_cubes`` against the JAX package's
sampled cubes, ``selfpose3d_tpu/models/pose_net.py:191-209``).

The two packages round to bf16 at different places, so at bf16 they agree
only to about the size of that rounding. The bars for each tensor come
from the JAX package alone: its own bf16-versus-float32 gap on the tensor,
measured in the same test, times ``BF16_GAP_MULTIPLE``. The port at bf16
may be no farther than that from the JAX package at bf16, and the port's
own bf16-versus-float32 gap must lie within that factor of the JAX
package's, either way. So a fault in the port's bf16 path (a cast in the
wrong place, a lost channel) cannot raise its own bar: a lost channel
shows as a difference of the size of the tensor's values, and a path
left in float32 shows as an own gap far below the reference's. Poses are
no bar: with random weights the soft-argmax of a near-flat score
amplifies bf16 noise into tens of mm in either package alone.
"""

import numpy as np
import pytest
import torch
import jax
import flax.linen as nn

from selfpose3d_tpu.data.synthetic import make_synthetic_branch as j_make_branch
from selfpose3d_tpu.models import get_model as j_get_model
from selfpose3d_tpu.models.pose_net import PoseNet as JPoseNet
from selfpose3d_tpu.models.root_net import RootNet as JRootNet

from selfpose3d_tpu_torch.convert.from_jax import from_jax
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
from selfpose3d_tpu_torch.models import get_model

from tests.test_multi_person import small_cfg
from tests.test_torch_models import random_variables

BF16_GAP_MULTIPLE = 1.5
TENSORS = ("heatmaps", "root_cubes", "pose_cubes")


def _cfg(dtype):
    return small_cfg(DTYPE=dtype, MULTI_PERSON={"MAX_PEOPLE_NUM": 4, "THRESHOLD": -100.0})


def _jax_run(cfg, var, branch):
    """do_inference, with RootNet's root cubes and PoseNet's V2V input
    taken on the way."""
    got = {}

    def take(next_fun, args, kwargs, ctx):
        out = next_fun(*args, **kwargs)
        if ctx.method_name == "__call__":
            if isinstance(ctx.module, JRootNet):
                got["root_cubes"] = np.asarray(out[0], np.float32)
            elif isinstance(ctx.module.parent, JPoseNet) and ctx.module.name == "v2v_net":
                got["pose_cubes"] = np.asarray(args[0], np.float32)
        return out

    with nn.intercept_methods(take):
        _, hm, gc = j_get_model(cfg).apply(var, branch, method="do_inference")
    return {"heatmaps": np.asarray(hm, np.float32), "flags": np.asarray(gc)[..., 3], **got}


def _port_run(cfg, var, branch):
    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_jax(var))
    got = {}
    hooks = [
        model.root_net.register_forward_hook(
            lambda mod, args, out: got.update(root_cubes=out[0].float().numpy())),
        model.pose_net.v2v_net.register_forward_pre_hook(
            lambda mod, args: got.update(pose_cubes=args[0].float().numpy(),
                                         pose_cubes_dtype=args[0].dtype)),
    ]
    with torch.no_grad():
        _, hm, gc = model.do_inference(branch)
    for h in hooks:
        h.remove()
    return {"heatmaps": hm.float().numpy(), "flags": gc[..., 3].numpy(), **got}


@pytest.fixture(scope="module")
def runs():
    c32 = _cfg("float32")
    jb, _ = j_make_branch(c32, batch_size=1, num_person=3, seed=3, with_images=True)
    tb, _ = make_synthetic_branch(c32, batch_size=1, num_person=3, seed=3, with_images=True,
                                  device="cpu")
    shapes = jax.eval_shape(
        lambda b: j_get_model(c32).init(
            {"params": jax.random.PRNGKey(0), "synth": jax.random.PRNGKey(1)}, b,
            method="do_inference"), jb)
    var = random_variables(shapes, seed=11)
    # lift the root detection volume positive so top-k is not tie-bound
    # (tests/test_full_parity.py:80-83)
    var["params"]["root_net"]["v2v_net"]["output_layer"]["bias"] += 1.0
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(dtype)
        out["jax", dtype] = _jax_run(cfg, var, jb)
        out["port", dtype] = _port_run(cfg, var, tb)
    return out


def test_bf16_port_runs_the_flagship_dtype(runs):
    """The port's PoseNet takes bf16 cubes from its sampler, and both
    packages keep the same proposals at bf16."""
    assert runs["port", "bfloat16"]["pose_cubes_dtype"] == torch.bfloat16
    assert runs["port", "float32"]["pose_cubes_dtype"] == torch.float32
    np.testing.assert_array_equal(runs["port", "bfloat16"]["flags"],
                                  runs["jax", "bfloat16"]["flags"])


@pytest.mark.parametrize("name", TENSORS)
def test_bf16_matches_jax_within_the_packages_own_bf16_gap(runs, name):
    def dist(a, b):
        return float(np.abs(runs[a][name] - runs[b][name]).max())

    assert runs["port", "bfloat16"][name].shape == runs["jax", "bfloat16"][name].shape
    ref_gap = dist(("jax", "bfloat16"), ("jax", "float32"))
    assert ref_gap > 0, "bf16 and float32 runs are equal: the bf16 path did not run"
    assert dist(("port", "float32"), ("jax", "float32")) <= 1e-4 * float(
        np.abs(runs["jax", "float32"][name]).max())
    own_gap = dist(("port", "bfloat16"), ("port", "float32"))
    assert ref_gap / BF16_GAP_MULTIPLE <= own_gap <= BF16_GAP_MULTIPLE * ref_gap, (
        name, own_gap, ref_gap)
    diff = dist(("port", "bfloat16"), ("jax", "bfloat16"))
    assert diff <= BF16_GAP_MULTIPLE * ref_gap, (name, diff, ref_gap)
