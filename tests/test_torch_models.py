"""Port parity, module level: PoseResNet, V2VNet, proposals, soft-argmax,
PoseNet buckets and the JAX -> port weight converter.

The same numpy-seeded weights and inputs go through the JAX module and
its port. Weights are drawn for the JAX parameter tree and carried to the
port by ``selfpose3d_tpu_torch.convert.from_jax``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfpose3d_tpu.convert.torch2jax import convert_pose_resnet, convert_v2v_net
from selfpose3d_tpu.models import PoseResNet as JPoseResNet, V2VNet as JV2VNet
from selfpose3d_tpu.ops.proposal import nms_topk as j_nms_topk, proposals_soft as j_proposals
from selfpose3d_tpu.ops.softargmax import soft_argmax_ndhwc as j_soft_argmax

from selfpose3d_tpu_torch.convert.from_jax import pose_resnet_state_dict, v2v_state_dict
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.models.pose_net import PoseNet
from selfpose3d_tpu_torch.models.pose_resnet import PoseResNet
from selfpose3d_tpu_torch.models.v2v_net import V2VNet
from selfpose3d_tpu_torch.ops.proposal import nms_topk, proposals_soft
from selfpose3d_tpu_torch.ops.softargmax import soft_argmax_ndhwc


def random_variables(shapes, seed):
    """Numpy-seeded values for a JAX variables tree of ShapeDtypeStructs:
    fan-in-scaled kernels, small biases, BatchNorm stats near identity."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("bias", "mean"):
            v = rs.randn(*shape) * 0.05
        elif name in ("scale", "var"):
            v = 0.75 + 0.5 * rs.rand(*shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_module_variables(module, x, seed):
    shapes = jax.eval_shape(
        lambda a: module.init(jax.random.PRNGKey(0), a), jax.ShapeDtypeStruct(x.shape, x.dtype)
    )
    return random_variables(shapes, seed)


def load_port(module, state_dict):
    module.load_state_dict(state_dict)
    return module.eval()


@pytest.mark.parametrize("layers, hw", [(18, (64, 96)), (50, (64, 64))])
def test_pose_resnet_matches_jax(layers, hw):
    rs = np.random.RandomState(layers)
    x = rs.rand(2, *hw, 3).astype(np.float32)
    jm = JPoseResNet(num_layers=layers, num_joints=15, dtype=jnp.float32)
    var = jax_module_variables(jm, x, seed=layers)
    want = np.asarray(jm.apply(var, jnp.asarray(x), train=False))

    pm = load_port(PoseResNet(num_layers=layers, num_joints=15),
                   pose_resnet_state_dict(var["params"], var["batch_stats"]))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, hw[0] // 4, hw[1] // 4, 15)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_v2v_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.rand(2, 16, 16, 16, 15).astype(np.float32)
    jm = JV2VNet(out_ch=15, dtype=jnp.float32)
    var = jax_module_variables(jm, x, seed=2)
    want = np.asarray(jm.apply(var, jnp.asarray(x), train=False))

    pm = load_port(V2VNet(15, 15), v2v_state_dict(var["params"], var["batch_stats"]))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 16, 15)
    np.testing.assert_allclose(got, want, atol=1e-4)


def _tie_volume(case):
    shape = (2, 16, 16, 8)
    if case == "random_init_v2v":  # the near-flat output of a random-init root V2V
        from selfpose3d_tpu_torch.models import init_weights

        m = V2VNet(1, 1).eval()
        init_weights(m, torch.Generator().manual_seed(0))
        x = torch.from_numpy(np.random.RandomState(6).rand(*shape, 1).astype(np.float32))
        with torch.no_grad():
            return m(x)[..., 0].numpy().copy()
    if case == "constant_positive":
        return np.full(shape, 0.25, np.float32)
    if case == "constant_negative":
        return np.full(shape, -0.25, np.float32)
    return (np.random.RandomState(5).randint(-3, 4, shape) / 4.0).astype(np.float32)


@pytest.mark.parametrize(
    "case", ["random_init_v2v", "constant_positive", "constant_negative", "quantised"]
)
def test_nms_topk_tie_order_matches_lax_top_k(case):
    cube = _tie_volume(case)
    jv, ji = j_nms_topk(jnp.asarray(cube), 10)
    tv, ti = nms_topk(torch.from_numpy(cube), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # signed zeros included: suppressed negatives rank below suppressed positives
    np.testing.assert_array_equal(np.signbit(tv.numpy()), np.signbit(np.asarray(jv)))


def test_proposals_soft_matches_jax():
    rs = np.random.RandomState(3)
    cube = rs.randn(2, 16, 16, 8).astype(np.float32)
    args = (6, 0.5, (8000.0, 8000.0, 2000.0), (0.0, -500.0, 800.0), (16, 16, 8))
    want = np.asarray(j_proposals(jnp.asarray(cube), *args))
    got = proposals_soft(torch.from_numpy(cube), *args).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got[..., 3], want[..., 3])


@pytest.mark.parametrize("beta", [1.0, 100.0])
def test_soft_argmax_matches_jax(beta):
    rs = np.random.RandomState(4)
    x = rs.randn(3, 8, 6, 5, 4).astype(np.float32) * 0.05
    axes = [(rs.randn(3, 1) * 500 + np.linspace(-1000, 1000, n)).astype(np.float32)
            for n in (8, 6, 5)]
    want = np.asarray(j_soft_argmax(jnp.asarray(x), tuple(map(jnp.asarray, axes)), beta=beta))
    got = soft_argmax_ndhwc(torch.from_numpy(x), tuple(map(torch.from_numpy, axes)), beta=beta)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


@pytest.fixture(scope="module")
def bucket_setup():
    from tests.test_multi_person import small_cfg
    from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch

    cfg = small_cfg(DATASET={"CAMERA_NUM": 2}, NETWORK={"NUM_JOINTS": 4})
    branch, poses = make_synthetic_branch(cfg, batch_size=2, num_person=3,
                                          with_images=False, seed=1, device="cpu")
    net = PoseNet(cube_size=(8, 8, 8), image_wh=(256, 128), num_joints=4, buckets=(2, 3))
    torch.manual_seed(0)
    for p in net.parameters():
        p.data.normal_(0.0, 0.1)
    net.eval()
    rs = np.random.RandomState(2)
    centers = np.concatenate(
        [poses[:, :, 2], rs.uniform(-500, 500, (2, 1, 3)).astype(np.float32)], axis=1)
    return net, branch, torch.from_numpy(centers)


@pytest.mark.parametrize("n_valid, k", [(0, 2), (2, 2), (3, 3), (4, 4)])
def test_posenet_bucketed_equals_unbucketed(bucket_setup, n_valid, k):
    net, br, centers = bucket_setup
    flags = torch.where(torch.arange(4) < n_valid, 0.0, -1.0).expand(2, 4)
    gc = torch.cat([centers, flags[..., None], torch.ones(2, 4, 1)], dim=-1)
    assert net.bucket(gc) == k
    args = (br.input_heatmaps, br.cam, br.trans, br.orig_wh, gc)
    with torch.no_grad():
        full, vf = net(*args, bucketed=False)
        cut, vc = net(*args)
    np.testing.assert_allclose(cut.numpy(), full.numpy(), atol=1e-4)
    np.testing.assert_array_equal(vc.numpy(), vf.numpy())
    assert (full[:, n_valid:] == 0).all()
    if n_valid:
        assert full[:, :n_valid].abs().min() > 0


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.dtype.is_floating_point:
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    return module


@pytest.mark.parametrize("which", ["pose_resnet18", "v2v"])
def test_state_dict_round_trip_through_torch2jax(which):
    """port state dict -> torch2jax (the JAX package's converter) -> from_jax
    gives back the same tensors."""
    if which == "v2v":
        m = _randomize(V2VNet(3, 2), 1)
        conv = convert_v2v_net(m.state_dict())
        back = v2v_state_dict(conv["params"], conv["batch_stats"])
    else:
        m = _randomize(PoseResNet(num_layers=18, num_joints=5), 2)
        conv = convert_pose_resnet(m.state_dict())
        back = pose_resnet_state_dict(conv["params"], conv["batch_stats"])
    sd = m.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, check_dtype=False)


def test_get_model_requires_cuda_unless_cpu_is_asked_for(monkeypatch):
    from selfpose3d_tpu_torch.config import flagship_cfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(flagship_cfg())


def test_get_model_cpu_flagship_modules_and_dtypes():
    """The flagship model builds on the CPU at full width: float32
    parameters everywhere (an optimizer updates them), convolutions that
    cast them to the bf16 compute dtype at use, TF32 off."""
    from selfpose3d_tpu_torch.config import flagship_cfg

    m = get_model(flagship_cfg(), device="cpu")
    assert not m.training
    conv = m.backbone.layer3[5].conv2
    assert conv.weight.dtype == torch.float32
    assert m.backbone.dtype == m.pose_net.v2v_net.dtype == torch.bfloat16
    x = torch.zeros(1, conv.in_channels, 4, 4, dtype=torch.bfloat16)
    assert conv(x).dtype == torch.bfloat16
    assert m.attn.backbone.layer4[1].conv2.out_channels == 512
    assert m.backbone.final_layer.weight.dtype == torch.float32
    assert m.backbone.bn1.running_var.dtype == torch.float32
    assert m.pose_net.v2v_net.output_layer.weight.dtype == torch.float32
    assert m.root_net.v2v_net.front_layers[0].block[0].in_channels == 1
    assert m.pose_net.buckets == (4, 5)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    n = sum(p.numel() for p in m.parameters())
    assert n > 30_000_000, n
