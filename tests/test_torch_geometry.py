"""Port parity: config, geometry, sample grids, synthetic scenes and the
Gaussian renderer against the JAX package, on numpy-seeded inputs."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfpose3d_tpu.config import load_config as j_load_config
from selfpose3d_tpu.data.synthetic import make_synthetic_branch as j_make_branch
from selfpose3d_tpu.geometry import cameras as jcam
from selfpose3d_tpu.geometry import transforms as jtr
from selfpose3d_tpu.geometry.grid import compute_grid as j_compute_grid
from selfpose3d_tpu.ops.gaussian import render_gaussian_heatmaps as j_render
from selfpose3d_tpu.ops.unproject import compute_sample_grid as j_sample_grid

from selfpose3d_tpu_torch.config import flagship_cfg, load_config
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
from selfpose3d_tpu_torch.geometry import cameras as tcam
from selfpose3d_tpu_torch.geometry import transforms as ttr
from selfpose3d_tpu_torch.geometry.grid import compute_grid, grid_1d_axes
from selfpose3d_tpu_torch.ops.gaussian import render_gaussian_heatmaps
from selfpose3d_tpu_torch.ops.unproject import compute_sample_grid, to_pixels

from tests.test_multi_person import small_cfg


def test_flagship_cfg_matches_graft_entry():
    import __graft_entry__

    want = dataclasses.asdict(__graft_entry__._flagship_cfg(tiny=False))
    assert dataclasses.asdict(flagship_cfg()) == want


@pytest.mark.parametrize("path", [
    "configs/panoptic_ssl/resnet50/cam5_posenet.yaml",
    "configs/panoptic/resnet50/prn64_cpn80x80x20_960x512_cam5.yaml",
    "configs/synthetic/tiny_ssv.yaml",
])
def test_yaml_configs_load_identically(path):
    assert dataclasses.asdict(load_config(path)) == dataclasses.asdict(j_load_config(path))


def test_config_rejects_unknown_keys():
    with pytest.raises(ValueError, match="not exist"):
        load_config(overrides={"NETWORK": {"NOT_A_KEY": 1}})
    with pytest.raises(ValueError, match="not exist"):
        load_config(overrides={"NOT_A_SECTION": 1})


@pytest.mark.parametrize("rot", [0.0, 17.0, -30.0])
def test_affine_transforms_match(rot):
    center, out = np.array([960.0, 540.0]), (960, 512)
    scale = ttr.get_scale((1920, 1080), out)
    np.testing.assert_array_equal(scale, jtr.get_scale((1920, 1080), out))
    for inv in (0, 1):
        np.testing.assert_array_equal(
            ttr.get_affine_transform_3x3(center, scale, rot, out, inv=inv),
            jtr.get_affine_transform_3x3(center, scale, rot, out, inv=inv),
        )


def _random_cams(rs, B, V):
    """Ring cameras with random distortion, as numpy (B, V) fields."""
    from selfpose3d_tpu_torch.data.synthetic import ring_cameras

    c = ring_cameras(V, seed=int(rs.randint(100)))
    f = {k: np.repeat(getattr(c, k).numpy(), B, axis=0) for k in "RTfckp"}
    f["k"] = (rs.randn(B, V, 3) * np.array([0.02, 0.002, 0.0002])).astype(np.float32)
    f["p"] = (rs.randn(B, V, 2) * 0.0005).astype(np.float32)
    return f


def _project_f64(x, cams):
    """Float64 projection -> (pixels, r2 of the undistorted image point)."""
    R, T, f, c, k, p = (cams[n].astype(np.float64) for n in "RTfckp")
    xc = np.einsum("...ij,...nj->...ni", R, x.astype(np.float64) - np.swapaxes(T, -1, -2))
    y = xc[..., :2] / (xc[..., 2:3] + 1e-5)
    r2 = (y * y).sum(-1)
    radial = 1 + k[..., 0:1] * r2 + k[..., 1:2] * r2 ** 2 + k[..., 2:3] * r2 ** 3
    tan = p[..., 0:1] * y[..., 1] + p[..., 1:2] * y[..., 0]
    y = y * (radial + 2 * tan)[..., None] + p[..., None, ::-1] * r2[..., None]
    return f[..., None, :] * y + c[..., None, :], r2


def test_project_points_matches_jax():
    """Pixels agree to 2.5e-4 px (2 ulps at 1920) for points inside the cameras' field
    of view. Far off-axis points that the distortion polynomial folds back
    into the image (r^2 > 1) are ill-conditioned in f32; there the port is
    held to be as close to a float64 projection as the JAX package is."""
    rs = np.random.RandomState(0)
    cams = _random_cams(rs, 2, 3)
    x = (rs.randn(2, 1, 500, 3) * [2000, 2000, 500] + [0, -500, 800]).astype(np.float32)
    trans = np.tile(jtr.get_affine_transform_3x3(
        [960, 540], jtr.get_scale((1920, 1080), (960, 512)), 12.0, (960, 512)), (2, 3, 1, 1))
    jc = jcam.CameraParams(**{k: jnp.asarray(v) for k, v in cams.items()})
    tc = tcam.CameraParams(**{k: torch.from_numpy(v) for k, v in cams.items()})
    want = np.asarray(jcam.project_points(jnp.asarray(x), jc))
    got = tcam.project_points(torch.from_numpy(x), tc).numpy()
    assert got.shape == (2, 3, 500, 2)
    truth, r2 = _project_f64(x, cams)
    seen = ((want >= 0) & (want < [1920, 1080])).all(-1)
    fov = seen & (r2 < 1.0)
    assert fov.mean() > 0.3
    np.testing.assert_allclose(got[fov], want[fov], atol=2.5e-4, rtol=0)
    assert (np.abs(got[seen] - truth[seen]).max()
            <= 2.5 * np.abs(want[seen] - truth[seen]).max() + 1e-4)

    want_t = np.asarray(jcam.project_points_with_trans(jnp.asarray(x), jc, jnp.asarray(trans)))
    got_t = tcam.project_points_with_trans(torch.from_numpy(x), tc, torch.from_numpy(trans))
    np.testing.assert_allclose(got_t.numpy()[fov], want_t[fov], atol=2.5e-4, rtol=0)


def test_compute_grid_matches_jax():
    center = np.array([[120.0, -340.0, 900.0], [-2000.0, 1500.0, 700.0]], np.float32)
    got = compute_grid((2000.0,) * 3, torch.from_numpy(center), (8, 6, 4)).numpy()
    for b in range(2):
        want = np.asarray(j_compute_grid((2000.0,) * 3, jnp.asarray(center[b]), (8, 6, 4)))
        # linspace rounding differs between the frameworks by < 1 ulp of 1000 mm
        np.testing.assert_allclose(got[b], want, atol=1e-3)
    gx, gy, gz = grid_1d_axes((8000.0, 8000.0, 2000.0), (0.0, -500.0, 800.0), (80, 80, 20))
    assert (gx.shape, gy.shape, gz.shape) == ((80,), (80,), (20,))


@pytest.mark.parametrize("hflip", [None, (True, False)])
def test_compute_sample_grid_matches_jax(hflip):
    rs = np.random.RandomState(1)
    B, V, N = 2, 3, 2000
    cams = _random_cams(rs, B, V)
    grid = (rs.rand(B, 1, N, 3) * [8000, 8000, 2000] + [-4000, -4500, -200]).astype(np.float32)
    trans = np.tile(jtr.get_affine_transform_3x3(
        [960, 540], jtr.get_scale((1920, 1080), (256, 128)), -8.0, (256, 128)), (B, V, 1, 1))
    orig_wh = np.tile(np.float32([1920, 1080]), (B, V, 1))
    flip = None if hflip is None else np.broadcast_to(np.array(hflip)[:, None], (B, V))
    jsg, jb = j_sample_grid(
        jnp.asarray(grid), jcam.CameraParams(**{k: jnp.asarray(v) for k, v in cams.items()}),
        jnp.asarray(trans), (256, 128), (64, 32),
        hflip=None if flip is None else jnp.asarray(flip), orig_wh=jnp.asarray(orig_wh))
    tsg, tb = compute_sample_grid(
        torch.from_numpy(grid),
        tcam.CameraParams(**{k: torch.from_numpy(v) for k, v in cams.items()}),
        torch.from_numpy(trans), (256, 128), (64, 32), torch.from_numpy(orig_wh),
        hflip=None if flip is None else torch.from_numpy(flip.copy()))
    jsg, jb = np.asarray(jsg), np.asarray(jb)
    assert 0.1 < jb.mean() < 1.0  # both in- and out-of-image voxels
    np.testing.assert_array_equal(tb.numpy(), jb)
    # 3e-6 normalised = 1e-4 heatmap px at W=64: f32 round-off of the
    # projection near the frustum edge (see test_project_points_matches_jax)
    np.testing.assert_allclose(tsg.numpy(), jsg, atol=3e-6)
    px, py = to_pixels(tsg, (64, 32))
    np.testing.assert_allclose(px.numpy(), (jsg[..., 0] + 1) * 0.5 * 63, atol=1e-4)
    np.testing.assert_allclose(py.numpy(), (jsg[..., 1] + 1) * 0.5 * 31, atol=1e-4)


@pytest.mark.parametrize("with_images", [False, True])
def test_synthetic_branch_matches_jax(with_images):
    cfg = small_cfg()
    jb, jposes = j_make_branch(cfg, batch_size=2, num_person=3, seed=4, with_images=with_images)
    tb, tposes = make_synthetic_branch(cfg, batch_size=2, num_person=3, seed=4,
                                       with_images=with_images, device="cpu")
    np.testing.assert_array_equal(tposes, jposes)
    for k in "RTfckp":
        np.testing.assert_array_equal(getattr(tb.cam, k).numpy(), np.asarray(getattr(jb.cam, k)))
    for name in ("trans", "orig_wh", "roots_3d", "joints_3d", "num_person", "hflip"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    np.testing.assert_allclose(tb.joints.numpy(), np.asarray(jb.joints), atol=1e-3)
    np.testing.assert_allclose(tb.target_2d.numpy(), np.asarray(jb.target_2d), atol=1e-5)
    if with_images:
        assert tb.input_heatmaps is None
        np.testing.assert_array_equal(tb.views.numpy(), np.asarray(jb.views))
    else:
        assert tb.views is None
        np.testing.assert_allclose(
            tb.input_heatmaps.numpy(), np.asarray(jb.input_heatmaps), atol=1e-5)


def test_render_gaussian_heatmaps_matches_jax():
    rs = np.random.RandomState(2)
    centers = (rs.rand(2, 3, 4, 5, 2) * [256, 128]).astype(np.float32)
    mask = (rs.rand(2, 3, 4) > 0.3).astype(np.float32)
    want = np.asarray(j_render(jnp.asarray(centers), (64, 32), sigma=3.0, mask=jnp.asarray(mask)))
    got = render_gaussian_heatmaps(torch.from_numpy(centers), (64, 32), sigma=3.0,
                                   mask=torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 3, 5, 32, 64)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_synthetic_branch_requires_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_synthetic_branch(small_cfg())
