"""The port's samplers (plain versions of the two CUDA kernels) against the
JAX package: its exact gather path, and its Pallas slice-warp kernels in
interpret mode wherever their ``ok`` mask says they are exact."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import selfpose3d_tpu.ops.slicewarp as sw
from selfpose3d_tpu.geometry.grid import compute_grid as j_compute_grid
from selfpose3d_tpu.ops.sampling import grid_sample_bilinear_cmajor
from selfpose3d_tpu.ops.unproject import (
    compute_sample_grid as j_sample_grid,
    sample_and_aggregate_cmajor,
    unproject_heatmaps as j_unproject,
)

from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
from selfpose3d_tpu_torch.ops import build
from selfpose3d_tpu_torch.ops import slicewarp as tsw
from selfpose3d_tpu_torch.ops.slicewarp import LAUNCHES, sample_view, sample_views_mean
from selfpose3d_tpu_torch.ops.unproject import sample_cubes, to_pixels, unproject_heatmaps

from tests.test_multi_person import small_cfg
from tests.test_slicewarp import smooth_heatmap


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*args, **kw)

    monkeypatch.setattr(sw.pl, "pallas_call", patched)


def _grid(rs, shape):
    """Normalised coords in [-1.1, 1.1], a quarter of them snapped to texel
    centers and image borders (integer pixel coords)."""
    g = rs.uniform(-1.1, 1.1, shape + (2,)).astype(np.float32)
    snap = rs.rand(*shape) < 0.25
    g[snap] = np.round(g[snap] * 4) / 4
    return g


def test_sample_view_plain_matches_exact_gather():
    rs = np.random.RandomState(0)
    B, H, W, J, N = 2, 24, 40, 5, 3000
    hm = rs.rand(B, H, W, J).astype(np.float32)
    g = _grid(rs, (B, N))
    want = np.stack([np.asarray(grid_sample_bilinear_cmajor(jnp.asarray(hm[b]), jnp.asarray(g[b])))
                     for b in range(B)])  # (B, J, N)
    px, py = to_pixels(torch.from_numpy(g), (W, H))
    got = sample_view(torch.from_numpy(hm), px, py)
    assert got.shape == (B, N, J) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 2, 1), atol=1e-6)


@pytest.mark.parametrize("out_dtype, tol", [(torch.float32, 1e-6), (torch.bfloat16, 4e-3)])
def test_sample_views_mean_plain_matches_exact_gather(out_dtype, tol):
    rs = np.random.RandomState(1)
    B, V, H, W, J, N = 2, 3, 24, 40, 5, 3000
    hm = rs.rand(B, V, H, W, J).astype(np.float32)
    g = _grid(rs, (B, V, N))
    bnd = (rs.rand(B, V, N) > 0.4).astype(np.float32)
    bnd[:, :, :50] = 0.0  # points seen by no view
    want = np.asarray(sample_and_aggregate_cmajor(jnp.asarray(hm), jnp.asarray(g), jnp.asarray(bnd)))
    px, py = to_pixels(torch.from_numpy(g), (W, H))
    got = sample_views_mean(torch.from_numpy(hm), px, py, torch.from_numpy(bnd), out_dtype)
    assert got.shape == (B, N, J) and got.dtype == out_dtype
    np.testing.assert_allclose(got.float().numpy(), want.transpose(0, 2, 1), atol=tol)
    assert (got[:, :50] == 0).all()


def _slices(B, S, X, Y):
    """Affine voxel-slice lattices in heatmap pixels, steep and shallow,
    crossing the image border (the fixtures of tests/test_slicewarp.py)."""
    u, v = np.mgrid[0:X, 0:Y].astype(np.float32)
    xs = np.zeros((B, S, X, Y), np.float32)
    ys = np.zeros((B, S, X, Y), np.float32)
    for s in range(S):
        if s < S // 2:
            xs[:, s] = 5 + 2.8 * v + 0.1 * u + 2 * s
            ys[:, s] = -2 + 1.5 * u + 0.1 * v + s
        else:
            xs[:, s] = 10 + 0.2 * v + 0.3 * u + s
            ys[:, s] = 3 + 3.0 * v + s
    return xs, ys


@pytest.mark.parametrize("table_dtype, tol", [(None, 1e-5), (jnp.bfloat16, 4e-3)])
def test_sample_view_matches_slice_warp_kernel_where_ok(table_dtype, tol):
    rs = np.random.RandomState(2)
    B, H, W, J, S, X, Y = 1, 64, 96, 5, 4, 16, 16
    hm = smooth_heatmap(rs, B, H, W, J)
    xs, ys = _slices(B, S, X, Y)
    flips = np.array([[0, 0, 1, 1]], np.int32)
    out, ok = sw.slice_warp_sample(jnp.asarray(hm), jnp.asarray(xs), jnp.asarray(ys),
                                   flip=jnp.asarray(flips), table_dtype=table_dtype)
    want = np.asarray(out, np.float32).transpose(0, 1, 3, 4, 2)  # (B, S, X, Y, J)
    ok = np.asarray(ok) > 0
    assert ok.mean() > 0.5
    got = sample_view(torch.from_numpy(hm), torch.from_numpy(xs.reshape(B, -1)),
                      torch.from_numpy(ys.reshape(B, -1))).numpy().reshape(B, S, X, Y, J)
    np.testing.assert_allclose(got[ok], want[ok], atol=tol)


@pytest.mark.parametrize("table_dtype, out_dtype, tol", [
    (None, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 4e-3)])
def test_sample_views_mean_matches_slice_warp_agg_kernel_where_ok(table_dtype, out_dtype, tol):
    rs = np.random.RandomState(3)
    B, V, H, W, J, S, X, Y = 1, 2, 64, 96, 5, 4, 16, 16
    hm = rs.rand(B, V, H, W, J).astype(np.float32)
    xs1, ys1 = _slices(B, S, X, Y)
    xs = np.stack([xs1, xs1 + 1.5], axis=1)  # (B, V, S, X, Y)
    ys = np.stack([ys1, ys1 + 0.5], axis=1)
    flips = np.broadcast_to(np.array([0, 0, 1, 1], np.int32), (B, V, S)).copy()
    bnd = (rs.rand(B, V, S, X, Y) > 0.3).astype(np.float32)
    ok = np.ones((B, S, X, Y), bool)
    for v in range(V):
        _, ok_v = sw.slice_warp_sample(jnp.asarray(hm[:, v]), jnp.asarray(xs[:, v]),
                                       jnp.asarray(ys[:, v]), flip=jnp.asarray(flips[:, v]))
        ok &= np.asarray(ok_v) > 0
    assert ok.mean() > 0.5
    mean, _ = sw.slice_warp_sample_agg(jnp.asarray(hm), jnp.asarray(xs), jnp.asarray(ys),
                                       jnp.asarray(bnd), jnp.asarray(flips),
                                       table_dtype=table_dtype)
    want = np.asarray(mean, np.float32)[:, :, :J].transpose(0, 1, 3, 4, 2)  # (B, S, X, Y, J)
    N = S * X * Y
    got = sample_views_mean(
        torch.from_numpy(hm), torch.from_numpy(xs.reshape(B, V, N)),
        torch.from_numpy(ys.reshape(B, V, N)), torch.from_numpy(bnd.reshape(B, V, N)), out_dtype,
    ).float().numpy().reshape(B, S, X, Y, J)
    np.testing.assert_allclose(got[ok], want[ok], atol=tol)


@pytest.fixture(scope="module")
def scene():
    cfg = small_cfg()
    branch, poses = make_synthetic_branch(cfg, batch_size=2, num_person=3, seed=2,
                                          with_images=False, device="cpu")
    return cfg, branch, poses


def _jax_cams(branch):
    from selfpose3d_tpu.geometry.cameras import CameraParams

    return CameraParams(**{k: jnp.asarray(getattr(branch.cam, k).numpy()) for k in "RTfckp"})


def test_unproject_heatmaps_matches_jax(scene):
    """RootNet's whole-space unprojection (one sample_view per view)."""
    cfg, br, _ = scene
    cube = (16, 16, 8)
    hm = br.input_heatmaps[..., 1:3].contiguous()
    grid = j_compute_grid(cfg.MULTI_PERSON.SPACE_SIZE,
                          jnp.asarray(cfg.MULTI_PERSON.SPACE_CENTER), cube)[None]
    want = np.asarray(j_unproject(
        jnp.asarray(hm.numpy()), grid, _jax_cams(br), jnp.asarray(br.trans.numpy()),
        (256, 128), jnp.asarray(br.orig_wh.numpy()), cube))
    got = unproject_heatmaps(hm, torch.from_numpy(np.array(grid)), br.cam, br.trans,
                             (256, 128), br.orig_wh, cube)
    assert got.shape == want.shape == (2, 16, 16, 8, 2)
    assert want.max() > 0.3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_sample_cubes_matches_jax(scene):
    """PoseNet's per-candidate cubes (one sample_views_mean launch)."""
    cfg, br, poses = scene
    B, K, X = 2, 3, 8
    centers = poses[:, :K, 2]  # (B, K, 3) roots
    grids = np.stack([np.stack([np.asarray(j_compute_grid((2000.0,) * 3, jnp.asarray(c), (X,) * 3))
                                for c in cb]) for cb in centers])  # (B, K, N, 3)
    flat = grids.reshape(B, 1, K * X ** 3, 3)
    hm = br.input_heatmaps
    sg, bnd = j_sample_grid(jnp.asarray(flat), _jax_cams(br), jnp.asarray(br.trans.numpy()),
                            (256, 128), (64, 32), orig_wh=jnp.asarray(br.orig_wh.numpy()))
    want = np.asarray(sample_and_aggregate_cmajor(jnp.asarray(hm.numpy()), sg, bnd))
    got = sample_cubes(hm, torch.from_numpy(grids.reshape(B, K * X ** 3, 3)), br.cam,
                       br.trans, (256, 128), br.orig_wh)
    assert want.max() > 0.3
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 2, 1), atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_count_nothing(monkeypatch):
    def no_library(name):
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(build, "library", no_library)
    before = dict(LAUNCHES)
    hm = torch.rand(1, 2, 8, 8, 3)
    px = torch.rand(1, 2, 10) * 7
    sample_view(hm[:, 0].contiguous(), px[:, 0].contiguous(), px[:, 1].contiguous())
    sample_views_mean(hm, px, px, torch.ones(1, 2, 10))
    assert LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "channels", "device"])
def test_wrappers_reject_bad_inputs(bad):
    hm, px, py = torch.rand(2, 8, 8, 3), torch.rand(2, 10), torch.rand(2, 10)
    if bad == "dtype":
        with pytest.raises(TypeError):
            sample_view(hm.double(), px, py)
    elif bad == "shape":
        with pytest.raises(ValueError):
            sample_view(hm, px, py[:1])
    elif bad == "channels":
        with pytest.raises(ValueError):
            sample_view(torch.rand(2, 8, 8, tsw.MAX_CHANNELS + 1), px, py)
    else:  # neither CPU nor CUDA: raise, never fall back
        with pytest.raises(ValueError, match="device"):
            sample_view(hm.to("meta"), px.to("meta"), py.to("meta"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.library("slicewarp")
    finally:
        build.library.cache_clear()
    assert build.library_path("slicewarp").name.startswith("libslicewarp-")
