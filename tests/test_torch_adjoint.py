"""The adjoint of the per-view sampler: the port's plain version (what a
CPU tensor gets, and what the CUDA kernel is held to on the card) against
the JAX package's scatter backward and ``jax.grad`` of its exact gather
sampler. All tolerances are float32 round-off of sums of a few hundred
terms: atol 1e-5."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import selfpose3d_tpu.ops.slicewarp as sw
from selfpose3d_tpu.ops.sampling import grid_sample_bilinear

from selfpose3d_tpu_torch.ops.sampling import bilinear_sample
from selfpose3d_tpu_torch.ops.slicewarp import (
    LAUNCHES,
    sample_view,
    sample_view_adjoint,
    sample_view_adjoint_plain,
    sample_views_mean,
)
from selfpose3d_tpu_torch.ops.unproject import to_pixels


def _inputs(seed, B, S, X, Y, H, W, J):
    """Normalised coords in [-1.1, 1.1] with a quarter snapped to texel
    centers and borders, the first points pinned to the top/left edge
    (y0 = x0 = -1) and far outside the image; a seeded cotangent."""
    rs = np.random.RandomState(seed)
    grid = rs.uniform(-1.1, 1.1, (B, S * X * Y, 2)).astype(np.float32)
    snap = rs.rand(B, S * X * Y) < 0.25
    grid[snap] = np.round(grid[snap] * 4) / 4
    px, py = (t.numpy() for t in to_pixels(torch.from_numpy(grid), (W, H)))
    px[:, 0], py[:, 0] = -0.5, -0.25      # only the (1, 1) tap is in the image
    px[:, 1], py[:, 1] = W - 0.5, H - 0.5  # only the (0, 0) tap
    px[:, 2], py[:, 2] = -3.0, 2.0         # no tap
    px[:, 3], py[:, 3] = 0.0, 0.0          # a corner texel, weight 1
    g = rs.randn(B, S * X * Y, J).astype(np.float32)
    return px, py, g


@pytest.mark.parametrize("J", [1, 15])
def test_adjoint_plain_matches_jax_scatter_backward(J):
    B, S, X, Y, H, W = 2, 3, 8, 10, 12, 20
    px, py, g = _inputs(J, B, S, X, Y, H, W, J)
    xs, ys = (jnp.asarray(a.reshape(B, S, X, Y)) for a in (px, py))
    g_j = jnp.asarray(g.reshape(B, S, X, Y, J).transpose(0, 1, 4, 2, 3))  # (B, S, J, X, Y)
    res = (jnp.zeros((0, H, W, J), jnp.float32), xs, ys,
           jnp.zeros((B, S), jnp.int32), jnp.ones((B, S, X, Y), jnp.float32))
    assert not sw._use_pallas_bwd()  # the scatter branch, not the TPU kernel
    want = np.asarray(sw._slice_warp_bwd(res, (g_j, None))[0])
    before = dict(LAUNCHES)
    got = sample_view_adjoint(torch.from_numpy(g), torch.from_numpy(px), torch.from_numpy(py),
                              (H, W))
    assert LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert got.shape == (B, H, W, J) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.abs(want).max() > 1.0


def _case_coords(case, B, S, X, Y, H, W):
    """Pixel coordinates of the card kernel's branches, on the CPU: every
    point in one texel; consecutive points sweeping across the image's
    left and right edges; a zero cotangent on every other block of 7."""
    n = np.arange(S * X * Y, dtype=np.float32)
    if case == "one_texel":
        px, py = np.full_like(n, 3.3), np.full_like(n, 2.6)
    else:
        u = (n % 16) / 16
        run = n // 16
        px = np.where(run % 2 == 0, -3 + 6 * u, W - 3 + 6 * u)
        py = run % (H + 4) - 2 + 0.25 * u
    return (np.broadcast_to(px, (B, px.size)).astype(np.float32).copy(),
            np.broadcast_to(py, (B, py.size)).astype(np.float32).copy())


@pytest.mark.parametrize("case", ["one_texel", "edges", "half_zero"])
def test_adjoint_plain_matches_jax_scatter_backward_cases(case):
    """The plain adjoint (what the kernel is held to) against the JAX
    package's scatter backward on the point patterns that pick the card
    kernel's branches."""
    B, S, X, Y, H, W, J = 2, 3, 8, 10, 12, 20, 15  # the shapes above: one JAX compile
    px, py = _case_coords(case, B, S, X, Y, H, W)
    g = np.random.RandomState(7).randn(B, S * X * Y, J).astype(np.float32)
    if case == "half_zero":
        g[:, (np.arange(S * X * Y) // 7) % 2 == 0] = 0.0
    xs, ys = (jnp.asarray(a.reshape(B, S, X, Y)) for a in (px, py))
    g_j = jnp.asarray(g.reshape(B, S, X, Y, J).transpose(0, 1, 4, 2, 3))
    res = (jnp.zeros((0, H, W, J), jnp.float32), xs, ys,
           jnp.zeros((B, S), jnp.int32), jnp.ones((B, S, X, Y), jnp.float32))
    want = np.asarray(sw._slice_warp_bwd(res, (g_j, None))[0])
    got = sample_view_adjoint(torch.from_numpy(g), torch.from_numpy(px), torch.from_numpy(py),
                              (H, W))
    # float32 sums of up to 4*240 terms into one texel: 1e-6 of the peak
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(want).max())
    assert np.abs(want).max() > 1.0


@pytest.mark.parametrize("J", [1, 15])
def test_sample_view_backward_matches_jax_grad_of_exact_gather(J):
    """loss = <sample(hm), g>: d loss / d hm through the port's
    autograd.Function against jax.grad of the exact gather sampler."""
    B, S, X, Y, H, W = 2, 2, 6, 9, 10, 16
    px, py, g = _inputs(10 + J, B, S, X, Y, H, W, J)
    hm = np.random.RandomState(3).rand(B, H, W, J).astype(np.float32)
    grid = np.stack([px / (W - 1) * 2 - 1, py / (H - 1) * 2 - 1], -1).astype(np.float32)

    def loss(h):
        s = jax.vmap(grid_sample_bilinear)(h, jnp.asarray(grid))  # (B, N, J)
        return jnp.sum(s * jnp.asarray(g))

    want = np.asarray(jax.grad(loss)(jnp.asarray(hm)))
    # pixel coords recomputed from the normalised grid, as the JAX sampler does
    tpx, tpy = to_pixels(torch.from_numpy(grid), (W, H))
    h = torch.from_numpy(hm).requires_grad_()
    tpx.requires_grad_()
    tpy.requires_grad_()
    (sample_view(h, tpx, tpy) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(h.grad.numpy(), want, atol=1e-5)
    assert tpx.grad is None and tpy.grad is None  # coordinates get no gradient


def test_adjoint_inner_product_identity_float64():
    """<sample(h), g> == <h, adjoint(g)> to float64 round-off, and the
    adjoint equals autograd's derivative of the plain sampler."""
    B, H, W, J, N = 2, 9, 13, 4, 500
    rs = np.random.RandomState(5)
    h = torch.from_numpy(rs.randn(B, H, W, J)).requires_grad_()
    g = torch.from_numpy(rs.randn(B, N, J))
    px = torch.from_numpy(rs.uniform(-1.5, W + 0.5, (B, N)))
    py = torch.from_numpy(rs.uniform(-1.5, H + 0.5, (B, N)))
    s = bilinear_sample(h, px, py)
    adj = sample_view_adjoint_plain(g, px, py, (H, W))
    lhs, rhs = float((s * g).sum().detach()), float((h * adj).sum().detach())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
    (auto,) = torch.autograd.grad((s * g).sum(), h)
    torch.testing.assert_close(adj, auto, rtol=0, atol=1e-12)


def test_sample_view_finite_difference_spot_check():
    rs = np.random.RandomState(6)
    B, H, W, J, N = 1, 6, 7, 2, 40
    hm = rs.rand(B, H, W, J).astype(np.float32)
    px = torch.from_numpy(rs.uniform(-1, W, (B, N)).astype(np.float32))
    py = torch.from_numpy(rs.uniform(-1, H, (B, N)).astype(np.float32))
    g = torch.from_numpy(rs.randn(B, N, J).astype(np.float32))
    h = torch.from_numpy(hm).requires_grad_()
    (sample_view(h, px, py) * g).sum().backward()
    for (y, x, j) in [(0, 0, 0), (3, 4, 1), (5, 6, 0)]:
        d = torch.zeros_like(h)
        d[0, y, x, j] = 1.0
        with torch.no_grad():  # the sampler is linear in hm: a unit step is exact
            fd = ((sample_view(h + d, px, py) - sample_view(h, px, py)) * g).sum()
        assert abs(float(fd) - float(h.grad[0, y, x, j])) <= 1e-5


def test_fused_sampler_is_inference_only():
    hm = torch.rand(1, 2, 6, 8, 3, requires_grad=True)
    c = torch.rand(1, 2, 10) * 5
    with pytest.raises(RuntimeError, match="inference-only"):
        sample_views_mean(hm, c, c, torch.ones(1, 2, 10))
    with torch.no_grad():
        assert sample_views_mean(hm, c, c, torch.ones(1, 2, 10)).shape == (1, 10, 3)


def test_adjoint_rejects_wrong_dtype_and_shape():
    g = torch.zeros(1, 5, 3)
    c = torch.zeros(1, 5)
    with pytest.raises(TypeError):
        sample_view_adjoint(g.double(), c, c, (4, 4))
    with pytest.raises(ValueError):
        sample_view_adjoint(g, c[:, :4], c, (4, 4))
