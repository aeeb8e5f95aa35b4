"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
GPU). Imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import json

import numpy as np
import pytest
import torch

from selfpose3d_tpu_torch.microbench import conv3, primitives, sw_variants
from selfpose3d_tpu_torch.ops import build
from selfpose3d_tpu_torch.ops.slicewarp import (
    LAUNCHES,
    sample_view,
    sample_view_adjoint,
    sample_view_adjoint_plain,
    sample_view_plain,
    sample_views_mean,
    sample_views_mean_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _coords(g, shape, W, H, dev):
    """Pixel coords spanning the clipped normalised range [-1.1, 1.1]."""
    px = (torch.rand(shape, generator=g, device=dev) * 2.2 - 1.1 + 1) * 0.5 * (W - 1)
    py = (torch.rand(shape, generator=g, device=dev) * 2.2 - 1.1 + 1) * 0.5 * (H - 1)
    return px, py


def _identity_bar(hm, px, py, cot):
    """The bar of the inner-product identity <sample_view(h), g> ==
    <h, adjoint(g)>: 1e-5 of the float64 sum of |w_tap * h * g| over all
    points, taps and channels. Each float32 atomic add into a texel errs by
    at most half an ulp of a partial sum no larger than that texel's sum of
    |terms|, so the adjoint's error in <h, adjoint(g)> is at most about
    (adds a texel) * 6e-8 of this sum, in whatever order the adds come;
    the identity's own sum may cancel far below it (12.05 at the edge case
    with J = 15, where 1e-5 of it was the size of that noise)."""
    terms = sample_view_plain(hm.double().abs(), px, py) * cot.double().abs()
    return 1e-5 * float(terms.sum())


@pytest.mark.parametrize("J", [1, 3, 15, 32])
def test_sample_view_kernel_matches_plain(cuda, J):
    g = torch.Generator(device=cuda).manual_seed(J)
    B, H, W, N = 2, 40, 72, 5000
    hm = torch.rand(B, H, W, J, generator=g, device=cuda)
    px, py = _coords(g, (B, N), W, H, cuda)
    before = LAUNCHES["sample_view"]
    got = sample_view(hm, px, py)
    torch.cuda.synchronize()
    assert LAUNCHES["sample_view"] == before + 1
    torch.testing.assert_close(got, sample_view_plain(hm, px, py), rtol=0, atol=1e-5)


@pytest.mark.parametrize("out_dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 4e-3)])
def test_sample_views_mean_kernel_matches_plain(cuda, out_dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, V, H, W, J, N = 2, 5, 40, 72, 15, 5000
    hm = torch.rand(B, V, H, W, J, generator=g, device=cuda)
    px, py = _coords(g, (B, V, N), W, H, cuda)
    bnd = (torch.rand(B, V, N, generator=g, device=cuda) > 0.3).float()
    bnd[:, :, :10] = 0
    before = LAUNCHES["sample_views_mean"]
    got = sample_views_mean(hm, px, py, bnd, out_dtype)
    torch.cuda.synchronize()
    assert LAUNCHES["sample_views_mean"] == before + 1
    assert got.dtype == out_dtype and got.shape == (B, N, J)
    want = sample_views_mean_plain(hm, px, py, bnd, out_dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


# a forward block's run of points (csrc/slicewarp.cu kFwdRun; launch_views
# halves it where the run's shared memory would pass 48 KB, as at J = 32, V = 5)
FWD_RUN = 256
# one less than a run, a run, one more, and a prime number of runs' worth
EDGE_N = [FWD_RUN - 1, FWD_RUN, FWD_RUN + 1, 4099]
EDGE_J = [1, 4, 15, 17, 32]


def _edge_coords(g, shape, W, H, dev):
    """Coordinates of ``_coords``, different for every leading index, with
    the edge cases at points 0-5: wholly outside (left-above, right, below),
    exactly on the last texel (only tap 0 in the image), taps on the last
    row and column, and only tap 3 in the image."""
    px, py = _coords(g, shape, W, H, dev)
    edges = [(-3.0, -3.0), (W + 2.0, 0.5 * H), (0.5 * W, H + 0.75), (W - 1.0, H - 1.0),
             (W - 1.5, H - 1.25), (-0.5, -0.5)]
    for i, (x, y) in enumerate(edges[:shape[-1]]):
        px[..., i], py[..., i] = x, y
    return px, py


@pytest.mark.parametrize("N", EDGE_N)
@pytest.mark.parametrize("J", EDGE_J)
def test_sample_view_kernel_edges(cuda, J, N):
    """Runs cut at the batch element's end, B = 3 with different points
    each, points outside the image and taps on its last row and column,
    J = 1 (one thread a point) and J not a multiple of 4 (vector stores
    with a ragged head and tail): against the plain version, 1e-5."""
    g = torch.Generator(device=cuda).manual_seed(100 * J + N)
    B, H, W = 3, 40, 72
    hm = torch.rand(B, H, W, J, generator=g, device=cuda)
    px, py = _edge_coords(g, (B, N), W, H, cuda)
    before = LAUNCHES["sample_view"]
    got = sample_view(hm, px, py)
    torch.cuda.synchronize()
    assert LAUNCHES["sample_view"] == before + 1
    want = sample_view_plain(hm, px, py)
    assert not bool(want[:, :3].any())  # the points wholly outside
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("out_dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("V", [1, 5])
@pytest.mark.parametrize("J", EDGE_J)
def test_sample_views_mean_kernel_edges(cuda, J, V, out_dtype, tol):
    """The views kernel at every N of ``EDGE_N`` (runs cut at the batch
    element's end), B = 3 with different points each, points outside the
    image, taps on its last row and column, a point whose bounding weights
    sum to 0 (its mean is 0), J padded to a multiple of 4 (1, 15, 17) or
    not (4, 32): against the plain version with the bars of the main path."""
    B, H, W = 3, 40, 72
    g = torch.Generator(device=cuda).manual_seed(10 * J + V)
    hm = torch.rand(B, V, H, W, J, generator=g, device=cuda)
    for N in EDGE_N:
        px, py = _edge_coords(g, (B, V, N), W, H, cuda)
        bnd = (torch.rand(B, V, N, generator=g, device=cuda) > 0.3).float()
        bnd[..., 6] = 0.0  # no view sees point 6
        bnd[..., 7] = 1.0
        before = LAUNCHES["sample_views_mean"]
        got = sample_views_mean(hm, px, py, bnd, out_dtype)
        torch.cuda.synchronize()
        assert LAUNCHES["sample_views_mean"] == before + 1
        assert got.dtype == out_dtype and got.shape == (B, N, J)
        want = sample_views_mean_plain(hm, px, py, bnd, out_dtype)
        assert not bool(got[:, 6].any())
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("J", [4, 8, 32])
def test_forward_kernels_read_a_misaligned_view(cuda, J, mean):
    """A contiguous heatmap view that starts one float past a 16-byte
    boundary, J a multiple of 4: the kernels cannot take its texel rows as
    16-byte loads, so the entry asks for the padded copy and reads that
    (an aligned tensor is read as it is). Against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(J + mean)
    B, V, H, W, N = 2, (5 if mean else 1), 40, 72, 1000
    shape = (B, V, H, W, J) if mean else (B, H, W, J)
    hm = torch.rand(1 + B * V * H * W * J, generator=g, device=cuda)[1:].view(shape)
    assert hm.is_contiguous() and hm.data_ptr() % 16 != 0
    lib = build.library("slicewarp")
    assert lib.sp3d_forward_scratch_floats(hm.data_ptr(), int(mean), B, V, H, W, J) == hm.numel()
    aligned = hm.clone()
    assert lib.sp3d_forward_scratch_floats(aligned.data_ptr(), int(mean), B, V, H, W, J) == 0
    if mean:
        px, py = _coords(g, (B, V, N), W, H, cuda)
        bnd = (torch.rand(B, V, N, generator=g, device=cuda) > 0.3).float()
        got = sample_views_mean(hm, px, py, bnd)
        want = sample_views_mean_plain(hm, px, py, bnd)
    else:
        px, py = _coords(g, (B, N), W, H, cuda)
        got = sample_view(hm, px, py)
        want = sample_view_plain(hm, px, py)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("J", [1, 3, 15, 32])
def test_sample_view_adjoint_kernel_matches_plain(cuda, J):
    """Float atomics add in any order: the tolerance is 1e-5 of the largest
    heatmap gradient (sums of some hundred terms per texel)."""
    g = torch.Generator(device=cuda).manual_seed(J)
    B, H, W, N = 2, 40, 72, 200_000
    px, py = _coords(g, (B, N), W, H, cuda)
    px[:, 0], py[:, 0] = -0.5, -0.25  # top/left edge: only the (1, 1) tap lands
    cot = torch.randn(B, N, J, generator=g, device=cuda)
    cot[:, 100:200] = 0.0  # zero cotangents are skipped, not added
    before = LAUNCHES["sample_view_adjoint"]
    got = sample_view_adjoint(cot, px, py, (H, W))
    torch.cuda.synchronize()
    assert LAUNCHES["sample_view_adjoint"] == before + 1
    want = sample_view_adjoint_plain(cot.double(), px, py, (H, W))
    assert got.shape == (B, H, W, J) and got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_sample_view_adjoint_inner_product_identity(cuda):
    """<sample_view(h), g> == <h, adjoint(g)>: the backward kernel is the
    transpose of the forward kernel."""
    g = torch.Generator(device=cuda).manual_seed(0)
    B, H, W, J, N = 2, 40, 72, 15, 100_000
    hm = torch.rand(B, H, W, J, generator=g, device=cuda)
    px, py = _coords(g, (B, N), W, H, cuda)
    cot = torch.rand(B, N, J, generator=g, device=cuda)
    lhs = float((sample_view(hm, px, py).double() * cot.double()).sum())
    rhs = float((hm.double() * sample_view_adjoint(cot, px, py, (H, W)).double()).sum())
    assert abs(lhs - rhs) <= _identity_bar(hm, px, py, cot)


def test_sample_view_backward_launches_the_adjoint(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    B, H, W, J, N = 2, 24, 40, 15, 30_000
    hm = torch.rand(B, H, W, J, generator=g, device=cuda, requires_grad=True)
    px, py = _coords(g, (B, N), W, H, cuda)
    px.requires_grad_()
    cot = torch.randn(B, N, J, generator=g, device=cuda)
    before = dict(LAUNCHES)
    out = sample_view(hm, px, py)
    # a strided cotangent: the backward makes it contiguous for the kernel
    out.backward(cot.transpose(0, 1).contiguous().transpose(0, 1))
    torch.cuda.synchronize()
    assert LAUNCHES["sample_view"] == before["sample_view"] + 1
    assert LAUNCHES["sample_view_adjoint"] == before["sample_view_adjoint"] + 1
    assert px.grad is None  # coordinates get no gradient
    want = sample_view_adjoint_plain(cot, px.detach(), py, (H, W))
    torch.testing.assert_close(hm.grad, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    # no backward launch when the heatmap needs no gradient
    sample_view(hm.detach(), px.detach(), py).sum()
    assert LAUNCHES["sample_view_adjoint"] == before["sample_view_adjoint"] + 1


def test_cuda_samplers_reject_what_the_kernels_do_not_take(cuda):
    hm = torch.rand(1, 8, 8, 3, device=cuda)
    c = torch.rand(1, 10, device=cuda)
    cot = torch.rand(1, 10, 3, device=cuda)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        sample_view_adjoint(cot.transpose(1, 2).contiguous().transpose(1, 2), c, c, (8, 8))
    with pytest.raises(TypeError, match="float32"):
        sample_view_adjoint(cot.double(), c.double(), c.double(), (8, 8))
    with pytest.raises(ValueError, match="several devices"):
        sample_view_adjoint(cot, c.cpu(), c, (8, 8))
    with pytest.raises(RuntimeError, match="inference-only"):
        sample_views_mean(hm[:, None].requires_grad_(), c[:, None], c[:, None], c[:, None])
    assert LAUNCHES == before


def test_cuda_tensor_raises_when_library_unbuilt(cuda, monkeypatch):
    def unbuilt(name):
        raise RuntimeError(f"lib{name} is not built")

    monkeypatch.setattr(build, "library", unbuilt)
    before = dict(LAUNCHES)
    hm = torch.rand(1, 8, 8, 1, device=cuda)
    px = torch.rand(1, 10, device=cuda)
    with pytest.raises(RuntimeError, match="not built"):
        sample_view(hm, px, px)
    with pytest.raises(RuntimeError, match="not built"):
        sample_views_mean(hm[:, None], px[:, None], px[:, None], px[:, None])
    with pytest.raises(RuntimeError, match="not built"):
        sample_view_adjoint(torch.rand(1, 10, 1, device=cuda), px, px, (8, 8))
    assert LAUNCHES == before


def test_do_inference_on_card_matches_cpu(cuda):
    """A small float32 model: the card (kernels, cuDNN, TF32 off) against
    the CPU (plain samplers), same seeded weights and scene."""
    from chip_smoke import randomize, small_cfg
    from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
    from selfpose3d_tpu_torch.models import get_model

    cfg = small_cfg()
    cpu = randomize(get_model(cfg, device="cpu"), seed=3)
    gpu = get_model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    br, _ = make_synthetic_branch(cfg, batch_size=2, num_person=3, seed=1,
                                  with_images=True, device="cpu")
    pc, hc, gc = cpu.do_inference(br)
    pg, hg, gg = (t.cpu() for t in gpu.do_inference(br.to(cuda)))
    torch.testing.assert_close(hg, hc, rtol=1e-4, atol=1e-4 * float(hc.abs().max()))
    torch.testing.assert_close(gg[..., 3], gc[..., 3], rtol=0, atol=0)
    torch.testing.assert_close(gg[..., :3], gc[..., :3], rtol=0, atol=1e-3)
    err = (pg[..., :3] - pc[..., :3]).norm(dim=-1)
    assert float(err.max()) < 1.0
    assert np.isfinite(pg.numpy()).all()


def test_train_step_on_card_moves_every_network(cuda):
    """Two SSV train steps of a small float32 model on the card: finite
    losses, launch counts per step, every sub-network updated."""
    from chip_smoke import TERMS, randomize, small_train_cfg, train_branches
    from selfpose3d_tpu_torch.models import get_model
    from selfpose3d_tpu_torch.train import create_train_state, make_ssv_train_step

    cfg = small_train_cfg()
    model = randomize(get_model(cfg, device="cpu"), seed=3).to(cuda)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model)
    step = make_ssv_train_step(model, train_posenet_stage=True, use_l1_stage=True)
    branches = train_branches(cfg, 2, seed=1, device=cuda)
    gen = torch.Generator().manual_seed(0)
    V = cfg.DATASET.CAMERA_NUM
    for _ in range(2):
        start = dict(LAUNCHES)
        metrics = step(state, *branches, generator=gen)
        torch.cuda.synchronize()
        assert LAUNCHES["sample_view"] == start["sample_view"] + 3 * V
        assert LAUNCHES["sample_view_adjoint"] == start["sample_view_adjoint"] + V
        assert LAUNCHES["sample_views_mean"] == start["sample_views_mean"]
        assert set(TERMS) <= set(metrics)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    after = model.state_dict()
    for net in ("backbone", "attn", "root_net", "pose_net"):
        assert any(not torch.equal(after[k], v) for k, v in before.items()
                   if k.startswith(net + ".") and k.endswith("weight")), net
    # no gradient to carry: the same losses sample PoseNet's cubes in one launch
    start = dict(LAUNCHES)
    with torch.no_grad():
        model.ssv_losses(*branches, train_posenet_stage=True, use_l1_stage=True, generator=gen)
    assert LAUNCHES["sample_view"] == start["sample_view"] + 2 * V
    assert LAUNCHES["sample_view_adjoint"] == start["sample_view_adjoint"]
    assert LAUNCHES["sample_views_mean"] == start["sample_views_mean"] + 1


@pytest.mark.parametrize("shape, co", [((2, 8, 12, 16, 16), 32), ((1, 5, 7, 32, 32), 16),
                                       ((1, 4, 4, 16, 48), 128)])
def test_conv3_kernel_matches_plain(cuda, shape, co):
    """Within one bf16 ulp of the plain version (the same float32 products
    summed in another order before the one rounding); odd X and Y edges."""
    g = torch.Generator(device=cuda).manual_seed(co)
    x = torch.rand(shape, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.rand((3, 3, 3, shape[-1], co), generator=g, device=cuda) * 0.01).to(torch.bfloat16)
    before = conv3.LAUNCHES["conv3"]
    got = conv3.conv3(x, w).float()
    torch.cuda.synchronize()
    assert conv3.LAUNCHES["conv3"] == before + 1
    want = conv3.conv3_plain(x, w).float()
    diff = (got - want).abs()
    assert bool((diff <= conv3.bf16_ulp(torch.maximum(got.abs(), want.abs()))).all())
    assert float((diff == 0).float().mean()) >= 0.99
    with pytest.raises(ValueError, match="multiples of 16"):
        conv3.conv3(x[..., :8].contiguous(), w[:, :, :, :8].contiguous())


# (CI, Z): Z = 48 leaves a partial 64-voxel tile a row, Z = 32 half a tile
CONV3_Z = {16: 48, 32: 64, 64: 32}


@pytest.mark.parametrize("ci", [16, 32, 64])
@pytest.mark.parametrize("co", [16, 32, 64, 128])
def test_conv3_kernel_channel_grid(cuda, ci, co):
    """Every CO the kernel takes against CI 16, 32 and 64 at B = 1: Y = 5 is
    not a multiple of any step's rows, and the input is nonzero on every
    face of the volume (x in [0.5, 1.5)), so every zero-filled halo tap
    counts; within one bf16 ulp of the plain version, >= 99 % equal."""
    g = torch.Generator(device=cuda).manual_seed(ci * 1000 + co)
    shape = (1, 3, 5, CONV3_Z[ci], ci)
    x = (torch.rand(shape, generator=g, device=cuda) + 0.5).to(torch.bfloat16)
    w = (torch.rand((3, 3, 3, ci, co), generator=g, device=cuda) * 0.01).to(torch.bfloat16)
    before = conv3.LAUNCHES["conv3"]
    got = conv3.conv3(x, w).float()
    torch.cuda.synchronize()
    assert conv3.LAUNCHES["conv3"] == before + 1
    want = conv3.conv3_plain(x, w).float()
    diff = (got - want).abs()
    assert bool((diff <= conv3.bf16_ulp(torch.maximum(got.abs(), want.abs()))).all())
    assert float((diff == 0).float().mean()) >= 0.99


def _adjoint_case(case, g, B, N, H, W, J, dev):
    """Coordinates and cotangent of one adjoint scenario (see the test)."""
    n = torch.arange(N, device=dev, dtype=torch.float32).expand(B, N)
    if case == "one_texel":
        px, py = torch.full((B, N), 10.3, device=dev), torch.full((B, N), 5.7, device=dev)
    elif case == "edge":
        u = (n % 512) / 512
        run = torch.div(n, 512, rounding_mode="floor")
        px = torch.where(run % 2 == 0, -6 + 12 * u, W - 6 + 12 * u)
        py = run % (H + 8) - 4 + 0.25 * u
    else:  # spread over the whole image and around it
        px = torch.rand(B, N, generator=g, device=dev) * (W + 4) - 2
        py = torch.rand(B, N, generator=g, device=dev) * (H + 4) - 2
    cot = torch.randn(B, N, J, generator=g, device=dev)
    if case == "all_zero":
        cot.zero_()
    elif case == "half_zero":
        cot[(torch.div(n, 700, rounding_mode="floor") % 2 == 0)] = 0.0
    return px.contiguous(), py.contiguous(), cot


@pytest.mark.parametrize("J", [1, 3, 15, 32])
@pytest.mark.parametrize("case", ["one_texel", "spread", "edge", "all_zero", "half_zero"])
def test_sample_view_adjoint_kernel_cases(cuda, case, J):
    """The adjoint's branches: every point in one texel (the worst
    contention, one private tile), points spread over the whole image (the
    boxes do not fit: the direct path), runs that cross the image's edges,
    an all-zero cotangent (every run exits after its read) and one zero on
    every other 700 points (runs half zero). Against the inner-product
    identity (``_identity_bar``) and the float64 plain version (1e-5 of
    the largest gradient)."""
    g = torch.Generator(device=cuda).manual_seed(J)
    B, N, H, W = 2, 50_000, 128, 240
    px, py, cot = _adjoint_case(case, g, B, N, H, W, J, cuda)
    before = LAUNCHES["sample_view_adjoint"]
    got = sample_view_adjoint(cot, px, py, (H, W))
    torch.cuda.synchronize()
    assert LAUNCHES["sample_view_adjoint"] == before + 1
    if case == "all_zero":
        assert not bool(got.any())
        return
    hm = torch.rand(B, H, W, J, generator=g, device=cuda)
    lhs = float((sample_view(hm, px, py).double() * cot.double()).sum())
    rhs = float((hm.double() * got.double()).sum())
    assert abs(lhs - rhs) <= _identity_bar(hm, px, py, cot)
    want = sample_view_adjoint_plain(cot.double(), px, py, (H, W))
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("mode", sw_variants.MODES)
def test_sw_variant_kernel_matches_plain(cuda, mode):
    """All modes at the probe's row geometry on 2 x 16 slices, one row
    reversed (sgn = -1) and one unsorted; 1e-5 absolute (j1: channel 0)."""
    rng = np.random.default_rng(7)
    Bn, J, S, SB = 2, 3, 16, 8
    sh = (Bn, S // SB, SB, sw_variants.Xp, sw_variants.Yp)
    hm = rng.random((Bn, J, sw_variants.Wp, sw_variants.Hp), dtype=np.float32)
    xs = np.sort(rng.random(sh, dtype=np.float32) * np.float32(200), -1)
    xs[1, 1, 2, 7] = xs[1, 1, 2, 7, ::-1]
    xs[0, 0, 5, 3] = rng.permutation(xs[0, 0, 5, 3])
    ys = rng.random(sh, dtype=np.float32) * np.float32(100)
    hm, xs, ys = (torch.from_numpy(a).to(cuda) for a in (hm, xs, ys))
    before = sw_variants.LAUNCHES["sw_variant"]
    got = sw_variants.sw_variant(mode, hm, xs, ys)
    torch.cuda.synchronize()
    assert sw_variants.LAUNCHES["sw_variant"] == before + 1
    want = sw_variants.sw_variant_plain(mode, hm, xs, ys)
    ch = slice(0, 1) if mode == "j1" else slice(None)
    torch.testing.assert_close(got[:, :, :, ch], want[:, :, :, ch], rtol=0, atol=1e-5)


@pytest.mark.parametrize("body", list(primitives.BODIES))
def test_primitive_kernel_matches_plain(cuda, body):
    for reps in (1, 5, 200):
        x = primitives.make_input(body, cuda, seed=reps)
        before = primitives.LAUNCHES["primitive"]
        got = primitives.primitive(body, x, reps)
        torch.cuda.synchronize()
        assert primitives.LAUNCHES["primitive"] == before + 1
        assert torch.equal(got, primitives.primitive_plain(body, x, reps)), (body, reps)


SW_EDGE_J = [1, 3, 4, 15, 17]


def _sw_edge_inputs(J, seed):
    """B = 2, one group of SB = 3 slices of Xp = 5 slice rows (an odd count:
    the last band of a block's two rows holds one) at the probe's row
    geometry (Yp = 128, Wp x Hp = 256 x 128, a 240 x 128 image): xs up to
    1.2 W, so that x0c and x1c clamp at W - 1; ys in [-8, H + 8), so that
    tap rows clip at 0 and H - 1; one row reversed (sgn = -1) and one
    unsorted."""
    rng = np.random.default_rng(seed)
    sh = (2, 1, 3, 5, sw_variants.Yp)
    hm = rng.random((2, J, sw_variants.Wp, sw_variants.Hp), dtype=np.float32)
    xs = np.sort(rng.random(sh, dtype=np.float32) * np.float32(1.2 * sw_variants.W), -1)
    xs[1, 0, 2, 4] = xs[1, 0, 2, 4, ::-1]
    xs[0, 0, 1, 3] = rng.permutation(xs[0, 0, 1, 3])
    ys = rng.random(sh, dtype=np.float32) * np.float32(sw_variants.H + 16) - np.float32(8)
    return hm, xs, ys


@pytest.mark.parametrize("J", SW_EDGE_J)
@pytest.mark.parametrize("mode", sw_variants.MODES)
def test_sw_variant_kernel_edges(cuda, mode, J):
    """Every mode at J = 1 (one thread a point on the plane, no copy), J
    not a multiple of 4 (the padded channel-last copy with zero channels)
    and J = 4, 15, on the edge inputs of ``_sw_edge_inputs``: against the
    plain version, 1e-5 absolute (j1: channel 0, the only one it
    writes); the scratch the entry asks for is the padded copy's size."""
    hm, xs, ys = (torch.from_numpy(a).to(cuda) for a in _sw_edge_inputs(J, 10 * J + 1))
    mid = sw_variants.MODES.index(mode)
    Jp = (J + 3) // 4 * 4
    want_scratch = 0 if mode == "j1" or J == 1 else 2 * sw_variants.Wp * sw_variants.Hp * Jp
    lib = build.library("sw_variants")
    assert lib.sp3d_sw_scratch_floats(mid, 2, J, sw_variants.Wp, sw_variants.Hp) == want_scratch
    before = sw_variants.LAUNCHES["sw_variant"]
    got = sw_variants.sw_variant(mode, hm, xs, ys)
    torch.cuda.synchronize()
    assert sw_variants.LAUNCHES["sw_variant"] == before + 1
    want = sw_variants.sw_variant_plain(mode, hm, xs, ys)
    ch = slice(0, 1) if mode == "j1" else slice(None)
    torch.testing.assert_close(got[:, :, :, ch], want[:, :, :, ch], rtol=0, atol=1e-5)


def test_probe_kernels_raise_on_misaligned_or_strided_input(cuda):
    """A view one float past a 16-byte boundary, or a strided tensor, raises
    before any launch instead of being read wrongly."""
    Wp, Hp, Yp = sw_variants.Wp, sw_variants.Hp, sw_variants.Yp
    hm = torch.rand(1 + 2 * Wp * Hp, device=cuda)[1:].view(1, 2, Wp, Hp)
    xs = torch.rand(1, 1, 2, 4, Yp, device=cuda) * 200
    before = (dict(sw_variants.LAUNCHES), dict(primitives.LAUNCHES))
    assert hm.is_contiguous() and hm.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        sw_variants.sw_variant("full", hm, xs, xs)
    with pytest.raises(ValueError, match="contiguous"):
        sw_variants.sw_variant("full", torch.rand(1, 2, Hp, Wp, device=cuda).transpose(2, 3),
                               xs, xs)
    strided = (torch.rand(1, 1, 2, Yp, 4, device=cuda) * 200).transpose(3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        sw_variants.sw_variant("full", hm.clone(), strided, strided)
    for body, ((r, c), _, _) in primitives.BODIES.items():
        x = torch.rand(1 + r * c, device=cuda)[1:].view(r, c)
        with pytest.raises(ValueError, match="16-byte aligned"):
            primitives.primitive(body, x, 3)
        with pytest.raises(ValueError, match="contiguous"):
            primitives.primitive(body, torch.rand(c, r, device=cuda).t(), 3)
    assert (sw_variants.LAUNCHES, primitives.LAUNCHES) == before


@pytest.mark.parametrize("reps", [1, 2, 3, 7, 200, 401])
@pytest.mark.parametrize("body", list(primitives.BODIES))
def test_primitive_kernel_reps(cuda, body, reps):
    """Repetition counts below, at and past the kernel's unrolled group of
    4, with a tail of 1, 2 and 3: exactly the plain version."""
    x = primitives.make_input(body, cuda, seed=reps)
    before = primitives.LAUNCHES["primitive"]
    got = primitives.primitive(body, x, reps)
    torch.cuda.synchronize()
    assert primitives.LAUNCHES["primitive"] == before + 1
    assert torch.equal(got, primitives.primitive_plain(body, x, reps)), (body, reps)


@pytest.mark.parametrize("body", list(primitives.BODIES))
def test_primitive_kernel_every_band(cuda, body):
    """Every band the kernel takes (a thread 1 to 16 outputs, 8 to 256
    blocks) gives the plain version's result exactly, and the C entry takes
    exactly the bands of ``BAND_CHOICES``."""
    lib = build.library("microbench_primitives")
    bid = list(primitives.BODIES).index(body)
    x = primitives.make_input(body, cuda, seed=3)
    out = torch.empty(primitives.BODIES[body][1], device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    taken = [b for b in range(0, 65)
             if lib.sp3d_primitive(x.data_ptr(), out.data_ptr(), bid, 3, b, stream) == 0]
    torch.cuda.synchronize()
    assert taken == list(primitives.BAND_CHOICES[body])
    want = primitives.primitive_plain(body, x, 7)
    for band in primitives.BAND_CHOICES[body]:
        assert torch.equal(primitives.primitive(body, x, 7, band), want), (body, band)


def test_probe_kernels_raise_when_library_unbuilt(cuda, monkeypatch):
    def unbuilt(name):
        raise RuntimeError(f"lib{name} is not built")

    monkeypatch.setattr(build, "library", unbuilt)
    x = torch.zeros((1, 4, 4, 16, 16), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((3, 3, 3, 16, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="not built"):
        conv3.conv3(x, w)
    hm = torch.zeros((1, 1, sw_variants.Wp, sw_variants.Hp), device=cuda)
    xs = torch.zeros((1, 1, 1, 2, sw_variants.Yp), device=cuda)
    with pytest.raises(RuntimeError, match="not built"):
        sw_variants.sw_variant("full", hm, xs, xs)
    with pytest.raises(RuntimeError, match="not built"):
        primitives.primitive("gather", primitives.make_input("gather", cuda), 2)


@pytest.mark.parametrize("cotangent", ["dense", "inside_only"])
@pytest.mark.parametrize("view", [0, 3])
def test_whole_space_samplers_at_15_channels(cuda, view, cotangent):
    """The supervised RootNet's shapes: all 15 channels of (2, 128, 240)
    heatmaps sampled over the whole 80x80x20 space (B = 2, N = 128,000, the
    flagship cameras), through the channel-padded copy. The forward against
    the plain version (1e-5); the adjoint on a dense cotangent (loss_3d is
    an MSE over every voxel: no run of points is zero) and on one zero
    outside the view's image, against the float64 plain version (1e-5 of
    its largest entry) and the inner-product identity (``_identity_bar``)."""
    from chip_smoke import SUPERVISED_YAML, whole_space_points, yaml_cfg
    from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
    from selfpose3d_tpu_torch.models.root_net import RootNet

    cfg = yaml_cfg(SUPERVISED_YAML)
    W, H = cfg.NETWORK.HEATMAP_SIZE
    J = cfg.NETWORK.NUM_JOINTS
    br = make_synthetic_branch(cfg, batch_size=2, num_person=3, seed=0, device=cuda)[0]
    rn = RootNet(cfg.MULTI_PERSON.SPACE_SIZE, cfg.MULTI_PERSON.SPACE_CENTER,
                 cfg.MULTI_PERSON.INITIAL_CUBE_SIZE, cfg.NETWORK.IMAGE_SIZE)
    px, py, _, inside = whole_space_points(rn, br, (W, H), view)
    B, N = px.shape
    assert N == 80 * 80 * 20
    g = torch.Generator(device=cuda).manual_seed(10 * view + len(cotangent))
    hm = torch.rand(B, H, W, J, generator=g, device=cuda)
    lib = build.library("slicewarp")
    assert lib.sp3d_forward_scratch_floats(hm.data_ptr(), 0, B, 1, H, W, J) > 0
    before = dict(LAUNCHES)
    got = sample_view(hm, px, py)
    torch.cuda.synchronize()
    assert LAUNCHES["sample_view"] == before["sample_view"] + 1
    torch.testing.assert_close(got, sample_view_plain(hm, px, py), rtol=0, atol=1e-5)

    cot = torch.randn(B, N, J, generator=g, device=cuda)
    if cotangent == "inside_only":
        cot *= inside[..., None]
        assert 0 < float(inside.mean()) < 1
    dhm = sample_view_adjoint(cot, px, py, (H, W))
    torch.cuda.synchronize()
    assert LAUNCHES["sample_view_adjoint"] == before["sample_view_adjoint"] + 1
    want = sample_view_adjoint_plain(cot.double(), px, py, (H, W))
    torch.testing.assert_close(dhm.double(), want, rtol=0, atol=1e-5 * float(want.abs().max()))
    lhs = float((got.double() * cot.double()).sum())
    rhs = float((hm.double() * dhm.double()).sum())
    assert abs(lhs - rhs) <= _identity_bar(hm, px, py, cot)


def test_supervised_train_step_on_card_matches_cpu(cuda):
    """One supervised train step of the small float32 model (RootNet on all
    15 channels, a trainable backbone), GT moved onto its proposals, on the
    card against the same step on the CPU: the loss terms (rel 1e-3,
    batch-statistics BatchNorm), both samplers of RootNet and PoseNet with
    their adjoints launched once a view, and the same sub-networks moved."""
    from chip_smoke import gt_at_proposals, moved, randomize, small_supervised_cfg, snapshot
    from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
    from selfpose3d_tpu_torch.models import get_model
    from selfpose3d_tpu_torch.train import create_train_state, make_supervised_train_step

    cfg = small_supervised_cfg()
    V = cfg.DATASET.CAMERA_NUM
    cpu = randomize(get_model(cfg, device="cpu"), seed=3)
    gpu = get_model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    br = make_synthetic_branch(cfg, batch_size=2, num_person=3, seed=1, device="cpu")[0]
    br = gt_at_proposals(cpu, br, slots=((0, 0, 1), (0, 1, 3), (1, 2, 2)))
    out = {}
    for name, model, b in (("cpu", cpu, br), ("card", gpu, br.to(cuda))):
        before = snapshot(model)
        state = create_train_state(cfg, model)
        start = dict(LAUNCHES)
        metrics = make_supervised_train_step(model)(state, b)
        if name == "card":
            torch.cuda.synchronize()
            assert LAUNCHES["sample_view"] == start["sample_view"] + 2 * V
            assert LAUNCHES["sample_view_adjoint"] == start["sample_view_adjoint"] + 2 * V
            assert LAUNCHES["sample_views_mean"] == start["sample_views_mean"]
        out[name] = ({k: float(v) for k, v in metrics.items()}, moved(model, before))
    (lc, mc), (lg, mg) = out["cpu"], out["card"]
    assert set(lc) == set(lg) == {"loss_2d", "loss_3d", "loss_cord", "loss"}
    assert lc["loss_cord"] > 0
    for k in lc:
        assert abs(lg[k] - lc[k]) <= 1e-3 * abs(lc[k]), (k, lg[k], lc[k])
    assert mc == mg == ["backbone", "pose_net", "root_net"]


TERMS = ("loss_2d", "loss_root_syn", "loss_pose3d_ssv", "loss_pose3d_l1_ssv", "loss_root_reg")


def test_tiny_ssv_converges_on_card(cuda, tmp_path):
    """The JAX package's proof that SSV training learns
    (tests/test_convergence.py, its assertions), on the port's engine on the
    card: five epochs of configs/synthetic/tiny_ssv.yaml from random init."""
    from selfpose3d_tpu_torch.train.convergence import head_tail_means, run_convergence

    res = run_convergence("configs/synthetic/tiny_ssv.yaml", epochs=5,
                          out_path=str(tmp_path / "curves.json"), device="cuda")
    assert res["steps"] >= 150
    total_h, total_t = head_tail_means(res["series"]["train/loss"])
    assert total_t < 0.8 * total_h, (total_h, total_t)
    ratios = {}
    for term in TERMS:
        h, t = head_tail_means(res["series"][f"train/{term}"])
        ratios[term] = t / h
    dropped = [term for term, r in ratios.items() if r < 0.85]
    r0 = res["eval_init"].get("recall500_root", 0.0)
    r1 = res["eval_final"].get("recall500_root", 0.0)
    m0 = res["eval_init"].get("mpjpe_root", float("inf"))
    m1 = res["eval_final"].get("mpjpe_root", float("inf"))
    print("tiny_ssv 5 epochs on the card:", json.dumps({
        "steps": res["steps"], "seconds": res["seconds"], "total_head_tail": [total_h, total_t],
        "ratios": ratios,
        "dropped": dropped, "recall500_root": [r0, r1], "mpjpe_root": [m0, m1]}))
    assert len(dropped) >= 3, dropped
    assert (r1 > r0 + 0.04) or (m1 < 0.8 * m0), (r0, r1, m0, m1)


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """An SSV epoch on the card, saved and loaded into a fresh model and
    train state on the card: parameters, BatchNorm statistics, Adam moments,
    the schedule and the step bit-equal to the saved ones; the resumed state
    trains on (the adjoint's float atomics make the card's steps not
    bit-reproducible, so the step after resume is not compared)."""
    from selfpose3d_tpu_torch.config import load_config
    from selfpose3d_tpu_torch.data.synthetic_dataset import SyntheticSceneDataset
    from selfpose3d_tpu_torch.models import get_model
    from selfpose3d_tpu_torch.train import checkpoint as ckpt
    from selfpose3d_tpu_torch.train import create_train_state
    from selfpose3d_tpu_torch.train.loop import train_epoch_ssv

    cfg = load_config("configs/synthetic/tiny_ssv.yaml", overrides={"DEBUG": {"DEBUG": False}})
    ds = SyntheticSceneDataset(cfg, "train", num_frames=4)
    model = get_model(cfg, device=cuda, seed=0)
    state = create_train_state(cfg, model, 2)
    train_epoch_ssv(cfg, model, state, ds, epoch=0)
    ckpt.save_checkpoint(str(tmp_path), state, 1, 0.5, is_best=False)
    fresh = get_model(cfg, device=cuda, seed=1)
    resumed, epoch, _ = ckpt.load_checkpoint(str(tmp_path), create_train_state(cfg, fresh, 2))
    assert epoch == 1 and resumed.step == state.step == 2
    for k, v in model.state_dict().items():
        got = fresh.state_dict()[k]
        assert got.device == v.device and torch.equal(got, v), k
    saved, loaded = state.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert saved["param_groups"] == loaded["param_groups"]
    assert set(saved["state"]) == set(loaded["state"]) and saved["state"]
    for i, s in saved["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            got = loaded["state"][i][name]
            assert got.device == s[name].device and torch.equal(s[name], got), (i, name)
    assert resumed.scheduler.state_dict() == state.scheduler.state_dict()
    meters = {}
    train_epoch_ssv(cfg, fresh, resumed, ds, epoch=1, meters_out=meters)
    assert resumed.step == 4 and np.isfinite(meters["loss"].avg)


def test_realdata_epoch_and_validation_on_card(cuda, tmp_path, monkeypatch):
    """Phase realdata's path at a small width on the card: a panoptic_ssv
    epoch of cli.train_3d on cam5_posenet.yaml with the debug dumps, the
    panoptic validation and cli.evaluate --vis-attn over a mini Panoptic
    tree (3 train and 1 validation sequences, 960x540 views), with every
    sampler's launches a step, a debug dump and a validation batch as
    derived from the flags."""
    import chip_smoke
    from selfpose3d_tpu_torch import mini_panoptic
    from selfpose3d_tpu_torch.cli import train_3d
    from selfpose3d_tpu_torch.data import skeleton

    class Writer:
        def add_scalar(self, *a):
            pass

        def close(self):
            pass

    monkeypatch.setattr(train_3d, "TBWriter", lambda log_dir: Writer())
    monkeypatch.setattr(skeleton, "PANOPTIC_TRAIN_LIST", skeleton.PANOPTIC_TRAIN_LIST[:3])
    monkeypatch.setattr(skeleton, "PANOPTIC_VAL_LIST", skeleton.PANOPTIC_VAL_LIST[:1])
    small = {"NETWORK.IMAGE_SIZE": [192, 128], "NETWORK.HEATMAP_SIZE": [48, 32],
             "POSE_RESNET.NUM_LAYERS": 18, "ATTN_NUM_LAYERS": 18, "DTYPE": "float32",
             "MULTI_PERSON.INITIAL_CUBE_SIZE": [16, 16, 8], "PICT_STRUCT.CUBE_SIZE": [8, 8, 8],
             "WORKERS": 2}
    yaml_path = f"{chip_smoke.ROOT}/{chip_smoke.FLAGSHIP_YAML}"
    rep = mini_panoptic.run_realdata(str(tmp_path / "rd"), yaml_path, "cuda", small,
                                     image_wh=(960, 540))
    cfg = rep["cfg"]
    V, steps = cfg.DATASET.CAMERA_NUM, rep["epoch"]["steps"]
    assert steps == 3 and rep["dumps"] == 3
    got = rep["launches"]
    assert got["train"] == chip_smoke.times(chip_smoke.ssv_step_launches(cfg), steps), got
    assert got["debug"] == chip_smoke.times(chip_smoke.sampler_counts(V, 1, 0), 3), got
    assert got["validate"] == chip_smoke.sampler_counts(V, 1, 0), got
    assert got["evaluate"] == chip_smoke.sampler_counts(2 * V, 2, 0), got
    assert all(np.isfinite(m.avg) for k, m in rep["epoch"].items() if k.startswith("loss"))
    assert rep["dump_frames"] == 1 and len(rep["debug_files"]) == 9


@pytest.mark.parametrize("bn_eval", [False, True])
def test_ddp_world_size_1_step_equals_the_plain_step(cuda, tmp_path, bn_eval):
    """One SSV step of chip_smoke.small_train_cfg (float32) through DDP over
    nccl at world size 1 against the plain step on the card, both BatchNorm
    modes, held to parallel.check.BARS: the same work, but the adjoint
    kernel's atomic adds sum in any order, so two runs are not bit-equal."""
    import torch.distributed as dist

    import chip_smoke
    from selfpose3d_tpu_torch.parallel import check

    cfg = chip_smoke.small_train_cfg()
    branches = chip_smoke.train_branches(cfg, 1, seed=0, device="cpu")
    kw = dict(device="cuda", bn_eval=bn_eval, epoch=cfg.TRAIN.L1_EPOCH)
    plain = check.train_step_record(cfg, branches, **kw)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        ddp = check.train_step_record(cfg, branches, **kw)
    finally:
        dist.destroy_process_group()
    assert ddp["launches"] == plain["launches"] == chip_smoke.ssv_step_launches(cfg)
    bad = {k: v for k, v in check.failures(check.compare(ddp, plain), bn_eval).items() if v}
    assert not bad, bad


# ------------------------------------------ the port's spans and host syncs

SYNC_WARNING = "called a synchronizing CUDA operation"
# the benchmark's paths at its full widths, and the masked BatchNorm path small
SYNC_PATHS = [("ssv_infer", True), ("supervised_infer", True), ("ssv_train", True),
              ("ssv_train_masked", False)]


@pytest.fixture(scope="module")
def span_paths():
    """(model, call) of each path of tests/test_torch_spans.py on the card,
    built once and warmed up by three calls: an inference path's third call
    replays its stages' CUDA graphs (the first runs eager, the second
    captures), as every later one does."""
    from test_torch_spans import path_call  # tests/ is on the path of its modules

    built = {}

    def get(path, full):
        if (path, full) not in built:
            torch.manual_seed(0)
            model, call = path_call(path, "cuda", full)
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            built[(path, full)] = call
        return built[(path, full)]

    yield get
    built.clear()
    torch.cuda.empty_cache()


def _profiled_call(call, sync_debug):
    """One call while a device-only profiler records its spans -> (the
    summary's one root, the sync warnings PyTorch raised inside the call
    with ``sync_debug``)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from selfpose3d_tpu_torch.utils import spans

    spans.reset()
    with profile(activities=[ProfilerActivity.CUDA]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if sync_debug:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    summary = spans.summary()
    (root,) = summary["roots"]
    return root, summary, [w for w in caught if SYNC_WARNING in str(w.message)]


@pytest.mark.parametrize("path, full", SYNC_PATHS, ids=[p for p, _ in SYNC_PATHS])
def test_host_syncs_count_every_sync_of_a_call(cuda, span_paths, path, full):
    """The warnings of PyTorch's sync debug mode inside one call equal the
    call's ``host_syncs`` counters' change: the counters miss no sync."""
    from collections import Counter

    root, _, syncs = _profiled_call(span_paths(path, full), sync_debug=True)
    counted = {k: v for k, v in root["counts"].items() if k.startswith("host_syncs.")}
    where = Counter(f"{w.filename}:{w.lineno}" for w in syncs)
    print(json.dumps({"path": path, "warnings": len(syncs), "counted": counted,
                      "where": dict(where)}))
    assert len(syncs) == sum(counted.values()), (dict(where), counted)
    if path.endswith("_infer"):
        # the stages replay their graphs; the host waits at most for the
        # candidate bucket's read, where the configuration has buckets
        assert set(counted) <= {"host_syncs.posenet_bucket"}, counted
        assert _replays(root["counts"]) == 3, root["counts"]


@pytest.mark.parametrize("path", ["ssv_infer", "supervised_infer", "ssv_train"])
def test_stage_spans_cover_the_call_on_the_device(cuda, span_paths, path):
    """At full width the stages' device ms (the root span's children) cover
    at least 90 % of the call's."""
    root, summary, _ = _profiled_call(span_paths(path, True), sync_debug=False)
    from selfpose3d_tpu_torch.utils import spans

    recs = spans.records()
    stages = sum(r["device_ms"] for r in recs if r["parent"] == root["id"])
    print(json.dumps({"path": path, "call_device_ms": root["device_ms"],
                      "stages_device_ms": stages,
                      "spans": {k: round(v["device_ms"], 3) for k, v in summary["spans"].items()}}))
    assert summary["device_clock"] == "cuda_events"
    assert stages >= 0.9 * root["device_ms"], (stages, root["device_ms"])
    assert _replays(root["counts"]) == (3 if path.endswith("_infer") else 0), root["counts"]


def _replays(counts: dict) -> int:
    return sum(v for k, v in counts.items() if k.startswith("graphs.replays."))


# ------------------------------------------ the inference stages' CUDA graphs

def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.uint8)


def _same_bits(got, want) -> bool:
    return len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))
        for a, b in zip(got, want))


def _graph_case(cuda, monkeypatch, path: str, batch: int):
    """A small float32 model of ``path`` on the card (candidate buckets on),
    three distinct scenes at ``batch``, and its inference call graphed
    (``infer``) and eager (``eager``: every stage body called directly).
    cuDNN runs its deterministic algorithms: with its default ones two
    eager calls of one input already differ in the last bits."""
    from test_torch_spans import path_cfg

    from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
    from selfpose3d_tpu_torch.models import get_model
    from selfpose3d_tpu_torch.utils import graphs

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = path_cfg(path)
    torch.manual_seed(0)
    model = get_model(cfg, device=cuda, seed=0)
    scenes = [make_synthetic_branch(cfg, batch_size=batch, num_person=3, seed=s,
                                    with_images=True, device=cuda)[0] for s in range(3)]

    def infer(b):
        with torch.no_grad():
            return model.do_inference(b) if path == "ssv_infer" else model(b, train=False)[:3]

    def eager(b):
        with monkeypatch.context() as m:
            m.setattr(graphs, "run", lambda stage, module, fn, *args: fn(module, *args))
            return infer(b)

    return model, scenes, infer, eager


def _counted(call):
    """-> (call's outputs, its counters' changes)."""
    from selfpose3d_tpu_torch.utils import spans

    before = spans.counters()
    out = call()
    torch.cuda.synchronize()
    return out, spans.changes(before)


def _family(changes: dict, prefix: str) -> int:
    return sum(v for k, v in changes.items() if k.startswith(prefix))


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("path", ["ssv_infer", "supervised_infer"])
def test_graphed_inference_equals_eager_bit_for_bit(cuda, monkeypatch, path, batch):
    """Six calls over three distinct scenes in turn: the first runs eager,
    the second captures the three stages, every later one replays them;
    each call's outputs equal the eager call's bit for bit, its launch
    counters too, and an earlier call's outputs stay as they were."""
    model, scenes, infer, eager = _graph_case(cuda, monkeypatch, path, batch)
    want, want_launches = zip(*(_counted(lambda b=b: eager(b)) for b in scenes))
    assert all(_same_bits(eager(b), w) for b, w in zip(scenes, want))  # eager repeats itself
    got = []
    for i in range(6):
        out, changes = _counted(lambda: infer(scenes[i % 3]))
        got.append(out)
        assert _same_bits(out, want[i % 3]), i
        assert _family(changes, "graphs.captures.") == (3 if i == 1 else 0), (i, changes)
        assert _family(changes, "graphs.replays.") == (0 if i == 0 else 3), (i, changes)
        launches = {k: v for k, v in changes.items() if k.startswith("launches.")}
        assert launches == {k: v for k, v in want_launches[i % 3].items()
                            if k.startswith("launches.")}, (i, launches)
    for i, out in enumerate(got):  # later replays left the earlier outputs alone
        assert _same_bits(out, want[i % 3]), i
    if path == "supervised_infer":  # with autograd on the stages stay eager
        with torch.enable_grad():
            out, changes = _counted(lambda: model(scenes[0], train=False)[:3])
        assert _family(changes, "graphs.") == 0 and _same_bits(out[1], want[0][1])


def test_replays_follow_weights_changed_in_place(cuda, monkeypatch):
    """An in-place Adam step and ``load_state_dict`` change the weights a
    replay reads, with no new capture; a state dict assigned (new storages)
    is a new signature: eager once, then captured again."""
    from selfpose3d_tpu_torch.models import get_model

    model, scenes, infer, eager = _graph_case(cuda, monkeypatch, "ssv_infer", 1)
    for _ in range(3):
        first = infer(scenes[0])
    g = torch.Generator(device=cuda).manual_seed(5)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g, device=cuda)
    opt.step()
    out, changes = _counted(lambda: infer(scenes[0]))
    assert _family(changes, "graphs.captures.") == 0 and _family(changes, "graphs.replays.") == 3
    assert _same_bits(out, eager(scenes[0])) and not _same_bits(out, first)
    other = get_model(model.cfg, device=cuda, seed=1).state_dict()
    model.load_state_dict(other)
    out, changes = _counted(lambda: infer(scenes[1]))
    assert _family(changes, "graphs.captures.") == 0 and _family(changes, "graphs.replays.") == 3
    assert _same_bits(out, eager(scenes[1]))
    model.load_state_dict({k: v.clone() for k, v in other.items()}, assign=True)
    for captures, replays in ((0, 0), (3, 3), (0, 3)):
        out, changes = _counted(lambda: infer(scenes[2]))
        assert (_family(changes, "graphs.captures."), _family(changes, "graphs.replays.")) == (
            captures, replays), changes
        assert _same_bits(out, eager(scenes[2]))


# ------------------------------------------------- s4's top-down path (HRNet)

def test_topdown_graphed_equals_eager_and_syncs_once(cuda, monkeypatch):
    """``topdown_keypoints`` with a small HRNet on the card: the first call
    runs eager, the second captures the network with its flip test, the
    third replays it; each call's keypoints, crops and heatmaps equal the
    eager call's bit for bit, no ``host_syncs`` counter moves, and PyTorch's
    sync debug mode sees one sync a call, the keypoints' copy to the host.
    The card's keypoints agree with the CPU's."""
    import warnings

    from test_torch_hrnet import SMALL_EXTRA, _seeded, _small_cfg

    from portbench.reference import hrnet as ref_hrnet
    from selfpose3d_tpu_torch.models import get_model
    from selfpose3d_tpu_torch.pseudo_labels import inference
    from selfpose3d_tpu_torch.utils import graphs

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    P = _seeded(ref_hrnet.param_spec(SMALL_EXTRA, 17))
    model = get_model(_small_cfg(), device=cuda)
    model.load_state_dict(P)
    g = torch.Generator().manual_seed(2)
    frames = torch.randint(0, 256, (2, 240, 320, 3), generator=g, dtype=torch.uint8).pin_memory()
    boxes = torch.tensor([[20.0, 10.0, 60.0, 150.0], [200.0, 40.0, 70.0, 180.0],
                          [-10.0, 100.0, 50.0, 90.0], [150.0, 5.0, 40.0, 60.0]]).pin_memory()
    frame_of = torch.tensor([0, 0, 1, 1]).pin_memory()

    def call():
        return inference.topdown_keypoints(model, frames, boxes, frame_of, keep=True)

    with monkeypatch.context() as m:
        m.setattr(graphs, "run", lambda stage, module, fn, *args: fn(module, *args))
        want = call()
    for i in range(3):
        out, changes = _counted(call)
        assert _same_bits(out, want), i
        assert _family(changes, "host_syncs.") == 0, changes
        assert _family(changes, "graphs.replays.") == (0 if i == 0 else 1), (i, changes)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in seen if SYNC_WARNING in str(w.message)]
    assert len(syncs) == 1, syncs
    cpu = get_model(_small_cfg(), device="cpu")
    cpu.load_state_dict(P)
    kp = inference.topdown_keypoints(cpu, frames, boxes, frame_of)
    np.testing.assert_allclose(want[0].numpy()[..., 2], kp.numpy()[..., 2], rtol=1e-3, atol=1e-3)
