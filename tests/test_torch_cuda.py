"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
GPU). Imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

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
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


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
    every other 700 points (runs half zero). Against the float64 plain
    version (1e-5 of the largest gradient) and the inner-product identity
    (1e-5 relative)."""
    g = torch.Generator(device=cuda).manual_seed(J)
    B, N, H, W = 2, 50_000, 128, 240
    px, py, cot = _adjoint_case(case, g, B, N, H, W, J, cuda)
    before = LAUNCHES["sample_view_adjoint"]
    got = sample_view_adjoint(cot, px, py, (H, W))
    torch.cuda.synchronize()
    assert LAUNCHES["sample_view_adjoint"] == before + 1
    want = sample_view_adjoint_plain(cot.double(), px, py, (H, W))
    if case == "all_zero":
        assert not bool(got.any())
        return
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5 * float(want.abs().max()))
    hm = torch.rand(B, H, W, J, generator=g, device=cuda)
    lhs = float((sample_view(hm, px, py).double() * cot.double()).sum())
    rhs = float((hm.double() * got.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


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
