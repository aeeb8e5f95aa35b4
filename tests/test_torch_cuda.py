"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
GPU). Imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from selfpose3d_tpu_torch.ops import build
from selfpose3d_tpu_torch.ops.slicewarp import (
    LAUNCHES,
    sample_view,
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
