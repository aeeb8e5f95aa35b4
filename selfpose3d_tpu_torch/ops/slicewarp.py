"""The voxel samplers: hand-written CUDA kernels and their plain versions.

``sample_view`` replaces the TPU kernel ``_slice_warp_kernel`` and
``sample_views_mean`` replaces ``_slice_warp_agg_kernel`` (both in
``selfpose3d_tpu/ops/slicewarp.py``). They compute what those compute,
exact bilinear everywhere, without the TPU's hosting machinery; see
``csrc/slicewarp.cu``.

A wrapper given CPU tensors runs the plain version (explicit 4-tap
gathers, ``ops/sampling.py``). Given CUDA tensors it launches the kernel
or raises; it never falls back. ``LAUNCHES`` counts kernel launches per
wrapper, and nothing else.
"""

from __future__ import annotations

import torch

from selfpose3d_tpu_torch.ops import build
from selfpose3d_tpu_torch.ops.sampling import bilinear_sample as sample_view_plain

MAX_CHANNELS = 32
LAUNCHES = {"sample_view": 0, "sample_views_mean": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sample_views_mean_plain(
    hm: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    bnd: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Bounded mean over views of the bilinear samples.

    hm (B, V, H, W, J) f32; px, py, bnd (B, V, N) f32 -> (B, N, J) in
    ``out_dtype``: clip(nan_to_num(sum_v s_v*bnd_v / (sum_v bnd_v + 1e-6)), 0, 1).
    """
    wsum = None
    bsum = None
    for v in range(hm.shape[1]):
        term = sample_view_plain(hm[:, v], px[:, v], py[:, v]) * bnd[:, v, :, None]
        wsum = term if wsum is None else wsum + term
        bsum = bnd[:, v] if bsum is None else bsum + bnd[:, v]
    out = wsum / (bsum[..., None] + 1e-6)
    return torch.nan_to_num(out, nan=0.0).clamp(0.0, 1.0).to(out_dtype)


def _check(name, t, shape, dtype=torch.float32):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")


def _route(tensors) -> bool:
    """True for the kernel (all CUDA, contiguous, one device), False for the
    plain version (all CPU); raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA samplers take contiguous tensors")
    return True


def sample_view(hm: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """One view's exact bilinear samples (replaces ``_slice_warp_kernel``).

    Args:
      hm: (B, H, W, J) float32 heatmaps, J <= 32.
      px, py: (B, N) float32 pixel coords, align-corners convention.
    Returns:
      (B, N, J) float32, zero-padded outside the image.
    """
    B, H, W, J = hm.shape
    N = px.shape[-1]
    _check("hm", hm, (B, H, W, J))
    _check("px", px, (B, N))
    _check("py", py, (B, N))
    if J > MAX_CHANNELS:
        raise ValueError(f"J={J} > {MAX_CHANNELS}")
    if not _route((hm, px, py)):
        return sample_view_plain(hm, px, py)
    lib = build.library("slicewarp")
    out = torch.empty((B, N, J), dtype=torch.float32, device=hm.device)
    with torch.cuda.device(hm.device):
        err = lib.sp3d_sample_view(
            hm.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(),
            B, N, H, W, J, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"sp3d_sample_view launch failed: CUDA error {err}")
    LAUNCHES["sample_view"] += 1
    return out


def sample_views_mean(
    hm: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    bnd: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Fused multi-view sampling + bounded mean (replaces
    ``_slice_warp_agg_kernel``).

    Args:
      hm: (B, V, H, W, J) float32 heatmaps, J <= 32.
      px, py: (B, V, N) float32 pixel coords, align-corners convention.
      bnd: (B, V, N) float32 in-image weights (0/1).
      out_dtype: float32 or bfloat16.
    Returns:
      (B, N, J) in ``out_dtype``.
    """
    B, V, H, W, J = hm.shape
    N = px.shape[-1]
    _check("hm", hm, (B, V, H, W, J))
    for name, t in (("px", px), ("py", py), ("bnd", bnd)):
        _check(name, t, (B, V, N))
    if J > MAX_CHANNELS:
        raise ValueError(f"J={J} > {MAX_CHANNELS}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype}: float32 or bfloat16 only")
    if not _route((hm, px, py, bnd)):
        return sample_views_mean_plain(hm, px, py, bnd, out_dtype)
    lib = build.library("slicewarp")
    out = torch.empty((B, N, J), dtype=out_dtype, device=hm.device)
    with torch.cuda.device(hm.device):
        err = lib.sp3d_sample_views_mean(
            hm.data_ptr(), px.data_ptr(), py.data_ptr(), bnd.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16),
            B, V, N, H, W, J, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"sp3d_sample_views_mean launch failed: CUDA error {err}")
    LAUNCHES["sample_views_mean"] += 1
    return out
