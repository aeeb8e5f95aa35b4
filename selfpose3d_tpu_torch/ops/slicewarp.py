"""The voxel samplers: hand-written CUDA kernels and their plain versions.

``sample_view`` replaces the TPU kernel ``_slice_warp_kernel``,
``sample_views_mean`` replaces ``_slice_warp_agg_kernel`` and
``sample_view_adjoint`` replaces ``_slice_warp_adjoint_kernel`` (all in
``selfpose3d_tpu/ops/slicewarp.py``). They compute what those compute,
exact bilinear everywhere, without the TPU's hosting machinery; see
``csrc/slicewarp.cu``.

``sample_view`` is differentiable in the heatmap: its backward is
``sample_view_adjoint``. The coordinates get no gradient, as in the JAX
package. ``sample_views_mean`` is inference-only, as its JAX counterpart
is, and raises on an input that requires grad.

A wrapper takes float32 tensors. Given CPU tensors it runs the plain
version (explicit 4-tap gathers, ``ops/sampling.py``; four ``index_add_``
for the adjoint). Given CUDA tensors (contiguous) it launches the kernel
or raises; it never falls back.
``LAUNCHES`` counts kernel launches per wrapper, and nothing else.
"""

from __future__ import annotations

from typing import Tuple

import torch

from selfpose3d_tpu_torch.device import kernel_route
from selfpose3d_tpu_torch.ops import build
from selfpose3d_tpu_torch.ops.sampling import bilinear_sample as sample_view_plain

MAX_CHANNELS = 32
LAUNCHES = {"sample_view": 0, "sample_views_mean": 0, "sample_view_adjoint": 0}


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


def _padded_scratch(lib, hm: torch.Tensor, mean: bool, B: int, V: int, H: int, W: int, J: int):
    """The scratch a forward entry asks for (``sp3d_forward_scratch_floats``)
    for its copy of ``hm`` with the channels padded to a multiple of 4;
    None where it reads ``hm`` as it is."""
    n = lib.sp3d_forward_scratch_floats(hm.data_ptr(), int(mean), B, V, H, W, J)
    return torch.empty(n, dtype=torch.float32, device=hm.device) if n else None


def _check(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected float32")


def sample_view_adjoint_plain(
    g: torch.Tensor, px: torch.Tensor, py: torch.Tensor, hw: Tuple[int, int]
) -> torch.Tensor:
    """Adjoint of ``sample_view_plain`` in the heatmap: four ``index_add_``
    on a (H*W, J) buffer per batch element, taps outside the image dropped
    (mirrors the scatter branch of ``_slice_warp_bwd``).

    g (B, N, J); px, py (B, N); hw = (H, W) -> (B, H, W, J) in g's dtype.
    """
    H, W = hw
    B, N, J = g.shape
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = px - x0
    wy = py - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = torch.zeros((B * H * W, J), dtype=g.dtype, device=g.device)
    base = (torch.arange(B, device=g.device) * (H * W))[:, None]
    for dy, dx, wgt in (
        (0, 0, (1 - wx) * (1 - wy)),
        (0, 1, wx * (1 - wy)),
        (1, 0, (1 - wx) * wy),
        (1, 1, wx * wy),
    ):
        yi = y0i + dy
        xi = x0i + dx
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        rows = base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        flat.index_add_(
            0, rows.reshape(-1), (g * (wgt * valid.to(wgt.dtype))[..., None]).reshape(-1, J)
        )
    return flat.reshape(B, H, W, J)


def sample_view_adjoint(
    g: torch.Tensor, px: torch.Tensor, py: torch.Tensor, hw: Tuple[int, int]
) -> torch.Tensor:
    """d(loss)/d(heatmap) of ``sample_view`` (replaces
    ``_slice_warp_adjoint_kernel``): ``dhm[b, y0+dy, x0+dx, :] += w_tap *
    g[b, n, :]`` over the 4 taps, taps outside the image dropped.

    On the card the sums are float32 atomic adds, whose order varies from
    run to run: two runs agree to rounding of the sums, not bit for bit.

    Args:
      g: (B, N, J) float32 cotangent of the samples, J <= 32.
      px, py: (B, N) float32 pixel coords, align-corners convention.
      hw: (H, W) of the heatmap.
    Returns:
      (B, H, W, J) float32.
    """
    H, W = (int(s) for s in hw)
    B, N, J = g.shape
    _check("g", g, (B, N, J))
    _check("px", px, (B, N))
    _check("py", py, (B, N))
    if J > MAX_CHANNELS:
        raise ValueError(f"J={J} > {MAX_CHANNELS}")
    if not kernel_route((g, px, py)):
        return sample_view_adjoint_plain(g, px, py, (H, W))
    lib = build.library("slicewarp")
    dhm = torch.zeros((B, H, W, J), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.sp3d_sample_view_adjoint(
            g.data_ptr(), px.data_ptr(), py.data_ptr(), dhm.data_ptr(),
            B, N, H, W, J, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"sp3d_sample_view_adjoint launch failed: CUDA error {err}")
    LAUNCHES["sample_view_adjoint"] += 1
    return dhm


def _sample_view_forward(hm: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    B, H, W, J = hm.shape
    N = px.shape[-1]
    _check("hm", hm, (B, H, W, J))
    _check("px", px, (B, N))
    _check("py", py, (B, N))
    if J > MAX_CHANNELS:
        raise ValueError(f"J={J} > {MAX_CHANNELS}")
    if not kernel_route((hm, px, py)):
        return sample_view_plain(hm, px, py)
    lib = build.library("slicewarp")
    out = torch.empty((B, N, J), dtype=torch.float32, device=hm.device)
    padded = _padded_scratch(lib, hm, False, B, 1, H, W, J)
    with torch.cuda.device(hm.device):
        err = lib.sp3d_sample_view(
            hm.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(), B, N, H, W, J,
            None if padded is None else padded.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"sp3d_sample_view launch failed: CUDA error {err}")
    LAUNCHES["sample_view"] += 1
    return out


class _SampleView(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hm, px, py):
        ctx.save_for_backward(px, py)
        ctx.hw = (hm.shape[1], hm.shape[2])
        return _sample_view_forward(hm, px, py)

    @staticmethod
    def backward(ctx, g):
        px, py = ctx.saved_tensors
        # a CUDA cotangent may arrive as a strided view; the kernel takes
        # contiguous memory
        return sample_view_adjoint(g.contiguous(), px, py, ctx.hw), None, None


def sample_view(hm: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """One view's exact bilinear samples (replaces ``_slice_warp_kernel``),
    differentiable in ``hm`` through ``sample_view_adjoint``.

    Args:
      hm: (B, H, W, J) float32 heatmaps, J <= 32.
      px, py: (B, N) float32 pixel coords, align-corners convention; they
        receive no gradient.
    Returns:
      (B, N, J) float32, zero-padded outside the image.
    """
    return _SampleView.apply(hm, px, py)


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (hm, px, py, bnd)):
        raise RuntimeError(
            "sample_views_mean is inference-only (no backward): sample each "
            "view with sample_view where a gradient is needed"
        )
    if not kernel_route((hm, px, py, bnd)):
        return sample_views_mean_plain(hm, px, py, bnd, out_dtype)
    lib = build.library("slicewarp")
    out = torch.empty((B, N, J), dtype=out_dtype, device=hm.device)
    padded = _padded_scratch(lib, hm, True, B, V, H, W, J)
    with torch.cuda.device(hm.device):
        err = lib.sp3d_sample_views_mean(
            hm.data_ptr(), px.data_ptr(), py.data_ptr(), bnd.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), B, V, N, H, W, J,
            None if padded is None else padded.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"sp3d_sample_views_mean launch failed: CUDA error {err}")
    LAUNCHES["sample_views_mean"] += 1
    return out
