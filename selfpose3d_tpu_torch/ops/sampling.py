"""Plain bilinear sampling with torch ``F.grid_sample`` semantics
(ref: lib/models/project_layer.py:93, ``align_corners=True``,
``padding_mode='zeros'``).

Coordinates arrive already denormalised to heatmap pixels, align-corners
convention (integer coordinates hit texel centers). Each of the 4 taps
contributes 0 when its integer pixel lies outside the image. The tap
order and weight arithmetic are those of ``selfpose3d_tpu.ops.sampling``.
This is the plain version of both CUDA samplers in ``ops/slicewarp.py``.
"""

from __future__ import annotations

import torch


def bilinear_sample(hm: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Sample ``hm`` (B, H, W, J) at pixel coords ``px, py`` (B, N) -> (B, N, J)."""
    B, H, W, J = hm.shape
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = px - x0
    wy = py - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = hm.reshape(B, H * W, J)
    bidx = torch.arange(B, device=hm.device)[:, None]
    out = None
    for dy, dx, wgt in (
        (0, 0, (1 - wx) * (1 - wy)),
        (0, 1, wx * (1 - wy)),
        (1, 0, (1 - wx) * wy),
        (1, 1, wx * wy),
    ):
        yi = y0i + dy
        xi = x0i + dx
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        rows = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        term = flat[bidx, rows] * (wgt * valid.to(wgt.dtype))[..., None]
        out = term if out is None else out + term
    return out
