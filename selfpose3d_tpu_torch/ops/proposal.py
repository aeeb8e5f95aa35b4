"""3D max-pool NMS + top-K proposal extraction (ref: lib/core/proposal.py:18-48,
cuboid_proposal_net_soft.py:46-68)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from selfpose3d_tpu_torch.utils import spans


def max_pool_nms_3d(x: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep-equal NMS: zero voxels that are not their 3^3 local max.
    x: (B, X, Y, Z); max_pool3d pads with -inf."""
    pooled = F.max_pool3d(x[:, None], kernel, stride=1, padding=kernel // 2)[:, 0]
    return (x == pooled).to(x.dtype) * x


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys ordered like IEEE total order on float32 (-0.0 < +0.0,
    NaN above +inf): the comparison ``lax.top_k`` sorts by."""
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def nms_topk(root_cubes: torch.Tensor, max_num: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS then top-K with flat-index unravel.

    Ties come out in ``lax.top_k`` order, (-score, flat index) with scores
    in total order: a stable descending sort, not ``Tensor.topk``, whose tie
    order is unspecified. Suppressed negative voxels are -0.0 and rank
    below suppressed positive ones (+0.0), as they do in the JAX package.

    Args:
      root_cubes: (B, X, Y, Z) float32 detection volume.
    Returns:
      values (B, K) and index (B, K, 3) int64 voxel coords (x, y, z).
    """
    B, X, Y, Z = root_cubes.shape
    flat = max_pool_nms_3d(root_cubes).reshape(B, -1)
    _, order = torch.sort(_total_order_key(flat), dim=-1, descending=True, stable=True)
    idx = order[:, :max_num]
    values = torch.gather(flat, 1, idx)
    ix = idx // (Y * Z)
    iy = (idx % (Y * Z)) // Z
    iz = idx % Z
    return values, torch.stack([ix, iy, iz], dim=-1)


def voxel_index_to_world(
    index: torch.Tensor,
    space_size: Sequence[float],
    space_center: Sequence[float],
    cube_size: Sequence[int],
) -> torch.Tensor:
    """Voxel indices -> world mm (ref: cuboid_proposal_net_soft.py:46-52)."""
    kw = dict(dtype=torch.float32, device=index.device)
    spans.count("host_syncs.voxel_to_world", 3)  # three blocking copies of host lists
    cube = torch.tensor([float(s) for s in cube_size], **kw)
    size = torch.tensor([float(s) for s in space_size], **kw)
    center = torch.tensor([float(s) for s in space_center], **kw)
    return index.to(torch.float32) / (cube - 1.0) * size + center - size / 2.0


@spans.span("sp3d.proposals")
def proposals_soft(
    root_cubes: torch.Tensor,
    max_num: int,
    threshold: float,
    space_size: Sequence[float],
    space_center: Sequence[float],
    cube_size: Sequence[int],
) -> torch.Tensor:
    """Threshold-gated proposals (ref: cuboid_proposal_net_soft.py:54-68).

    Returns grid_centers (B, K, 5): [x, y, z, valid_flag, score] with
    valid_flag 0.0 when score > threshold else -1.0.
    """
    values, index = nms_topk(root_cubes, max_num)
    loc = voxel_index_to_world(index, space_size, space_center, cube_size)
    flag = (values > threshold).to(torch.float32) - 1.0
    return torch.cat([loc, flag[..., None], values[..., None]], dim=-1)


def match_proposals_to_gt(
    loc: torch.Tensor,
    gt_roots: torch.Tensor,
    num_person: torch.Tensor,
    max_dist: float = 500.0,
) -> torch.Tensor:
    """Supervised candidate -> GT matching (ref: cuboid_proposal_net.py:25-40).

    Args:
      loc: (B, K, 3) candidate world locations.
      gt_roots: (B, P, 3) padded GT roots.
      num_person: (B,) valid person counts.
    Returns:
      (B, K) float32: the nearest valid GT's index (the first among equal
      distances), or -1.0 when it lies farther than ``max_dist`` or no GT
      is valid.
    """
    d = torch.sqrt(((loc[:, :, None, :] - gt_roots[:, None, :, :]) ** 2).sum(dim=-1))
    P = gt_roots.shape[1]
    valid = torch.arange(P, device=loc.device)[None, None, :] < num_person[:, None, None]
    d = torch.where(valid, d, torch.full_like(d, float("inf")))
    min_d = d.amin(dim=-1)
    min_gt = torch.argmin(d, dim=-1).to(torch.float32)  # the first minimum, as jnp.argmin
    return torch.where(min_d > max_dist, torch.full_like(min_d, -1.0), min_gt)
