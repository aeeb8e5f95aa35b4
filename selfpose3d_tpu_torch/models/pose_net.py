"""PoseNet: per-candidate 3D pose regression (ref: lib/models/pose_regression_net.py:31-53).

A 64^3 cube is centered at every root candidate; all views' heatmaps are
sampled into every cube, a V2VNet (J -> J) scores each joint per voxel,
and a soft-argmax regresses metric joint positions. The K candidates are
one batch axis of the V2V.

One rule picks the sampler: where a gradient must reach the heatmaps
(autograd is on and they require grad) each view is sampled with
``sample_view``, whose backward is the adjoint kernel; otherwise one
``sample_views_mean`` launch samples all views. Train mode
(``module.training``) restricts the BatchNorm statistics to the valid
candidates (of every rank's batch, across ranks).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from selfpose3d_tpu_torch.geometry.cameras import CameraParams
from selfpose3d_tpu_torch.geometry.grid import axis_offsets, compute_grid
from selfpose3d_tpu_torch.models.v2v_net import V2VNet
from selfpose3d_tpu_torch.ops.softargmax import soft_argmax_ndhwc
from selfpose3d_tpu_torch.ops.unproject import sample_cubes
from selfpose3d_tpu_torch.parallel import mesh
from selfpose3d_tpu_torch.utils import spans


class PoseNet(nn.Module):
    def __init__(
        self,
        grid_size=(2000.0, 2000.0, 2000.0),
        cube_size=(64, 64, 64),
        image_wh=(960, 512),
        num_joints: int = 15,
        beta: float = 100.0,
        buckets: Tuple[int, ...] = (),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.grid_size = tuple(float(s) for s in grid_size)
        self.cube_size = tuple(int(s) for s in cube_size)
        self.image_wh = tuple(image_wh)
        self.beta = beta
        # candidate-count buckets: the candidate axis is cut to the smallest
        # bucket covering every valid candidate, so sampling, V2V and
        # soft-argmax scale with the scene's people count
        # (ref: multi_person_posenet_ssv.py:365-383 loops over valid ones)
        self.buckets = tuple(buckets)
        self.dtype = dtype
        self.v2v_net = V2VNet(num_joints, num_joints, dtype=dtype)

    def bucket(self, grid_centers: torch.Tensor) -> int:
        """Candidates to run: the smallest bucket covering the highest valid
        slot across the batch (one host read)."""
        K = grid_centers.shape[1]
        buckets = tuple(b for b in self.buckets if b < K) + (K,)
        if len(buckets) == 1:
            return K
        flags = grid_centers[..., 3] >= 0
        slot = torch.arange(1, K + 1, device=grid_centers.device)
        spans.count("host_syncs.posenet_bucket")
        needed = int(torch.where(flags, slot, 0).max())
        return next(b for b in buckets if b >= needed)

    @spans.span("sp3d.posenet")
    def forward(
        self,
        heatmaps: torch.Tensor,
        cam: CameraParams,
        trans: torch.Tensor,
        orig_wh: torch.Tensor,
        grid_centers: torch.Tensor,
        hflip: Optional[torch.Tensor] = None,
        bucketed: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (pred (B, K, J, 3) world mm, zero for invalid candidates;
        valid (B, K) float mask, flag >= 0).

        ``hflip``: optional (B,) flip flags. ``bucketed=False`` runs the
        given K candidates as they are (the train step, which slices the
        score-sorted proposals itself)."""
        K = grid_centers.shape[1]
        k = self.bucket(grid_centers) if bucketed else K
        pred = self._run(heatmaps, cam, trans, orig_wh, grid_centers[:, :k], hflip)
        pred = F.pad(pred, (0, 0, 0, 0, 0, K - k))
        return pred, (grid_centers[..., 3] >= 0).to(torch.float32)

    def _run(self, heatmaps, cam, trans, orig_wh, grid_centers, hflip=None):
        B, V, H, W, J = heatmaps.shape
        K = grid_centers.shape[1]
        X, Y, Z = self.cube_size
        centers = grid_centers[..., :3]  # (B, K, 3)
        valid = (grid_centers[..., 3] >= 0).to(torch.float32)  # (B, K)

        grids = compute_grid(self.grid_size, centers, self.cube_size)  # (B, K, N, 3)
        needs_grad = torch.is_grad_enabled() and heatmaps.requires_grad
        cubes = sample_cubes(
            heatmaps, grids.reshape(B, K * X * Y * Z, 3), cam, trans,
            self.image_wh, orig_wh, out_dtype=self.dtype, hflip=hflip,
            differentiable=needs_grad,
        ).reshape(B * K, X, Y, Z, J)
        del grids
        # zero invalid candidates' cubes so they contribute nothing
        # downstream (in place only where autograd does not need the cubes)
        keep = valid.reshape(B * K, 1, 1, 1, 1).to(cubes.dtype)
        cubes = cubes * keep if needs_grad else cubes.mul_(keep)
        # BatchNorm statistics over the valid candidates only (the reference
        # runs V2V on those alone, ref: pose_regression_net.py:49-51); over
        # all of them when none is valid, so the moments stay finite (the
        # loss is gated off then)
        bn_mask = None
        if self.training:
            sel = valid.reshape(B * K) > 0
            spans.count("host_syncs.posenet_bn_mask")
            if mesh.world() > 1:
                # the global batch's: the valid candidates of every rank
                # (a mask of all of them is the unmasked batch)
                bn_mask = sel if mesh.agree_max(int(sel.any())) else None
            elif bool(sel.any()):
                spans.count("host_syncs.posenet_bn_mask")
                if not bool(sel.all()):
                    bn_mask = sel
        scored = self.v2v_net(cubes, bn_mask)  # (B*K, X, Y, Z, J) float32

        offs = axis_offsets(self.grid_size, self.cube_size, heatmaps.device)
        c = centers.reshape(B * K, 3)
        axes = tuple(c[:, d : d + 1] + offs[d][None] for d in range(3))
        pred = soft_argmax_ndhwc(scored, axes, beta=self.beta).reshape(B, K, J, 3)
        return pred * valid[..., None, None]
