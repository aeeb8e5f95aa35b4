"""RootNet: whole-space person localisation (ref: lib/models/cuboid_proposal_net_soft.py).

Unproject the root heatmaps over the capture space (one ``sample_view``
kernel launch per view), V2VNet, then 3D max-pool NMS + top-K proposals.
The SSV variant also trains on synthetically generated 3D roots rendered
to per-view 2D Gaussians (``train_synth``, ref:
cuboid_proposal_net_soft.py:151-241). BatchNorm follows ``module.training``.
Inside an inference entry on CUDA, ``forward`` replays a CUDA graph of its
body (``utils/graphs.py``). ``SupervisedProposal`` gives the supervised
baseline's GT-matched flags.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from selfpose3d_tpu_torch.device import device_constant
from selfpose3d_tpu_torch.geometry.cameras import CameraParams, project_points_with_trans
from selfpose3d_tpu_torch.geometry.grid import compute_grid, grid_1d_axes
from selfpose3d_tpu_torch.models.v2v_net import V2VNet
from selfpose3d_tpu_torch.ops.gaussian import (
    clip01,
    render_gaussian_cube_3d,
    render_gaussian_heatmaps,
)
from selfpose3d_tpu_torch.ops.proposal import (
    match_proposals_to_gt,
    nms_topk,
    proposals_soft,
    voxel_index_to_world,
)
from selfpose3d_tpu_torch.ops.unproject import unproject_heatmaps
from selfpose3d_tpu_torch.parallel import mesh
from selfpose3d_tpu_torch.utils import graphs, spans


class RootNet(nn.Module):
    """Heatmaps (B, V, H, W, Jr) -> (root_cubes (B, X, Y, Z), grid_centers (B, K, 5))."""

    def __init__(
        self,
        space_size,
        space_center,
        cube_size,
        image_wh,
        in_channels: int = 1,
        max_people: int = 10,
        threshold: float = 0.3,
        syn_sigma: float = 200.0,
        syn_range=((2500.0, -2000.0), (1500.0, -1500.0), (250.0, -300.0)),
        hm_sigma: float = 3.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.space_size = tuple(float(s) for s in space_size)
        self.space_center = tuple(float(s) for s in space_center)
        self.cube_size = tuple(int(s) for s in cube_size)
        self.image_wh = tuple(image_wh)
        self.max_people = max_people
        self.threshold = threshold
        self.syn_sigma = float(syn_sigma)
        self.syn_range = tuple(tuple(float(v) for v in r) for r in syn_range)
        self.hm_sigma = float(hm_sigma)
        self.v2v_net = V2VNet(in_channels, 1, dtype=dtype)

    def unproject(self, heatmaps, cam, trans, orig_wh, hflip=None) -> torch.Tensor:
        center = device_constant(self.space_center, torch.float32, heatmaps.device)
        grid = compute_grid(self.space_size, center, self.cube_size)
        return unproject_heatmaps(
            heatmaps, grid, cam, trans, self.image_wh, orig_wh, self.cube_size, hflip=hflip
        )

    @spans.span("sp3d.rootnet")
    def forward(
        self,
        heatmaps: torch.Tensor,
        cam: CameraParams,
        trans: torch.Tensor,
        orig_wh: torch.Tensor,
        hflip: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return graphs.run("rootnet", self, RootNet._forward, heatmaps, cam, trans, orig_wh, hflip)

    def _forward(self, heatmaps, cam, trans, orig_wh, hflip):
        cubes = self.unproject(heatmaps, cam, trans, orig_wh, hflip)
        root_cubes = self.v2v_net(cubes)[..., 0]  # (B, X, Y, Z)
        grid_centers = proposals_soft(
            root_cubes.detach(), self.max_people, self.threshold,
            self.space_size, self.space_center, self.cube_size,
        )
        return root_cubes, grid_centers

    def synth_bounds(self):
        """World-space sampling bounds per axis ((min, max) x 3): the grid
        extent shrunk by ``syn_range``."""
        ss, sc, rr = self.space_size, self.space_center, self.syn_range
        return tuple(
            (sc[d] - ss[d] / 2 + rr[d][0], sc[d] + ss[d] / 2 + rr[d][1]) for d in range(3)
        )

    @spans.span("sp3d.rootnet")
    def train_synth(
        self,
        cam: CameraParams,
        trans: torch.Tensor,
        orig_wh: torch.Tensor,
        heatmap_wh: Tuple[int, int],
        hflip: Optional[torch.Tensor] = None,
        groups: int = 1,
        inject: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Synthetic-root training pass (ref: cuboid_proposal_net_soft.py:151-241).

        Samples 1..max_people-1 random roots in the ``syn_range``-shrunk
        space, renders their 3D Gaussian target cube and per-view 2D
        Gaussian heatmaps (plus 2% noise), then unprojects and V2Vs them.

        ``groups``: number of folded augmentation branches in the batch
        axis; one root count is drawn per B/groups-sized group, as the
        reference draws one per call.

        ``inject``: deterministic draws replacing the generator: 'roots'
        (B, P, 3), 'counts' (groups,) int, 'noise' of the rendered heatmaps'
        shape (B, V, 1, H, W). Otherwise the draws come from ``generator``
        (a CPU ``torch.Generator``; the global one when None) with the
        reference's distributions: randint(1, P) per group, uniform x and y,
        one uniform z base per sample + N(0, 50^2), noise 0.02 * N(0, 1).

        Across ranks (``parallel/mesh.py``) the batch is this rank's part of
        a global batch of ``world`` equal parts. The generator (seeded alike
        on every rank) then draws at the global folded shape and the rank
        keeps its rows of each group, rows ``g*world*b + rank*b ... + b``
        for b = B / groups; at world 1 the draws are those of one process.

        Returns (root_cubes_syn (B, X, Y, Z), target_cubes (B, X, Y, Z)).
        """
        B, V = cam.R.shape[:2]
        P = self.max_people
        dev = cam.R.device
        W, H = heatmap_wh
        if B % groups:
            raise ValueError("the folded batch must split evenly into branches")
        if inject is None:
            (min_x, max_x), (min_y, max_y), (min_z, max_z) = self.synth_bounds()

            def uniform(shape, lo, hi):
                return lo + (hi - lo) * torch.rand(shape, generator=generator)

            rank, world = mesh.rank(), mesh.world()
            Bg = B * world
            num_roots = torch.randint(1, P, (groups,), generator=generator)
            x = uniform((Bg, P), min_x, max_x)
            y = uniform((Bg, P), min_y, max_y)
            z = uniform((Bg, 1), min_z, max_z) + torch.randn((Bg, P), generator=generator) * 50.0
            roots = torch.stack([x, y, z], dim=-1)
            noise = 0.02 * torch.randn((Bg, V, 1, H, W), generator=generator)
            if world > 1:
                b = B // groups
                rows = (torch.arange(groups)[:, None] * (world * b) + rank * b
                        + torch.arange(b)[None]).reshape(-1)
                roots, noise = roots[rows], noise[rows]
        else:
            num_roots = torch.as_tensor(inject["counts"]).to(torch.int64)
            roots = torch.as_tensor(inject["roots"], dtype=torch.float32)
            noise = torch.as_tensor(inject["noise"], dtype=torch.float32).reshape(B, V, 1, H, W)
        # blocking copies of the host draws and of the grid's axes below
        spans.count("host_syncs.rootnet_synth", 6)
        roots, noise = roots.to(dev, cam.R.dtype), noise.to(dev, cam.R.dtype)
        counts = num_roots.to(dev).repeat_interleave(B // groups)  # (B,)
        mask_b = (torch.arange(P, device=dev)[None, :] < counts[:, None]).to(torch.float32)

        with torch.no_grad():  # targets and inputs are data: no gradient
            gx, gy, gz = (
                torch.from_numpy(a).to(dev)
                for a in grid_1d_axes(self.space_size, self.space_center, self.cube_size)
            )
            target_cubes = render_gaussian_cube_3d(
                roots, gx, gy, gz, sigma=self.syn_sigma, mask=mask_b
            )
            pix = project_points_with_trans(roots[:, None], cam, trans)  # (B, V, P, 2)
            hm = render_gaussian_heatmaps(
                pix[..., None, :],  # (B, V, P, 1, 2): the one root channel
                heatmap_wh, sigma=self.hm_sigma, coord_scale=0.25,
                mask=mask_b[:, None].expand(B, V, P),
            )  # (B, V, 1, H, W)
            heatmaps = clip01(hm + noise).permute(0, 1, 3, 4, 2).contiguous()

        cubes = self.unproject(heatmaps, cam, trans, orig_wh, hflip)
        root_cubes_syn = self.v2v_net(cubes)[..., 0]
        return root_cubes_syn, target_cubes


class SupervisedProposal(nn.Module):
    """GT-matched proposal flags of the supervised VoxelPose baseline
    (ref: lib/models/cuboid_proposal_net.py:14-83), applied to RootNet's
    detection volume. It has no parameters."""

    def __init__(self, space_size, space_center, cube_size, max_people: int = 10,
                 threshold: float = 0.1):
        super().__init__()
        self.space_size = tuple(float(s) for s in space_size)
        self.space_center = tuple(float(s) for s in space_center)
        self.cube_size = tuple(int(s) for s in cube_size)
        self.max_people = max_people
        self.threshold = threshold

    def forward(self, root_cubes, gt_roots=None, num_person=None, training=False) -> torch.Tensor:
        """root_cubes (B, X, Y, Z) -> grid_centers (B, K, 5): [x, y, z, flag,
        score]. In training with GT the flag is the matched GT's index or
        -1 (``match_proposals_to_gt``); otherwise 0 above ``threshold``, else -1."""
        values, index = nms_topk(root_cubes.detach(), self.max_people)
        loc = voxel_index_to_world(index, self.space_size, self.space_center, self.cube_size)
        if training and gt_roots is not None and num_person is not None:
            flag = match_proposals_to_gt(loc, gt_roots, num_person)
        else:
            flag = (values > self.threshold).to(torch.float32) - 1.0
        return torch.cat([loc, flag[..., None], values[..., None]], dim=-1)
