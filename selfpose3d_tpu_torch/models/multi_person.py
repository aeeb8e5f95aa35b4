"""MultiPersonPoseNetSSV: the SelfPose3d model, inference path
(ref: lib/models/multi_person_posenet_ssv.py:29-153).

Per-view backbone heatmaps -> RootNet proposals -> per-candidate PoseNet.
The SSV training losses and the attention net are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from selfpose3d_tpu_torch.config import Config
from selfpose3d_tpu_torch.data.structures import AugBranch
from selfpose3d_tpu_torch.models.pose_net import PoseNet
from selfpose3d_tpu_torch.models.pose_resnet import PoseResNet
from selfpose3d_tpu_torch.models.root_net import RootNet


class MultiPersonPoseNetSSV(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        if c.NETWORK.USE_GT or c.NETWORK.TRAIN_ONLY_2D or c.NETWORK.TRAIN_ONLY_ROOTNET:
            raise NotImplementedError(
                "only the RootNet + PoseNet inference path is ported"
            )
        J = c.NETWORK.NUM_JOINTS
        if c.BACKBONE_MODEL:
            self.backbone = PoseResNet(
                num_layers=c.POSE_RESNET.NUM_LAYERS,
                num_joints=J,
                deconv_filters=tuple(c.POSE_RESNET.NUM_DECONV_FILTERS),
                deconv_kernels=tuple(c.POSE_RESNET.NUM_DECONV_KERNELS),
                final_conv_kernel=c.POSE_RESNET.FINAL_CONV_KERNEL,
                deconv_with_bias=c.POSE_RESNET.DECONV_WITH_BIAS,
                dtype=dtype,
            )
        self.root_net = RootNet(
            space_size=c.MULTI_PERSON.SPACE_SIZE,
            space_center=c.MULTI_PERSON.SPACE_CENTER,
            cube_size=c.MULTI_PERSON.INITIAL_CUBE_SIZE,
            image_wh=c.NETWORK.IMAGE_SIZE,
            in_channels=1 if c.NETWORK.ROOTNET_ROOTHM else J,
            max_people=c.MULTI_PERSON.MAX_PEOPLE_NUM,
            threshold=c.MULTI_PERSON.THRESHOLD,
            dtype=dtype,
        )
        self.pose_net = PoseNet(
            grid_size=c.PICT_STRUCT.GRID_SIZE,
            cube_size=c.PICT_STRUCT.CUBE_SIZE,
            image_wh=c.NETWORK.IMAGE_SIZE,
            num_joints=J,
            beta=c.NETWORK.BETA,
            buckets=tuple(c.MULTI_PERSON.CANDIDATE_BUCKETS),
            dtype=dtype,
        )

    def heatmaps(self, branch: AugBranch) -> torch.Tensor:
        """Backbone -> (B, V, Hh, Wh, J) float32. Views run one after
        another, so only one view's activations are live at a time."""
        if branch.views is None:
            return branch.input_heatmaps
        return torch.stack(
            [self.backbone(branch.views[:, v]) for v in range(branch.views.shape[1])],
            dim=1,
        )

    def root_heatmaps(self, heatmaps: torch.Tensor) -> torch.Tensor:
        """The root-joint channel when ROOTNET_ROOTHM
        (ref: cuboid_proposal_net_soft.py:129-135)."""
        if self.cfg.NETWORK.ROOTNET_ROOTHM:
            rid = self.cfg.DATASET.ROOTIDX
            return heatmaps[..., rid : rid + 1]
        return heatmaps

    @torch.no_grad()
    def do_inference(self, branch: AugBranch):
        """-> (pred (B, K, J, 5), heatmaps (B, V, H, W, J), grid_centers (B, K, 5)).

        pred[..., :3] are world-mm joints (zero for invalid candidates),
        pred[..., 3:] each candidate's (flag, score).
        """
        c = self.cfg
        heatmaps = self.heatmaps(branch)
        B = heatmaps.shape[0]
        K = c.MULTI_PERSON.MAX_PEOPLE_NUM
        J = c.NETWORK.NUM_JOINTS
        _, grid_centers = self.root_net(
            self.root_heatmaps(heatmaps), branch.cam, branch.trans, branch.orig_wh
        )
        pred = torch.zeros((B, K, J, 5), dtype=torch.float32, device=heatmaps.device)
        pred[..., 3:] = grid_centers[:, :, None, 3:]
        if not c.EVAL_ROOTNET_ONLY:
            poses, _ = self.pose_net(
                heatmaps, branch.cam, branch.trans, branch.orig_wh, grid_centers
            )
            pred[..., 0:3] = poses
        return pred, heatmaps, grid_centers
