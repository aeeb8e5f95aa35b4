"""MultiPersonPoseNetSSV: the SelfPose3d model
(ref: lib/models/multi_person_posenet_ssv.py:29-501).

Per-view backbone heatmaps -> RootNet proposals -> per-candidate PoseNet
(``do_inference``), and the six self-supervised loss terms of one train
step (``ssv_losses``): the three augmentation branches are folded into the
batch axis, as in ``selfpose3d_tpu.models.multi_person``, so the backbone
runs once on 3B, the attention net once on 2B, RootNet main and synthetic
passes on 3B and PoseNet once on 2B. Train-mode BatchNorm statistics pool
over each fold. Every ``stop_gradient`` of the JAX package is a
``detach()`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from selfpose3d_tpu_torch.config import Config
from selfpose3d_tpu_torch.data.structures import AugBranch
from selfpose3d_tpu_torch.geometry.cameras import project_points_with_trans
from selfpose3d_tpu_torch.models.pose_net import PoseNet
from selfpose3d_tpu_torch.models.pose_resnet import PoseResAttnNet, PoseResNet
from selfpose3d_tpu_torch.models.root_net import RootNet
from selfpose3d_tpu_torch.ops.gaussian import render_gaussian_heatmaps
from selfpose3d_tpu_torch.ops.matching import masked_assignment_cost


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def cat_branches(*branches: AugBranch) -> AugBranch:
    """Concatenate branches along the batch axis, field by field."""

    def cat(*xs):
        if xs[0] is None:
            return None
        if dataclasses.is_dataclass(xs[0]):
            return type(xs[0])(**{
                f.name: cat(*(getattr(x, f.name) for x in xs))
                for f in dataclasses.fields(xs[0])
            })
        return torch.cat(xs, dim=0)

    return cat(*branches)


class MultiPersonPoseNetSSV(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        if c.NETWORK.USE_GT or c.NETWORK.TRAIN_ONLY_2D or c.NETWORK.TRAIN_ONLY_ROOTNET:
            raise NotImplementedError(
                "only the RootNet + PoseNet path (inference and SSV training) is ported"
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
        if c.WITH_ATTN:
            self.attn = PoseResAttnNet(
                num_layers=c.ATTN_NUM_LAYERS, num_joints=J, dtype=dtype
            )
        self.root_net = RootNet(
            space_size=c.MULTI_PERSON.SPACE_SIZE,
            space_center=c.MULTI_PERSON.SPACE_CENTER,
            cube_size=c.MULTI_PERSON.INITIAL_CUBE_SIZE,
            image_wh=c.NETWORK.IMAGE_SIZE,
            in_channels=1 if c.NETWORK.ROOTNET_ROOTHM else J,
            max_people=c.MULTI_PERSON.MAX_PEOPLE_NUM,
            threshold=c.MULTI_PERSON.THRESHOLD,
            syn_range=c.NETWORK.ROOTNET_SYN_RANGE,
            hm_sigma=float(c.NETWORK.SIGMA),
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

    def heatmaps(self, branch: AugBranch, fold: bool = False) -> torch.Tensor:
        """Backbone -> (B, V, Hh, Wh, J) float32.

        Inference runs the views one after another, so only one view's
        activations are live at a time. ``fold`` (training) runs (B, V) as
        one batch, so train-mode BatchNorm statistics pool over all of it."""
        if branch.views is None:
            return branch.input_heatmaps
        if fold:
            B, V = branch.views.shape[:2]
            hm = self.backbone(branch.views.flatten(0, 1))
            return hm.reshape(B, V, *hm.shape[1:])
        return torch.stack(
            [self.backbone(branch.views[:, v]) for v in range(branch.views.shape[1])],
            dim=1,
        )

    def attns(self, branch: AugBranch) -> torch.Tensor:
        """Attention net on the folded (B, V) batch -> (B, V, Hh, Wh, J) in [0, 1]."""
        B, V = branch.views.shape[:2]
        a = self.attn(branch.views.flatten(0, 1))
        return a.reshape(B, V, *a.shape[1:])

    def root_heatmaps(self, heatmaps: torch.Tensor) -> torch.Tensor:
        """The root-joint channel when ROOTNET_ROOTHM, detached: RootNet
        never trains the backbone (ref: cuboid_proposal_net_soft.py:129-135)."""
        if self.cfg.NETWORK.ROOTNET_ROOTHM:
            rid = self.cfg.DATASET.ROOTIDX
            return heatmaps[..., rid : rid + 1].detach()
        return heatmaps

    @torch.no_grad()
    def do_inference(self, branch: AugBranch):
        """-> (pred (B, K, J, 5), heatmaps (B, V, H, W, J), grid_centers (B, K, 5)).

        pred[..., :3] are world-mm joints (zero for invalid candidates),
        pred[..., 3:] each candidate's (flag, score). Always runs with the
        running BatchNorm statistics: it puts the model in eval mode.
        """
        self.eval()
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

    def _l1_matching_loss(
        self,
        kps_2d: torch.Tensor,
        cand_valid: torch.Tensor,
        joints: torch.Tensor,
        joints_vis: torch.Tensor,
    ) -> torch.Tensor:
        """Hungarian-matched normalised L1 (ref: multi_person_posenet_ssv.py:155-194).

        Args:
          kps_2d:     (B, V, K, J, 2) projected candidate joints (pixels).
          cand_valid: (B, K)
          joints:     (B, V, P, J, 2) pseudo-label joints.
          joints_vis: (B, V, P, J, 2)
        """
        c = self.cfg
        norm = torch.tensor(
            [float(c.NETWORK.IMAGE_SIZE[0]), float(c.NETWORK.IMAGE_SIZE[1])],
            dtype=torch.float32, device=kps_2d.device,
        )
        pred_n = kps_2d / norm
        tgt_n = joints / norm
        # a pseudo-label person is valid when any joint coordinate is nonzero
        gt_valid = joints.abs().sum(dim=(-1, -2)) != 0  # (B, V, P)
        # cost[b, v, t, p] = mean_{j, c} |pred_p - tgt_t| * vis_t
        diff = (pred_n[:, :, None] - tgt_n[:, :, :, None]).abs()  # (B, V, P, K, J, 2)
        cost = (diff * joints_vis[:, :, :, None]).mean(dim=(-1, -2))
        B, V, P, K = cost.shape
        M = max(P, K)  # pad to the square solver's size
        sq = cost.new_zeros((B * V, M, M))
        sq[:, :P, :K] = cost.reshape(B * V, P, K)
        rmask = torch.zeros((B * V, M), dtype=torch.bool, device=cost.device)
        rmask[:, :P] = gt_valid.reshape(B * V, P)
        cmask = torch.zeros((B * V, M), dtype=torch.bool, device=cost.device)
        cmask[:, :K] = (cand_valid > 0)[:, None, :].expand(B, V, K).reshape(B * V, K)
        losses = masked_assignment_cost(sq, rmask, cmask)  # (B*V,); 0 where no pair
        if c.L1_ATTN:
            # drop the single worst view-sample term (ref: :187-191), the
            # first one among equals
            worst = int(torch.nonzero(losses.detach() == losses.detach().max())[0])
            keep = torch.ones_like(losses)
            keep[worst] = 0.0
            return (losses * keep).sum() / (losses.shape[0] - 1)
        return losses.mean()

    def _set_modes(self, net_train: bool) -> None:
        """Module modes of one ``ssv_losses`` call: BatchNorm of a net uses
        batch statistics only where the JAX package passes ``train=True``."""
        c = self.cfg
        if c.BACKBONE_MODEL:
            self.backbone.train(net_train and c.NETWORK.TRAIN_BACKBONE)
        if c.WITH_ATTN:
            self.attn.train(net_train)
        self.root_net.train(net_train and not c.NETWORK.FREEZE_ROOTNET)
        self.pose_net.train(net_train)

    def ssv_losses(
        self,
        branch1: AugBranch,
        branch2: AugBranch,
        branch3: AugBranch,
        train_posenet_stage: bool = True,
        use_l1_stage: bool = False,
        train: bool = True,
        synth_inject: Optional[dict] = None,
        bn_eval: bool = False,
        attn_inject: Optional[torch.Tensor] = None,
        k_cap: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """The six SSV loss terms (ref: multi_person_posenet_ssv.py:197-501).

        ``train_posenet_stage`` / ``use_l1_stage`` are the epoch gates
        (epoch >= INIT_TRAIN_EPOCHS_ROOTNET / L1_EPOCH). ``k_cap`` cuts the
        score-sorted proposals handed to PoseNet. ``bn_eval`` keeps the
        train-stage loss composition but runs every BatchNorm on its running
        statistics; ``synth_inject`` and ``attn_inject`` replace the random
        synthetic-root draws and the attention maps (2B, V, Hh, Wh, J) with
        given values (parity tests). ``generator`` feeds the synthetic-root
        draws otherwise. Sets the sub-networks' train/eval modes.

        Returns (pred2 (B, K, J, 5) or None, heatmaps3, grid_centers, losses).
        """
        c = self.cfg
        if c.NETWORK.USE_GT or c.NETWORK.SINGLE_AUG_TRAINING_POSENET:
            raise NotImplementedError("USE_GT / SINGLE_AUG_TRAINING_POSENET are not ported")
        losses: Dict[str, torch.Tensor] = {}
        B = branch1.batch_size
        net_train = train and not bn_eval
        self._set_modes(net_train)

        branches_all = cat_branches(branch1, branch2, branch3)  # (3B, ...)
        heatmaps_all = self.heatmaps(branches_all, fold=net_train)  # (3B, V, H, W, J)
        heatmaps1, heatmaps2, heatmaps3 = heatmaps_all.split(B, dim=0)
        zero = heatmaps_all.new_zeros(())

        branches_12 = cat_branches(branch1, branch2)  # (2B, ...)
        if c.WITH_ATTN:
            attns_12 = attn_inject if attn_inject is not None else self.attns(branches_12)

        # ---- 2D heatmap loss vs pseudo labels (ref: :281-290); equal-size
        # branches: the mse over the fold is the mean of the 3 mses
        losses["loss_2d"] = (
            _mse(branches_all.target_2d, heatmaps_all) if branch1.target_2d is not None else zero
        )

        # ---- RootNet (ref: :297-335)
        hm_wh = (heatmaps_all.shape[3], heatmaps_all.shape[2])
        if c.NETWORK.FREEZE_ROOTNET:
            with torch.no_grad():
                _, grid_centers = self.root_net(
                    self.root_heatmaps(heatmaps3), branch3.cam, branch3.trans,
                    branch3.orig_wh, hflip=branch3.hflip,
                )
        else:
            main_all, gc_all = self.root_net(
                self.root_heatmaps(heatmaps_all), branches_all.cam, branches_all.trans,
                branches_all.orig_wh, hflip=branches_all.hflip,
            )
            grid_centers = gc_all[2 * B :]
            main12, main3 = main_all[: 2 * B], main_all[2 * B :]
            if c.NETWORK.ROOTNET_TRAIN_SYNTH and train:
                # groups=3: an independent root count per folded branch, as
                # the reference's three per-branch calls draw
                syn_all, tgt_all = self.root_net.train_synth(
                    branches_all.cam, branches_all.trans, branches_all.orig_wh, hm_wh,
                    hflip=branches_all.hflip, groups=3, inject=synth_inject,
                    generator=generator,
                )
                # the sum of the 3 branch mses == 3 * the mse over the fold
                losses["loss_root_syn"] = c.NETWORK.WEIGHT_ROOT_SYN * (
                    3.0 * _mse(syn_all, tgt_all)
                )
                if c.NETWORK.ROOT_CONSISTENCY_LOSS:
                    main3_sg = main3.detach()
                    losses["loss_root_reg"] = c.NETWORK.WEIGHT_ROOT_REG * (
                        2.0 * _mse(main12, torch.cat([main3_sg, main3_sg], dim=0))
                    )
            else:
                # supervised 3D-cube loss variant (ref: :331-335)
                tgt12 = torch.cat([branch1.target_3d, branch2.target_3d], dim=0)
                losses["loss_root_reg"] = 2.0 * _mse(main12, tgt12)

        # ---- PoseNet + cross-augmentation projection losses (ref: :340-499)
        K = c.MULTI_PERSON.MAX_PEOPLE_NUM
        J = c.NETWORK.NUM_JOINTS
        V = branch1.num_views
        Kp = int(k_cap) if k_cap else K
        gc_pose = grid_centers[:, :Kp]
        if not train_posenet_stage:
            losses["loss_pose3d_ssv"] = zero
            return None, heatmaps3, grid_centers, losses

        # one PoseNet pass over both augmented branches (2B)
        pred_12, valid_12 = self.pose_net(
            torch.cat([heatmaps1, heatmaps2], dim=0), branches_12.cam, branches_12.trans,
            branches_12.orig_wh, torch.cat([gc_pose, gc_pose], dim=0),
            hflip=branches_12.hflip, bucketed=False,
        )
        pred1, pred2 = pred_12[:B], pred_12[B:]
        valid = valid_12[:B]
        any_valid = (valid.sum() > 0).to(torch.float32)

        # cross-projection: pred2 into branch1's frame, pred1 into branch2's
        # (ref: :432-437); the cameras are shared, trans and hflip differ
        pred_cross = torch.cat([pred2, pred1], dim=0)  # (2B, Kp, J, 3)
        kps_cross = project_points_with_trans(
            pred_cross.reshape(2 * B, 1, Kp * J, 3), branches_12.cam, branches_12.trans
        ).reshape(2 * B, V, Kp, J, 2)
        hm_cross = render_gaussian_heatmaps(
            kps_cross, hm_wh, sigma=3.0, coord_scale=0.25,
            mask=valid_12[:, None].expand(2 * B, V, Kp),
        ).permute(0, 1, 3, 4, 2)  # (2B, V, H, W, J): rows [:B] pred2 in frame 1
        targets_12 = branches_12.target_2d
        if c.WITH_ATTN:
            losses["loss_pose3d_ssv"] = (
                2.0 * torch.mean(((targets_12 - hm_cross) ** 2) * attns_12)
            ) * any_valid
            losses["loss_attn_ssv"] = (
                2.0 * _mse(attns_12, torch.ones_like(attns_12))
            ) * c.ATTN_WEIGHT * any_valid
        else:
            losses["loss_pose3d_ssv"] = (2.0 * _mse(targets_12, hm_cross)) * any_valid

        if c.USE_L1 and use_l1_stage:
            kps21, kps12 = kps_cross[:B], kps_cross[B:]
            losses["loss_pose3d_l1_ssv"] = (
                self._l1_matching_loss(kps12, valid, branch2.joints, branch2.joints_vis)
                + self._l1_matching_loss(kps21, valid, branch1.joints, branch1.joints_vis)
            ) * c.L1_WEIGHT * any_valid

        pred2_out = torch.cat(
            [pred2, gc_pose[:, :, None, 3:].expand(B, Kp, J, 2)], dim=-1
        ).detach()
        if Kp < K:  # fixed (B, K, J, 5) output shape
            pred2_out = torch.nn.functional.pad(pred2_out, (0, 0, 0, 0, 0, K - Kp))
        return pred2_out, heatmaps3, grid_centers, losses
