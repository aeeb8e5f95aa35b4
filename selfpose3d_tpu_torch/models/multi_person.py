"""The top-level multi-person pose models.

MultiPersonPoseNetSSV, the SelfPose3d model (ref:
lib/models/multi_person_posenet_ssv.py:29-501): per-view backbone heatmaps
-> RootNet proposals -> per-candidate PoseNet (``do_inference``), and the
self-supervised loss terms of one train step (``ssv_losses``): the three
augmentation branches are folded into the batch axis, as in
``selfpose3d_tpu.models.multi_person``, so the backbone runs once on 3B,
the attention net once on 2B, RootNet main and synthetic passes on 3B and
PoseNet once on 2B. Train-mode BatchNorm statistics pool over each fold.
The stage flags of the paper's three SSL stages (NETWORK.TRAIN_ONLY_2D,
TRAIN_ONLY_ROOTNET, USE_GT, SINGLE_AUG_TRAINING_POSENET) select which
sub-networks exist and which terms are computed.

MultiPersonPoseNet, the supervised VoxelPose baseline (ref:
lib/models/multi_person_posenet.py:20-111): one branch, 2D heatmap, 3D
root-cube and GT-matched pose losses (``forward``).

A sub-network the JAX model never calls under the flags is not built, so
the state dict's keys are those ``convert/from_jax.py`` gives for the JAX
variables. Every ``stop_gradient`` of the JAX package is a ``detach()``
here.

Across W > 1 ranks (``parallel/mesh.py``) a training call computes its
terms over the global batch, as the JAX package's one program over a
sharded batch does: a gate (``any_valid``) is reduced with MAX, a ratio
contributes ``W * local numerator / global denominator`` on each rank, so
that DDP's mean over ranks is the global ratio, and no gradient passes
through a count. Calls with ``train=False`` stay local.
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
from selfpose3d_tpu_torch.ops.proposal import match_proposals_to_gt
from selfpose3d_tpu_torch.parallel import mesh
from selfpose3d_tpu_torch.utils import spans


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def _any_valid(valid: torch.Tensor, across: bool) -> torch.Tensor:
    """1.0 where any candidate is valid (on any rank ``across`` them), else 0.0."""
    gate = (valid.sum() > 0).to(torch.float32)
    return mesh.all_reduce_max(gate) if across else gate


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


def branch_rows(branch: AugBranch, start: int, stop: int) -> AugBranch:
    """Rows [start, stop) of a branch, field by field (a rank's part of a
    global batch)."""

    def rows(x):
        if x is None:
            return None
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: rows(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return x[start:stop]

    return rows(branch)


def _backbone(c: Config, dtype: torch.dtype) -> PoseResNet:
    return PoseResNet(
        num_layers=c.POSE_RESNET.NUM_LAYERS,
        num_joints=c.NETWORK.NUM_JOINTS,
        deconv_filters=tuple(c.POSE_RESNET.NUM_DECONV_FILTERS),
        deconv_kernels=tuple(c.POSE_RESNET.NUM_DECONV_KERNELS),
        final_conv_kernel=c.POSE_RESNET.FINAL_CONV_KERNEL,
        deconv_with_bias=c.POSE_RESNET.DECONV_WITH_BIAS,
        dtype=dtype,
    )


def _root_net(c: Config, dtype: torch.dtype) -> RootNet:
    return RootNet(
        space_size=c.MULTI_PERSON.SPACE_SIZE,
        space_center=c.MULTI_PERSON.SPACE_CENTER,
        cube_size=c.MULTI_PERSON.INITIAL_CUBE_SIZE,
        image_wh=c.NETWORK.IMAGE_SIZE,
        in_channels=1 if c.NETWORK.ROOTNET_ROOTHM else c.NETWORK.NUM_JOINTS,
        max_people=c.MULTI_PERSON.MAX_PEOPLE_NUM,
        threshold=c.MULTI_PERSON.THRESHOLD,
        syn_range=c.NETWORK.ROOTNET_SYN_RANGE,
        hm_sigma=float(c.NETWORK.SIGMA),
        dtype=dtype,
    )


def _pose_net(c: Config, dtype: torch.dtype) -> PoseNet:
    return PoseNet(
        grid_size=c.PICT_STRUCT.GRID_SIZE,
        cube_size=c.PICT_STRUCT.CUBE_SIZE,
        image_wh=c.NETWORK.IMAGE_SIZE,
        num_joints=c.NETWORK.NUM_JOINTS,
        beta=c.NETWORK.BETA,
        buckets=tuple(c.MULTI_PERSON.CANDIDATE_BUCKETS),
        dtype=dtype,
    )


@spans.span("sp3d.backbone")
def backbone_heatmaps(backbone: nn.Module, branch: AugBranch, fold: bool) -> torch.Tensor:
    """Backbone -> (B, V, Hh, Wh, J) float32; the given heatmaps where the
    branch has no images.

    ``fold`` runs (B, V) as one batch, so train-mode BatchNorm statistics
    pool over all of it; otherwise the views run one after another, so
    only one view's activations are live at a time."""
    if branch.views is None:
        return branch.input_heatmaps
    if fold:
        B, V = branch.views.shape[:2]
        hm = backbone(branch.views.flatten(0, 1))
        return hm.reshape(B, V, *hm.shape[1:])
    return torch.stack(
        [backbone(branch.views[:, v]) for v in range(branch.views.shape[1])], dim=1
    )


def gt_grid_centers(branch: AugBranch, K: int) -> torch.Tensor:
    """Candidate slots from the GT roots (ref: multi_person_posenet_ssv.py:124-131):
    (B, K, 5), slot k holds GT root k with flag k and score 1 where
    k < num_person, flag -1 and score 0 elsewhere."""
    B = branch.batch_size
    roots = branch.roots_3d[:, :K]
    gc = roots.new_zeros((B, K, 5))
    gc[:, : roots.shape[1], 0:3] = roots
    slot = torch.arange(K, dtype=torch.float32, device=roots.device)[None]
    is_person = slot < branch.num_person[:, None].to(torch.float32)
    gc[:, :, 3] = torch.where(is_person, slot, torch.full_like(slot, -1.0))
    gc[:, :, 4] = is_person.to(torch.float32)
    return gc


class MultiPersonPoseNetSSV(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        if c.BACKBONE_MODEL:
            self.backbone = _backbone(c, dtype)
        if c.WITH_ATTN:
            self.attn = PoseResAttnNet(
                num_layers=c.ATTN_NUM_LAYERS, num_joints=c.NETWORK.NUM_JOINTS, dtype=dtype
            )
        if not (c.NETWORK.USE_GT or c.NETWORK.TRAIN_ONLY_2D):
            self.root_net = _root_net(c, dtype)
        if not (c.NETWORK.TRAIN_ONLY_2D or c.NETWORK.TRAIN_ONLY_ROOTNET):
            self.pose_net = _pose_net(c, dtype)

    def heatmaps(self, branch: AugBranch, fold: bool = False) -> torch.Tensor:
        """Backbone -> (B, V, Hh, Wh, J) float32 (``backbone_heatmaps``);
        ``fold`` in training."""
        return backbone_heatmaps(getattr(self, "backbone", None), branch, fold)

    @spans.span("sp3d.attn")
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

    @spans.span("sp3d.infer")
    @torch.no_grad()
    def do_inference(self, branch: AugBranch, visualize_attn: bool = False):
        """-> (pred (B, K, J, 5), heatmaps (B, V, H, W, J), grid_centers (B, K, 5)
        [, attns (B, V, H, W, J) when ``visualize_attn``]).

        pred[..., :3] are world-mm joints (zero for invalid candidates, and
        everywhere under TRAIN_ONLY_ROOTNET, TRAIN_ONLY_2D or
        EVAL_ROOTNET_ONLY, where PoseNet does not run), pred[..., 3:] each
        candidate's (flag, score); the candidates are the GT roots under
        USE_GT or TRAIN_ONLY_2D. Always runs with the running BatchNorm
        statistics: it puts the model in eval mode.
        """
        self.eval()
        c = self.cfg
        heatmaps = self.heatmaps(branch)
        B = heatmaps.shape[0]
        K = c.MULTI_PERSON.MAX_PEOPLE_NUM
        J = c.NETWORK.NUM_JOINTS
        if c.NETWORK.USE_GT or c.NETWORK.TRAIN_ONLY_2D:
            grid_centers = gt_grid_centers(branch, K)
        else:
            _, grid_centers = self.root_net(
                self.root_heatmaps(heatmaps), branch.cam, branch.trans, branch.orig_wh
            )
        pred = torch.zeros((B, K, J, 5), dtype=torch.float32, device=heatmaps.device)
        pred[..., 3:] = grid_centers[:, :, None, 3:]
        if not (c.EVAL_ROOTNET_ONLY or c.NETWORK.TRAIN_ONLY_ROOTNET or c.NETWORK.TRAIN_ONLY_2D):
            poses, _ = self.pose_net(
                heatmaps, branch.cam, branch.trans, branch.orig_wh, grid_centers
            )
            pred[..., 0:3] = poses
        if visualize_attn:
            return pred, heatmaps, grid_centers, self.attns(branch)
        return pred, heatmaps, grid_centers

    def _l1_matching_loss(
        self,
        kps_2d: torch.Tensor,
        cand_valid: torch.Tensor,
        joints: torch.Tensor,
        joints_vis: torch.Tensor,
        across: bool = False,
    ) -> torch.Tensor:
        """Hungarian-matched normalised L1 (ref: multi_person_posenet_ssv.py:155-194).
        ``across`` ranks, L1_ATTN drops the worst term of the global
        (W*B*V,) vector, the first among equals in rank order.

        Args:
          kps_2d:     (B, V, K, J, 2) projected candidate joints (pixels).
          cand_valid: (B, K)
          joints:     (B, V, P, J, 2) pseudo-label joints.
          joints_vis: (B, V, P, J, 2)
        """
        c = self.cfg
        spans.count("host_syncs.l1_norm")  # a blocking copy of a host list
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
            d = losses.detach()
            keep = torch.ones_like(losses)
            if not across:
                # a nonzero, the index read, and the zero copied in from the host
                spans.count("host_syncs.l1_attn", 3)
                keep[int(torch.nonzero(d == d.max())[0])] = 0.0
                return (losses * keep).sum() / (losses.shape[0] - 1)
            W, r = mesh.world(), mesh.rank()
            top = d.max()
            held = top == mesh.all_reduce_max(top)
            # the first rank holding the global worst term drops it
            spans.count("host_syncs.l1_attn")
            first = -int(mesh.all_reduce_max(torch.where(held, -r, -W).to(torch.int64)))
            if first == r:
                spans.count("host_syncs.l1_attn", 3)
                keep[int(torch.nonzero(d == top)[0])] = 0.0
            return W * (losses * keep).sum() / (W * losses.shape[0] - 1)
        return losses.mean()

    def _set_modes(self, net_train: bool) -> None:
        """Module modes of one ``ssv_losses`` call: BatchNorm of a net uses
        batch statistics only where the JAX package passes ``train=True``."""
        c = self.cfg
        if c.BACKBONE_MODEL:
            self.backbone.train(net_train and c.NETWORK.TRAIN_BACKBONE)
        if c.WITH_ATTN:
            self.attn.train(net_train)
        if hasattr(self, "root_net"):
            self.root_net.train(net_train and not c.NETWORK.FREEZE_ROOTNET)
        if hasattr(self, "pose_net"):
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

        The stage flags: TRAIN_ONLY_2D returns after ``loss_2d`` (no
        prediction, no candidates); USE_GT takes branch 3's GT roots as the
        candidates; TRAIN_ONLY_ROOTNET returns after RootNet;
        SINGLE_AUG_TRAINING_POSENET runs PoseNet on branch 1 alone, against
        its own pseudo heatmaps.

        Returns (pred2 (B, K, J, 5) or None, heatmaps3, grid_centers or
        None, losses).
        """
        c = self.cfg
        losses: Dict[str, torch.Tensor] = {}
        B = branch1.batch_size
        net_train = train and not bn_eval
        across = train and mesh.world() > 1
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
        if c.NETWORK.TRAIN_ONLY_2D:
            return None, heatmaps3, None, losses

        # ---- RootNet (ref: :297-335)
        hm_wh = (heatmaps_all.shape[3], heatmaps_all.shape[2])
        if c.NETWORK.USE_GT:
            grid_centers = gt_grid_centers(branch3, c.MULTI_PERSON.MAX_PEOPLE_NUM)
        elif c.NETWORK.FREEZE_ROOTNET:
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
        if c.NETWORK.TRAIN_ONLY_ROOTNET:
            return None, heatmaps3, grid_centers, losses

        # ---- PoseNet + cross-augmentation projection losses (ref: :340-499)
        K = c.MULTI_PERSON.MAX_PEOPLE_NUM
        J = c.NETWORK.NUM_JOINTS
        V = branch1.num_views
        Kp = int(k_cap) if k_cap else K
        gc_pose = grid_centers[:, :Kp]
        if not train_posenet_stage:
            losses["loss_pose3d_ssv"] = zero
            return None, heatmaps3, grid_centers, losses

        def pred_out(pred):
            """(B, Kp, J, 3) -> the detached (B, K, J, 5) prediction."""
            out = torch.cat([pred, gc_pose[:, :, None, 3:].expand(B, Kp, J, 2)], dim=-1).detach()
            if Kp < K:  # fixed (B, K, J, 5) output shape
                out = torch.nn.functional.pad(out, (0, 0, 0, 0, 0, K - Kp))
            return out

        if c.NETWORK.SINGLE_AUG_TRAINING_POSENET:
            # PoseNet on branch 1 alone, its projections against branch 1's
            # own pseudo heatmaps: no attention weights, no L1 term
            pred1, valid = self.pose_net(
                heatmaps1, branch1.cam, branch1.trans, branch1.orig_wh, gc_pose,
                hflip=branch1.hflip, bucketed=False,
            )
            with spans.span("sp3d.losses"):
                any_valid = _any_valid(valid, across)
                kps = project_points_with_trans(
                    pred1.reshape(B, 1, Kp * J, 3), branch1.cam, branch1.trans
                ).reshape(B, V, Kp, J, 2)
                hm11 = render_gaussian_heatmaps(
                    kps, hm_wh, sigma=3.0, coord_scale=0.25,
                    mask=valid[:, None].expand(B, V, Kp),
                ).permute(0, 1, 3, 4, 2)
                losses["loss_pose3d_ssv"] = _mse(branch1.target_2d, hm11) * any_valid
            return pred_out(pred1), heatmaps3, grid_centers, losses

        # one PoseNet pass over both augmented branches (2B)
        pred_12, valid_12 = self.pose_net(
            torch.cat([heatmaps1, heatmaps2], dim=0), branches_12.cam, branches_12.trans,
            branches_12.orig_wh, torch.cat([gc_pose, gc_pose], dim=0),
            hflip=branches_12.hflip, bucketed=False,
        )
        with spans.span("sp3d.losses"):
            pred1, pred2 = pred_12[:B], pred_12[B:]
            valid = valid_12[:B]
            any_valid = _any_valid(valid, across)

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
                    self._l1_matching_loss(kps12, valid, branch2.joints, branch2.joints_vis,
                                           across)
                    + self._l1_matching_loss(kps21, valid, branch1.joints, branch1.joints_vis,
                                             across)
                ) * c.L1_WEIGHT * any_valid
        return pred_out(pred2), heatmaps3, grid_centers, losses


class MultiPersonPoseNet(nn.Module):
    """The supervised VoxelPose baseline (ref: lib/models/multi_person_posenet.py)."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        if c.BACKBONE_MODEL:
            self.backbone = _backbone(c, dtype)
        if not (c.NETWORK.USE_GT or c.NETWORK.TRAIN_ONLY_2D):
            self.root_net = _root_net(c, dtype)
        if not c.NETWORK.TRAIN_ONLY_2D:
            self.pose_net = _pose_net(c, dtype)

    def _set_modes(self, train: bool) -> None:
        c = self.cfg
        if c.BACKBONE_MODEL:
            self.backbone.train(train and c.NETWORK.TRAIN_BACKBONE)
        for net in ("root_net", "pose_net"):
            if hasattr(self, net):
                getattr(self, net).train(train)

    def forward(self, branch: AugBranch, train: bool = False):
        """-> (pred (B, K, J, 5) or None, heatmaps (B, V, H, W, J),
        grid_centers (B, K, 5) or None, losses).

        The loss terms: ``loss_2d``, the target-weighted heatmap MSE;
        ``loss_3d``, the root cubes' MSE against ``target_3d`` (RootNet runs
        on channel DATASET.ROOTIDX_PSEUDO under ROOTNET_ROOTHM, on all J
        otherwise, and its heatmaps are not detached); in training,
        ``loss_cord``, the visibility-weighted L1 of each valid candidate's
        pose against the GT pose it was matched to, averaged over the valid
        candidates. In training with GT the candidates' flags are their
        matched GT indices (``match_proposals_to_gt``). TRAIN_ONLY_2D
        returns after ``loss_2d``; USE_GT takes the GT roots as the
        candidates. Sets the sub-networks' train/eval modes (the backbone
        trains only under NETWORK.TRAIN_BACKBONE); autograd stays as the
        caller has it. A call with ``train=False`` is the span
        ``sp3d.infer``; in training the train step's span holds the call.
        """
        if train:
            return self._forward(branch, True)
        with spans.span("sp3d.infer"):
            return self._forward(branch, False)

    def _forward(self, branch: AugBranch, train: bool):
        c = self.cfg
        self._set_modes(train)
        heatmaps = backbone_heatmaps(getattr(self, "backbone", None), branch, fold=train)
        B = heatmaps.shape[0]
        losses: Dict[str, torch.Tensor] = {}
        if branch.target_2d is None:
            losses["loss_2d"] = heatmaps.new_zeros(())
        elif branch.weights_2d is not None:
            # per-joint MSE with target weights (ref: loss.py:39-55, model :50-55)
            w = branch.weights_2d[:, :, None, None, :, 0]  # (B, V, 1, 1, J)
            losses["loss_2d"] = torch.mean(((heatmaps - branch.target_2d) * w) ** 2)
        else:
            losses["loss_2d"] = _mse(heatmaps, branch.target_2d)
        if c.NETWORK.TRAIN_ONLY_2D:
            return None, heatmaps, None, losses

        K = c.MULTI_PERSON.MAX_PEOPLE_NUM
        J = c.NETWORK.NUM_JOINTS
        if c.NETWORK.USE_GT:
            grid_centers = gt_grid_centers(branch, K)
        else:
            rid = c.DATASET.ROOTIDX_PSEUDO
            root_hm = heatmaps[..., rid : rid + 1] if c.NETWORK.ROOTNET_ROOTHM else heatmaps
            root_cubes, grid_centers = self.root_net(
                root_hm, branch.cam, branch.trans, branch.orig_wh
            )
            if branch.target_3d is not None:
                losses["loss_3d"] = _mse(root_cubes, branch.target_3d)
            if train and branch.roots_3d is not None and branch.num_person is not None:
                flag = match_proposals_to_gt(
                    grid_centers[..., :3], branch.roots_3d, branch.num_person
                )
                grid_centers = torch.cat(
                    [grid_centers[..., :3], flag[..., None], grid_centers[..., 4:]], dim=-1
                )

        pred = torch.zeros((B, K, J, 5), dtype=torch.float32, device=heatmaps.device)
        pred[..., 3:] = grid_centers[:, :, None, 3:]
        # the candidate buckets cover the highest valid slot, so the holes
        # the GT matching leaves are safe
        poses, valid = self.pose_net(
            heatmaps, branch.cam, branch.trans, branch.orig_wh, grid_centers
        )
        pred[..., 0:3] = poses.detach()

        # weighted L1 against the matched GT poses (ref: multi_person_posenet.py:84-100)
        if train and branch.joints_3d is not None:
            with spans.span("sp3d.losses"):
                gt_idx = grid_centers[..., 3].clamp(min=0).to(torch.int64)[..., None, None]
                gt = torch.gather(branch.joints_3d, 1, gt_idx.expand(B, K, J, 3))
                w = torch.gather(branch.joints_3d_vis[..., 0:1], 1, gt_idx.expand(B, K, J, 1))
                per_cand = (poses * w - gt * w).abs().mean(dim=(-1, -2))  # (B, K)
                count, scale = valid.sum(), 1.0
                if train and mesh.world() > 1:  # the global batch's mean
                    count, scale = mesh.all_reduce_sum(count.detach()), float(mesh.world())
                losses["loss_cord"] = scale * (per_cand * valid).sum() / count.clamp(min=1.0)
        return pred, heatmaps, grid_centers, losses
