"""Plain PyTorch reference of the SelfPose3d and VoxelPose multi-person models.

Written from the published code (SelfPose3d: lib/models/pose_resnet.py,
v2v_net.py, cuboid_proposal_net_soft.py, pose_regression_net.py,
multi_person_posenet_ssv.py; VoxelPose: multi_person_posenet.py) as
functions over a flat dict of parameters named as the published state
dicts name them. float32 throughout, TF32 off (``Reference`` switches it
off itself, whatever the program set), views
folded into one batch, sampling by ``F.grid_sample(align_corners=True)``,
proposals by ``Tensor.topk``, matching by ``scipy``. It imports nothing of
the program under test.

``fp8=True`` computes in float8 e4m3 (one scale a tensor) where the
program computes in bfloat16: every convolution's input, weight and
output and every BatchNorm's output are rounded to it, as the program
stores them in bfloat16 (the arithmetic between stays float32): the
control that has to fail the comparison.

BatchNorm in train mode normalises with the biased batch statistics and
moves the running averages by 0.1 with the biased variance (flax's rule,
which the port states it follows); an optional mask restricts the
statistics to the valid candidates.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import geometry as geo

EPS = 1e-5
MOMENTUM = 0.1
RESNETS = {18: ("basic", (2, 2, 2, 2)), 50: ("bottleneck", (3, 4, 6, 3))}


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (448 / amax);
    the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).to(x.dtype) / s
    return x + (q - x).detach()


def no_tf32() -> None:
    """float32 matmuls and convolutions in float32: the reference's precision
    is its own, not what the program under test last set."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- parameters

def _conv(spec, name, cin, cout, k, dims, bias, transposed=False):
    ks = (k,) * dims
    shape = (cin, cout) + ks if transposed else (cout, cin) + ks
    spec[name + ".weight"] = (shape, "deconv" if transposed else "conv")
    if bias:
        spec[name + ".bias"] = ((cout,), "bias")


def _bn(spec, name, c, last=False):
    """``last``: the BatchNorm that ends a residual branch (its scale is drawn
    small, ``core/scene.py``)."""
    spec[name + ".weight"] = ((c,), "bn_last" if last else "bn_weight")
    spec[name + ".bias"] = ((c,), "bias")
    spec[name + ".running_mean"] = ((c,), "bias")
    spec[name + ".running_var"] = ((c,), "bn_var")
    spec[name + ".num_batches_tracked"] = ((), "count")


def resnet_spec(spec, pre, layers, joints, deconv_filters, final_k):
    kind, counts = RESNETS[layers]
    _conv(spec, pre + "conv1", 3, 64, 7, 2, False)
    _bn(spec, pre + "bn1", 64)
    cin = 64
    for si, (planes, n) in enumerate(zip((64, 128, 256, 512), counts)):
        for bi in range(n):
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            p = f"{pre}layer{si + 1}.{bi}."
            if kind == "bottleneck":
                cout = planes * 4
                _conv(spec, p + "conv1", cin, planes, 1, 2, False)
                _bn(spec, p + "bn1", planes)
                _conv(spec, p + "conv2", planes, planes, 3, 2, False)
                _bn(spec, p + "bn2", planes)
                _conv(spec, p + "conv3", planes, cout, 1, 2, False)
                _bn(spec, p + "bn3", cout, last=True)
            else:
                cout = planes
                _conv(spec, p + "conv1", cin, planes, 3, 2, False)
                _bn(spec, p + "bn1", planes)
                _conv(spec, p + "conv2", planes, planes, 3, 2, False)
                _bn(spec, p + "bn2", planes, last=True)
            if stride != 1 or cin != cout:
                _conv(spec, p + "downsample.0", cin, cout, 1, 2, False)
                _bn(spec, p + "downsample.1", cout)
            cin = cout
    for i, f in enumerate(deconv_filters):
        _conv(spec, f"{pre}deconv_layers.{3 * i}", cin, f, 4, 2, False, transposed=True)
        _bn(spec, f"{pre}deconv_layers.{3 * i + 1}", f)
        cin = f
    _conv(spec, pre + "final_layer", cin, joints, final_k, 2, True)


def _res_spec(spec, p, cin, cout):
    _conv(spec, p + "res_branch.0", cin, cout, 3, 3, True)
    _bn(spec, p + "res_branch.1", cout)
    _conv(spec, p + "res_branch.3", cout, cout, 3, 3, True)
    _bn(spec, p + "res_branch.4", cout, last=True)
    if cin != cout:
        _conv(spec, p + "skip_con.0", cin, cout, 1, 3, True)
        _bn(spec, p + "skip_con.1", cout)


V2V_RES = (("skip_res1", 32, 32), ("encoder_res1", 32, 64), ("skip_res2", 64, 64),
           ("encoder_res2", 64, 128), ("mid_res", 128, 128), ("decoder_res2", 128, 128),
           ("decoder_res1", 64, 64))


def v2v_spec(spec, pre, cin, cout):
    _conv(spec, pre + "front_layers.0.block.0", cin, 16, 7, 3, True)
    _bn(spec, pre + "front_layers.0.block.1", 16)
    _res_spec(spec, pre + "front_layers.1.", 16, 32)
    e = pre + "encoder_decoder."
    for name, a, b in V2V_RES:
        _res_spec(spec, f"{e}{name}.", a, b)
    for name, a, b in (("decoder_upsample2", 128, 64), ("decoder_upsample1", 64, 32)):
        _conv(spec, f"{e}{name}.block.0", a, b, 2, 3, True, transposed=True)
        _bn(spec, f"{e}{name}.block.1", b)
    _conv(spec, pre + "output_layer", 32, cout, 1, 3, True)


def param_spec(cfg) -> Dict[str, tuple]:
    """name -> (shape, kind) of every parameter and buffer of the model the
    configuration describes (the published state-dict names)."""
    spec: Dict[str, tuple] = {}
    J = cfg.joints
    resnet_spec(spec, "backbone.", cfg.layers, J, cfg.deconv_filters, cfg.final_k)
    if cfg.ssv and cfg.with_attn:
        resnet_spec(spec, "attn.backbone.", cfg.attn_layers, J, (256, 256, 256), 1)
    v2v_spec(spec, "root_net.v2v_net.", cfg.root_in, 1)
    v2v_spec(spec, "pose_net.v2v_net.", J, J)
    spec["pose_net.v2v_net.output_layer.weight"] = (spec["pose_net.v2v_net.output_layer.weight"][0],
                                                    "conv_score")
    return spec


# ---------------------------------------------------------------- the nets

class Reference:
    """The model's functions over the parameters ``P`` (name -> tensor).

    ``stats`` receives the running statistics that train-mode BatchNorm
    moves (name -> new tensor); ``P`` itself is never written."""

    def __init__(self, cfg, P: Dict[str, torch.Tensor], fp8: bool = False):
        self.cfg, self.P, self.fp8 = cfg, P, fp8
        no_tf32()
        self.stats: Dict[str, torch.Tensor] = {}

    def conv(self, x, name, stride=1, pad=0, transposed=False):
        w, b = self.P[name + ".weight"], self.P.get(name + ".bias")
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        if x.dim() == 4:
            f = F.conv_transpose2d if transposed else F.conv2d
        else:
            f = F.conv_transpose3d if transposed else F.conv3d
        y = f(x, w, b, stride, pad)
        return fp8_round(y) if self.fp8 else y

    def bn(self, x, name, train, mask=None):
        P = self.P
        shape = (1, -1) + (1,) * (x.dim() - 2)
        w, b = P[name + ".weight"].view(shape), P[name + ".bias"].view(shape)
        if not train:
            rm = P[name + ".running_mean"].view(shape)
            rv = P[name + ".running_var"].view(shape)
            y = (x - rm) * torch.rsqrt(rv + EPS) * w + b
            return fp8_round(y) if self.fp8 else y
        dims = [0] + list(range(2, x.dim()))
        xs = x if mask is None else x[mask]
        var, mean = torch.var_mean(xs, dim=dims, unbiased=False)
        y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + EPS) * w + b
        for key, new in (("running_mean", mean), ("running_var", var)):
            old = self.stats.get(f"{name}.{key}", P[f"{name}.{key}"])
            self.stats[f"{name}.{key}"] = (1 - MOMENTUM) * old + MOMENTUM * new.detach()
        return fp8_round(y) if self.fp8 else y

    # ---- ResNet + deconv head (NCHW in, NCHW out)
    def resnet(self, x, pre, layers, train):
        kind, counts = RESNETS[layers]
        bn = lambda t, n: self.bn(t, pre + n, train)  # noqa: E731
        x = F.relu(bn(self.conv(x, pre + "conv1", 2, 3), "bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        cin = 64
        for si, (planes, n) in enumerate(zip((64, 128, 256, 512), counts)):
            for bi in range(n):
                stride = (1 if si == 0 else 2) if bi == 0 else 1
                p = f"layer{si + 1}.{bi}."
                if kind == "bottleneck":
                    cout = planes * 4
                    y = F.relu(bn(self.conv(x, pre + p + "conv1"), p + "bn1"))
                    y = F.relu(bn(self.conv(y, pre + p + "conv2", stride, 1), p + "bn2"))
                    y = bn(self.conv(y, pre + p + "conv3"), p + "bn3")
                else:
                    cout = planes
                    y = F.relu(bn(self.conv(x, pre + p + "conv1", stride, 1), p + "bn1"))
                    y = bn(self.conv(y, pre + p + "conv2", 1, 1), p + "bn2")
                if stride != 1 or cin != cout:
                    x = bn(self.conv(x, pre + p + "downsample.0", stride), p + "downsample.1")
                x = F.relu(y + x)
                cin = cout
        i = 0
        while f"{pre}deconv_layers.{3 * i}.weight" in self.P:
            x = self.conv(x, f"{pre}deconv_layers.{3 * i}", 2, 1, transposed=True)
            x = F.relu(bn(x, f"deconv_layers.{3 * i + 1}"))
            i += 1
        k = self.P[pre + "final_layer.weight"].shape[-1]
        return self.conv(x, pre + "final_layer", 1, 1 if k == 3 else 0)

    def heatmaps(self, views, train=False, block=40):
        """(B, V, H, W, 3) -> (B, V, H/4, W/4, J), the views as one batch
        (in eval mode ``block`` images at a time, so that a large batch fits;
        train mode's BatchNorm takes the whole batch's statistics)."""
        B, V = views.shape[:2]
        x = views.reshape(B * V, *views.shape[2:]).permute(0, 3, 1, 2)
        if train:
            hm = self.resnet(x, "backbone.", self.cfg.layers, True)
        else:
            hm = torch.cat([self.resnet(x[i:i + block], "backbone.", self.cfg.layers, False)
                            for i in range(0, B * V, block)])
        return hm.permute(0, 2, 3, 1).reshape(B, V, *hm.shape[2:], hm.shape[1])

    def attention(self, views):
        B, V = views.shape[:2]
        x = views.reshape(B * V, *views.shape[2:]).permute(0, 3, 1, 2)
        a = torch.sigmoid(self.resnet(x, "attn.backbone.", self.cfg.attn_layers, True))
        return a.permute(0, 2, 3, 1).reshape(B, V, *a.shape[2:], a.shape[1])

    # ---- V2V (N, C, X, Y, Z)
    def v2v(self, x, pre, train, mask=None):
        bn = lambda t, n: self.bn(t, pre + n, train, mask)  # noqa: E731

        def res(t, p, cin, cout):
            y = F.relu(bn(self.conv(t, pre + p + "res_branch.0", 1, 1), p + "res_branch.1"))
            y = bn(self.conv(y, pre + p + "res_branch.3", 1, 1), p + "res_branch.4")
            if cin != cout:
                t = bn(self.conv(t, pre + p + "skip_con.0"), p + "skip_con.1")
            return F.relu(y + t)

        def up(t, p):
            return F.relu(bn(self.conv(t, pre + p + "block.0", 2, 0, transposed=True), p + "block.1"))

        x = F.relu(bn(self.conv(x, pre + "front_layers.0.block.0", 1, 3), "front_layers.0.block.1"))
        x = res(x, "front_layers.1.", 16, 32)
        e = "encoder_decoder."
        skip1 = res(x, e + "skip_res1.", 32, 32)
        x = res(F.max_pool3d(x, 2), e + "encoder_res1.", 32, 64)
        skip2 = res(x, e + "skip_res2.", 64, 64)
        x = res(F.max_pool3d(x, 2), e + "encoder_res2.", 64, 128)
        x = res(res(x, e + "mid_res.", 128, 128), e + "decoder_res2.", 128, 128)
        x = res(up(x, e + "decoder_upsample2.") + skip2, e + "decoder_res1.", 64, 64)
        x = up(x, e + "decoder_upsample1.") + skip1
        return self.conv(x, pre + "output_layer")

    # ---- unprojection
    @staticmethod
    def view_mean(hm, grid, inside):
        """Bilinear samples of every view at ``grid`` (B, V, N, 2), their
        mean over the views that see the point, clipped to [0, 1] -> (B, N, J)."""
        acc, cnt = 0.0, 0.0
        for v in range(hm.shape[1]):
            s = F.grid_sample(hm[:, v].permute(0, 3, 1, 2), grid[:, v, None],
                              mode="bilinear", padding_mode="zeros", align_corners=True)
            acc = acc + s[:, :, 0].transpose(1, 2) * inside[:, v, :, None]
            cnt = cnt + inside[:, v]
        return torch.nan_to_num(acc / (cnt[..., None] + 1e-6), nan=0.0).clamp(0.0, 1.0)

    def root_input(self, hm):
        c = self.cfg
        return hm[..., c.root_idx: c.root_idx + 1] if c.root_in == 1 else hm

    def root_cubes(self, hm, cam, trans, orig_wh, hflip=None):
        """Heatmaps (B, V, H, W, J) -> RootNet's volume (B, X, Y, Z)."""
        c = self.cfg
        B, _, H, W, _ = hm.shape
        centre = torch.tensor(c.space_center, device=hm.device)
        pts = geo.voxel_centres(c.space_size, centre, c.root_cube)
        grid, inside = geo.sample_grid(pts[None, None], cam, trans, c.image_wh, (W, H),
                                       orig_wh, hflip)
        cubes = self.view_mean(self.root_input(hm), grid, inside)
        X, Y, Z = c.root_cube
        x = cubes.reshape(B, X, Y, Z, -1).permute(0, 4, 1, 2, 3)
        return self.v2v(x, "root_net.v2v_net.", False)[:, 0]

    def proposals(self, rc, k):
        """NMS (3^3 local maxima) and the top ``k``: values (B, k) and voxel
        indices (B, k, 3)."""
        B, X, Y, Z = rc.shape
        pooled = F.max_pool3d(rc[:, None], 3, 1, 1)[:, 0]
        vals, idx = ((rc == pooled).float() * rc).reshape(B, -1).topk(k, dim=-1)
        return vals, torch.stack([idx // (Y * Z), (idx // Z) % Y, idx % Z], -1)

    def pose_scores(self, hm, cam, trans, orig_wh, centres, valid, train=False, hflip=None):
        """PoseNet's per-voxel joint scores (B*K, J, X, Y, Z) for the cubes
        centred at ``centres`` (B, K, 3); invalid candidates' cubes are zero."""
        c = self.cfg
        B, V, H, W, J = hm.shape
        K = centres.shape[1]
        pts = geo.voxel_centres(c.grid_size, centres, c.pose_cube)  # (B, K, N, 3)
        grid, inside = geo.sample_grid(pts.reshape(B, 1, -1, 3), cam, trans, c.image_wh, (W, H),
                                       orig_wh, hflip)
        X, Y, Z = c.pose_cube
        cubes = self.view_mean(hm, grid, inside).reshape(B * K, X, Y, Z, J)
        cubes = cubes.permute(0, 4, 1, 2, 3) * valid.reshape(B * K, 1, 1, 1, 1)
        mask = None
        sel = valid.reshape(B * K) > 0
        if train and bool(sel.any()) and not bool(sel.all()):
            mask = sel
        return self.v2v(cubes, "pose_net.v2v_net.", train, mask)

    def axes(self, centres):
        """World axes of each candidate's cube: 3 tensors (B*K, n)."""
        c = self.cfg
        offs = geo.grid_axes(c.grid_size, c.pose_cube, device=centres.device)
        flat = centres.reshape(-1, 3)
        return [flat[:, d, None] + offs[d][None] for d in range(3)]

    def soft_argmax(self, scores, centres):
        """(B*K, J, X, Y, Z) scores -> (B*K, J, 3) expected positions."""
        n = scores.shape[0]
        w = torch.softmax(self.cfg.beta * scores.reshape(n, scores.shape[1], -1), -1)
        w = w.reshape(scores.shape)
        gx, gy, gz = self.axes(centres)
        return torch.stack([(w.sum((3, 4)) * gx[:, None]).sum(-1),
                            (w.sum((2, 4)) * gy[:, None]).sum(-1),
                            (w.sum((2, 3)) * gz[:, None]).sum(-1)], -1)

    # ---- inference
    @torch.no_grad()
    def infer(self, b):
        """-> (pred (B, K, J, 5), heatmaps, grid_centres (B, K, 5)): the
        reference's own proposals and poses."""
        c = self.cfg
        hm = self.heatmaps(b["views"])
        rc = self.root_cubes(hm, b["cam"], b["trans"], b["orig_wh"])
        vals, idx = self.proposals(rc, c.max_people)
        loc = voxel_world(idx, c.space_size, c.space_center, c.root_cube)
        flag = (vals > c.threshold).float() - 1.0
        gc = torch.cat([loc, flag[..., None], vals[..., None]], -1)
        valid = (flag >= 0).float()
        B, K = flag.shape
        poses = torch.cat([self.soft_argmax(self.pose_scores(
            hm[i:i + 1], sub(b["cam"], i), b["trans"][i:i + 1], b["orig_wh"][i:i + 1],
            loc[i:i + 1], valid[i:i + 1]), loc[i:i + 1]) for i in range(B)])
        pred = torch.cat([poses.reshape(B, K, -1, 3) * valid[..., None, None],
                          gc[:, :, None, 3:].expand(B, K, poses.shape[1], 2)], -1)
        return pred, hm, gc

    # ---- the SSV train step's loss terms (RootNet frozen)
    def ssv_losses(self, b1, b2, b3, centres=None):
        """The four SSV terms of cam5_posenet.yaml's stage (FREEZE_ROOTNET,
        the L1 stage): loss_2d, loss_pose3d_ssv, loss_attn_ssv,
        loss_pose3d_l1_ssv (ref: multi_person_posenet_ssv.py:197-501).

        ``centres`` (B, K, 5): candidates to follow in place of the
        reference's own proposals (their locations and flags). The own
        proposals (B, K, 5), RootNet's volume and its sorted top scores are
        kept in ``self.root`` either way."""
        c = self.cfg
        B = b1["views"].shape[0]
        views = torch.cat([b1["views"], b2["views"], b3["views"]])
        hm_all = self.heatmaps(views, train=c.train_backbone)
        hm1, hm2, hm3 = hm_all.split(B)
        attn = self.attention(torch.cat([b1["views"], b2["views"]]))
        tgt_all = torch.cat([b1["target_2d"], b2["target_2d"], b3["target_2d"]])
        losses = {"loss_2d": torch.mean((tgt_all - hm_all) ** 2)}
        with torch.no_grad():
            rc = self.root_cubes(hm3.detach(), b3["cam"], b3["trans"], b3["orig_wh"],
                                 b3["hflip"])
            vals, idx = self.proposals(rc, c.max_people)
            loc = voxel_world(idx, c.space_size, c.space_center, c.root_cube)
            valid = (vals > c.threshold).float()
            own = torch.cat([loc, valid[..., None] - 1.0, vals[..., None]], -1)
            self.root = {"centres": own, "volume": rc, "top": vals}
            if centres is not None:
                loc, valid = centres[..., :3], (centres[..., 3] >= 0).float()
        cam12 = {k: torch.cat([b1["cam"][k], b2["cam"][k]]) for k in b1["cam"]}
        trans12 = torch.cat([b1["trans"], b2["trans"]])
        owh12 = torch.cat([b1["orig_wh"], b2["orig_wh"]])
        flip12 = torch.cat([b1["hflip"], b2["hflip"]])
        loc12, valid12 = torch.cat([loc, loc]), torch.cat([valid, valid])
        scores = self.pose_scores(torch.cat([hm1, hm2]), cam12, trans12, owh12, loc12,
                                  valid12, train=True, hflip=flip12)
        K, J = loc.shape[1], c.joints
        pred12 = self.soft_argmax(scores, loc12).reshape(2 * B, K, J, 3) * valid12[..., None, None]
        pred1, pred2 = pred12[:B], pred12[B:]
        gate = (valid.sum() > 0).float()
        cross = torch.cat([pred2, pred1])
        V = b1["views"].shape[1]
        kps = geo.affine(geo.project(cross.reshape(2 * B, 1, K * J, 3), cam12), trans12)
        kps = kps.reshape(2 * B, V, K, J, 2)
        hm_cross = geo.gaussian_heatmaps(kps, c.heatmap_wh, 3.0,
                                         valid12[:, None].expand(2 * B, V, K))
        hm_cross = hm_cross.permute(0, 1, 3, 4, 2)
        tgt12 = torch.cat([b1["target_2d"], b2["target_2d"]])
        losses["loss_pose3d_ssv"] = 2.0 * torch.mean((tgt12 - hm_cross) ** 2 * attn) * gate
        losses["loss_attn_ssv"] = 2.0 * torch.mean((attn - 1.0) ** 2) * c.attn_weight * gate
        if c.use_l1:
            losses["loss_pose3d_l1_ssv"] = (
                self.l1_matching(kps[B:], valid, b2["joints"], b2["joints_vis"])
                + self.l1_matching(kps[:B], valid, b1["joints"], b1["joints_vis"])
            ) * c.l1_weight * gate
        return losses

    def l1_matching(self, kps, cand_valid, joints, vis):
        """Hungarian-matched normalised L1 between the projected candidates
        (B, V, K, J, 2) and the pseudo-label people (B, V, P, J, 2); with
        L1_ATTN the worst view's term is left out."""
        from scipy.optimize import linear_sum_assignment

        c = self.cfg
        norm = torch.tensor([float(c.image_wh[0]), float(c.image_wh[1])], device=kps.device)
        cost = ((kps / norm)[:, :, None] - (joints / norm)[:, :, :, None]).abs()
        cost = (cost * vis[:, :, :, None]).mean((-1, -2))  # (B, V, P, K)
        B, V, P, K = cost.shape
        cost = cost.reshape(B * V, P, K)
        rows = (joints.abs().sum((-1, -2)) != 0).reshape(B * V, P)
        cols = (cand_valid > 0)[:, None].expand(B, V, K).reshape(B * V, K)
        terms = []
        for i in range(B * V):
            r = torch.nonzero(rows[i])[:, 0]
            k = torch.nonzero(cols[i])[:, 0]
            if len(r) == 0 or len(k) == 0:
                terms.append(cost.new_zeros(()))
                continue
            sub_cost = cost[i][r][:, k]
            ri, ci = linear_sum_assignment(sub_cost.detach().cpu().numpy().astype(np.float64))
            terms.append(sub_cost[torch.as_tensor(ri), torch.as_tensor(ci)].sum())
        t = torch.stack(terms)
        if c.l1_attn:
            keep = torch.ones_like(t)
            keep[int(torch.argmax(t.detach()))] = 0.0
            return (t * keep).sum() / (t.numel() - 1)
        return t.mean()


def voxel_world(idx, size, center, n):
    """Voxel indices (..., 3) -> world mm."""
    kw = dict(dtype=torch.float32, device=idx.device)
    n = torch.tensor([float(v) for v in n], **kw)
    size = torch.tensor([float(v) for v in size], **kw)
    center = torch.tensor([float(v) for v in center], **kw)
    return idx.float() / (n - 1.0) * size + center - size / 2.0


def sub(cam: dict, i: int) -> dict:
    return {k: v[i:i + 1] for k, v in cam.items()}


def adam_step(params: Dict[str, torch.Tensor], grads: Dict[str, Optional[torch.Tensor]],
              state: Dict[str, dict], lr: float, t: int, b1=0.9, b2=0.999, eps=1e-8) -> None:
    """One Adam update in place (no weight decay); a missing gradient is zero."""
    for name, p in params.items():
        g = grads.get(name)
        g = torch.zeros_like(p) if g is None else g
        s = state.setdefault(name, {"m": torch.zeros_like(p), "v": torch.zeros_like(p)})
        s["m"].mul_(b1).add_(g, alpha=1 - b1)
        s["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
        mhat = s["m"] / (1 - b1 ** t)
        vhat = s["v"] / (1 - b2 ** t)
        p.sub_(lr * mhat / (vhat.sqrt() + eps))
