"""HRNet top-down pose network (Sun et al., CVPR 2019, arXiv 1902.09212;
ref: deep-high-resolution-net.pytorch lib/models/pose_hrnet.py), the model
SelfPose3d's pseudo-label stage s4 runs (HRNet-W48 at 384x288, ref:
pseudo_2d_labels_generation/s4_hrnet_kpt2d_inference.sh:17-23).

A stem of two stride-2 3x3 convolutions, ``layer1`` (4 Bottlenecks of 64
planes), then stages of multi-resolution modules: each module runs its
branches (``BasicBlock`` stacks, one a resolution) and fuses every branch
into every output (``fuse_layers``: a 1x1 convolution and nearest
upsampling from a coarser branch, chains of stride-2 3x3 convolutions from
a finer one, summed, then ReLU). Transitions add a branch at half the
resolution before stages 2-4; the last module of the last stage outputs
its finest branch only, which ``final_layer`` maps to joint heatmaps.

Module names are the published state-dict names; the blocks are
``pose_resnet``'s. Convolutions run in the compute dtype on float32
parameters, each with its BatchNorm, ReLU and sum through ``norm.conv_bn``
(one epilogue pass in eval mode; a fuse layer's sum and ReLU go to the
epilogue of each branch's last BatchNorm), the final layer in float32, as
in ``pose_resnet.py``. Public layout is NHWC: (B, H, W, 3) in, (B, H/4,
W/4, J) out.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from selfpose3d_tpu_torch.models.norm import BatchNorm2d, Conv2d, ConvBN, conv_bn
from selfpose3d_tpu_torch.models.pose_resnet import BasicBlock, Bottleneck
from selfpose3d_tpu_torch.ops.conv_epilogue import epilogue

BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}
# COCO's left/right keypoint pairs (eyes, ears, shoulders, elbows, wrists,
# hips, knees, ankles): the flip test swaps them
COCO_FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16))

# HRNet-W48 (experiments/coco/hrnet/w48_384x288_adam_lr1e-3.yaml, MODEL.EXTRA)
W48_EXTRA = {
    "FINAL_CONV_KERNEL": 1,
    "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "BLOCK": "BASIC", "NUM_BLOCKS": (4, 4),
               "NUM_CHANNELS": (48, 96), "FUSE_METHOD": "SUM"},
    "STAGE3": {"NUM_MODULES": 4, "NUM_BRANCHES": 3, "BLOCK": "BASIC", "NUM_BLOCKS": (4, 4, 4),
               "NUM_CHANNELS": (48, 96, 192), "FUSE_METHOD": "SUM"},
    "STAGE4": {"NUM_MODULES": 3, "NUM_BRANCHES": 4, "BLOCK": "BASIC", "NUM_BLOCKS": (4, 4, 4, 4),
               "NUM_CHANNELS": (48, 96, 192, 384), "FUSE_METHOD": "SUM"},
}


def _conv_bn(cin: int, cout: int, k: int, stride: int, relu: bool) -> ConvBN:
    layers = [Conv2d(cin, cout, k, stride, k // 2, bias=False), BatchNorm2d(cout)]
    return ConvBN(*layers, nn.ReLU(inplace=True)) if relu else ConvBN(*layers)


class HighResolutionModule(nn.Module):
    """Parallel branches and their fusion (ref: pose_hrnet.py:23-194)."""

    def __init__(self, block, num_blocks: Sequence[int], channels: Sequence[int],
                 multi_scale_output: bool = True):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[block(c * block.expansion, c) for _ in range(nb)])
            for c, nb in zip(channels, num_blocks))
        self.channels = [c * block.expansion for c in channels]
        self.fuse_layers = None
        if n > 1:
            self.fuse_layers = nn.ModuleList(
                nn.ModuleList(self._fuse(j, i) for j in range(n))
                for i in range(n if multi_scale_output else 1))

    def _fuse(self, j: int, i: int):
        """Input branch ``j`` into output branch ``i``."""
        c = self.channels
        if j > i:
            return nn.Sequential(Conv2d(c[j], c[i], 1, 1, 0, bias=False), BatchNorm2d(c[i]),
                                 nn.Upsample(scale_factor=2 ** (j - i), mode="nearest"))
        if j == i:
            return None
        return nn.Sequential(*[_conv_bn(c[j], c[i] if k == i - j - 1 else c[j], 3, 2,
                                        relu=k < i - j - 1) for k in range(i - j)])

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = [b(x) for b, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        out = []
        for i, fuse in enumerate(self.fuse_layers):
            js = [j for j in range(len(fuse)) if j != i]
            y = xs[i]
            for j in js:
                y = self._add_fused(fuse[j], j > i, xs[j], y, relu=j == js[-1])
            out.append(y)
        return out

    @staticmethod
    def _add_fused(f: nn.Module, up: bool, x: torch.Tensor, acc: torch.Tensor,
                   relu: bool) -> torch.Tensor:
        """``acc`` plus branch ``x`` through ``f``, then the ReLU where
        ``relu``: the last BatchNorm's epilogue takes the sum and the ReLU.
        ``up``: a 1x1 conv and BatchNorm, then nearest upsampling, which
        commutes with the BatchNorm's per-channel affine and so runs before
        the epilogue; else a chain of strided 3x3 conv blocks."""
        if up:
            t, affine = conv_bn(f[0], f[1], x, defer=True)
            t = f[2](t)
            if affine is not None:
                return epilogue(t, affine, acc, relu=relu)
            y = acc + t
            return F.relu(y) if relu else y
        for step in f[:-1]:
            x = step(x)
        return conv_bn(f[-1][0], f[-1][1], x, relu=relu, residual=acc)


class PoseHighResolutionNet(nn.Module):
    """(B, H, W, 3) -> (B, H/4, W/4, num_joints) float32 heatmaps
    (ref: pose_hrnet.py:270-470). ``extra``: MODEL.EXTRA of the published
    configuration (``W48_EXTRA``); ``input_hw`` the crop it is run on
    (NETWORK.IMAGE_SIZE), which s4's ``topdown_keypoints`` reads."""

    def __init__(self, num_joints: int = 17, extra: dict = W48_EXTRA,
                 input_hw=(384, 288), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.input_hw = tuple(input_hw)
        self.conv1 = Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(*[Bottleneck(256 if b else 64, 64) for b in range(4)])
        pre = [256]
        for s in (2, 3, 4):
            st = extra[f"STAGE{s}"]
            block = BLOCKS[st["BLOCK"]]
            if st.get("FUSE_METHOD", "SUM") != "SUM":
                raise ValueError(f"STAGE{s}.FUSE_METHOD {st['FUSE_METHOD']!r}: only SUM")
            chans = list(st["NUM_CHANNELS"])
            cur = [c * block.expansion for c in chans]
            setattr(self, f"transition{s - 1}", self._transition(pre, cur))
            modules = []
            for m in range(st["NUM_MODULES"]):
                last = s == 4 and m == st["NUM_MODULES"] - 1
                modules.append(HighResolutionModule(block, st["NUM_BLOCKS"], chans,
                                                    multi_scale_output=not last))
            setattr(self, f"stage{s}", nn.Sequential(*modules))
            pre = cur
        k = int(extra.get("FINAL_CONV_KERNEL", 1))
        self.final_layer = Conv2d(pre[0], num_joints, k, 1, 1 if k == 3 else 0)

    @staticmethod
    def _transition(pre: List[int], cur: List[int]) -> nn.ModuleList:
        """ref: pose_hrnet.py:340-378: a 3x3 convolution where a kept branch
        changes width, and a chain of stride-2 ones from the coarsest branch
        for each new branch."""
        layers = []
        for i, c in enumerate(cur):
            if i < len(pre):
                layers.append(_conv_bn(pre[i], c, 3, 1, relu=True) if c != pre[i] else None)
            else:
                n = i + 1 - len(pre)
                layers.append(nn.Sequential(*[_conv_bn(pre[-1], c if k == n - 1 else pre[-1], 3, 2,
                                                       relu=True) for k in range(n)]))
        return nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view
        x = conv_bn(self.conv1, self.bn1, x, relu=True)
        x = conv_bn(self.conv2, self.bn2, x, relu=True)
        xs = [self.layer1(x)]
        for s in (2, 3, 4):
            trans = getattr(self, f"transition{s - 1}")
            xs = [xs[i] if t is None and i < len(xs) else t(xs[min(i, len(xs) - 1)])
                  for i, t in enumerate(trans)]
            xs = getattr(self, f"stage{s}")(xs)
        out = self.final_layer(xs[0].float())
        return out.permute(0, 2, 3, 1)  # (B, H/4, W/4, J)

    @classmethod
    def from_config(cls, cfg, dtype: torch.dtype = torch.float32) -> "PoseHighResolutionNet":
        """``cfg.NETWORK.NUM_JOINTS``, ``cfg.MODEL_EXTRA`` (MODEL.EXTRA;
        HRNet-W48's where it is empty) and NETWORK.IMAGE_SIZE (W, H)."""
        w, h = cfg.NETWORK.IMAGE_SIZE
        return cls(cfg.NETWORK.NUM_JOINTS, cfg.MODEL_EXTRA or W48_EXTRA, (h, w), dtype=dtype)
