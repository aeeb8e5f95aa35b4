"""PoseResNet backbone: ResNet-{18,34,50,101,152} + deconv head
(ref: lib/models/pose_resnet.py:26-284), and the sigmoid-headed attention net.

Stem conv7x7/s2 + maxpool, 4 residual stages, 3 ConvTranspose2d(k=4, s=2,
p=1) deconvs, a 1x1 final conv: 960x512 images -> 240x128 heatmaps.
Module names are the reference's state-dict names. Convolutions run in
the compute dtype; the final layer runs in float32, as in
``selfpose3d_tpu/models/pose_resnet.py:207-214``. Public layout is NHWC:
(B, H, W, 3) in, (B, H/4, W/4, J) out.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from selfpose3d_tpu_torch.models.norm import BatchNorm2d, Conv2d, ConvTranspose2d


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                Conv2d(cin, planes, 1, stride, bias=False), BatchNorm2d(planes)
            )

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + r)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        cout = planes * 4
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, bias=False), BatchNorm2d(cout)
            )

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + r)


RESNET_SPEC = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class PoseResNet(nn.Module):
    """(B, H, W, 3) -> (B, H/4, W/4, num_joints) float32 heatmaps."""

    def __init__(
        self,
        num_layers: int = 50,
        num_joints: int = 15,
        deconv_filters=(256, 256, 256),
        deconv_kernels=(4, 4, 4),
        final_conv_kernel: int = 1,
        deconv_with_bias: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        block, layers = RESNET_SPEC[num_layers]
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for si, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for b in range(n):
                stride = (1 if si == 0 else 2) if b == 0 else 1
                blocks.append(block(cin, planes, stride))
                cin = planes * block.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        deconvs = []
        for filters, kernel in zip(deconv_filters, deconv_kernels):
            if kernel != 4:
                raise ValueError("only k=4 deconvs are supported (reference default)")
            deconvs += [
                ConvTranspose2d(cin, filters, 4, 2, 1, bias=deconv_with_bias),
                BatchNorm2d(filters),
                nn.ReLU(inplace=True),
            ]
            cin = filters
        self.deconv_layers = nn.Sequential(*deconvs)
        pad = 1 if final_conv_kernel == 3 else 0
        self.final_layer = Conv2d(cin, num_joints, final_conv_kernel, 1, pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        x = self.deconv_layers(x)
        out = self.final_layer(x.float())
        return out.permute(0, 2, 3, 1)  # (B, H/4, W/4, J)


class PoseResAttnNet(nn.Module):
    """Sigmoid-headed PoseResNet producing supervision-attention maps in
    [0, 1] (ref: lib/models/pose_resnet.py:287-299)."""

    def __init__(self, num_layers: int = 18, num_joints: int = 15,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = PoseResNet(num_layers=num_layers, num_joints=num_joints, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.backbone(x))
