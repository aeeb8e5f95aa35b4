"""V2V-PoseNet volumetric U-Net (ref: lib/models/v2v_net.py:10-144).

Basic3DBlock(k=7) -> Res3D(16->32) front, 2-level pool2 encoder
(32->64->128), mid res block, ConvTranspose3d(k=2, s=2) decoder with skip
Res3D blocks, 1x1x1 output conv in float32. Each conv with its BatchNorm,
ReLU and residual sum runs through ``norm.conv_bn`` (one epilogue pass in
eval mode). Native Conv3d, ConvTranspose3d and max_pool3d: the JAX
package's widened-tap k7 conv, matmul deconv and reshape max-pool are XLA
formulations of the same maths. Module names are the reference's
state-dict names. Public layout is (B, X, Y, Z, C); inside, the permuted
view is NCDHW with channels-last strides.

``mask`` ((B,) bool) restricts the train-mode BatchNorm statistics to the
selected examples without changing shapes: the counterpart of the
reference's valid-candidates-only loop through V2V
(ref: lib/models/pose_regression_net.py:49-51). No activation
checkpointing: at the flagship train step (20 cubes of 64^3 in bf16) the
stored activations fit an 80 GB card many times over.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from selfpose3d_tpu_torch.models.norm import BatchNorm3d, Conv3d, ConvTranspose3d, conv_bn


class Basic3DBlock(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.block = nn.Sequential(
            Conv3d(cin, cout, kernel, 1, (kernel - 1) // 2),
            BatchNorm3d(cout),
            nn.ReLU(inplace=True),
        )

    def forward(self, x, mask=None):
        conv, bn, _ = self.block
        return conv_bn(conv, bn, x, mask, relu=True)


class Res3DBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.res_branch = nn.Sequential(
            Conv3d(cin, cout, 3, 1, 1),
            BatchNorm3d(cout),
            nn.ReLU(inplace=True),
            Conv3d(cout, cout, 3, 1, 1),
            BatchNorm3d(cout),
        )
        self.skip_con = (
            nn.Sequential()
            if cin == cout
            else nn.Sequential(Conv3d(cin, cout, 1), BatchNorm3d(cout))
        )

    def forward(self, x, mask=None):
        conv1, bn1, _, conv2, bn2 = self.res_branch
        skip = conv_bn(*self.skip_con, x, mask, defer=True) if len(self.skip_con) else x
        y = conv_bn(conv1, bn1, x, mask, relu=True)
        return conv_bn(conv2, bn2, y, mask, relu=True, residual=skip)


class Upsample3DBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = nn.Sequential(
            ConvTranspose3d(cin, cout, 2, 2, 0),
            BatchNorm3d(cout),
            nn.ReLU(inplace=True),
        )

    def forward(self, x, mask=None, skip=None):
        """relu(bn(deconv(x))), plus ``skip`` after the ReLU where given."""
        deconv, bn, _ = self.block
        return conv_bn(deconv, bn, x, mask, relu=True, post=skip)


class EncoderDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.skip_res1 = Res3DBlock(32, 32)
        self.encoder_res1 = Res3DBlock(32, 64)
        self.skip_res2 = Res3DBlock(64, 64)
        self.encoder_res2 = Res3DBlock(64, 128)
        self.mid_res = Res3DBlock(128, 128)
        self.decoder_res2 = Res3DBlock(128, 128)
        self.decoder_upsample2 = Upsample3DBlock(128, 64)
        self.decoder_res1 = Res3DBlock(64, 64)
        self.decoder_upsample1 = Upsample3DBlock(64, 32)

    def forward(self, x, mask=None):
        skip1 = self.skip_res1(x, mask)
        x = self.encoder_res1(F.max_pool3d(x, 2), mask)
        skip2 = self.skip_res2(x, mask)
        x = self.encoder_res2(F.max_pool3d(x, 2), mask)
        x = self.decoder_res2(self.mid_res(x, mask), mask)
        x = self.decoder_res1(self.decoder_upsample2(x, mask, skip2), mask)
        return self.decoder_upsample1(x, mask, skip1)


class V2VNet(nn.Module):
    """(B, X, Y, Z, C_in) -> (B, X, Y, Z, C_out) float32."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.front_layers = nn.Sequential(Basic3DBlock(cin, 16, 7), Res3DBlock(16, 32))
        self.encoder_decoder = EncoderDecoder()
        self.output_layer = Conv3d(32, cout, 1)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3).to(self.dtype)
        x = self.front_layers[1](self.front_layers[0](x, mask), mask)
        x = self.encoder_decoder(x, mask)
        return self.output_layer(x.float()).permute(0, 2, 3, 4, 1)
