"""BatchNorm with flax semantics and the compute-dtype policy of the conv
stacks.

Eval mode applies the running statistics as one per-channel affine,
``y = x * s + b`` with ``s = weight * rsqrt(running_var + eps)`` and
``b = bias - running_mean * s`` computed in float32 on (C,) vectors and
cast to the activation dtype once (``selfpose3d_tpu/models/norm.py:119-129``).

Train mode (``module.training``) normalises with the batch statistics,
reduced in float32, and moves the running averages as flax does
(``selfpose3d_tpu/models/norm.py:133-149``): the **biased** batch variance
goes into ``running_var`` (``nn.BatchNorm`` of torch stores the unbiased
one), with torch momentum 0.1 == flax momentum 0.9. An optional ``mask``
over the batch axis restricts the statistics to the selected examples;
every example is still normalised.

Parameters and buffers keep ``nn.BatchNorm{2,3}d``'s names and float32, so
reference state dicts load unchanged. Convolutions hold float32 parameters
too and cast them to the activation dtype at use, so an optimizer updates
float32 values whatever the compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class _FlaxBatchNorm:
    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, C, ...); mask optional (B,) bool, the examples whose values
        enter the batch statistics (train mode only)."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not self.training:
            s = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
            b = self.bias.float() - self.running_mean.float() * s
            return x * s.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)
        if mask is None:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps
            )
            mean = mean.detach().float()
            var = invstd.detach().float().pow(-2) - self.eps  # the biased variance
        else:
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(x[mask].float(), dim=dims, unbiased=False)
            s = self.weight * torch.rsqrt(var + self.eps)
            b = self.bias - mean * s
            y = x * s.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)
            mean, var = mean.detach(), var.detach()
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.clamp_min(0.0), alpha=m)
            self.num_batches_tracked += 1
        return y


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    pass


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class _CastConv:
    """Float32 parameters, cast to the activation dtype at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype))


class Conv2d(_CastConv, nn.Conv2d):
    pass


class Conv3d(_CastConv, nn.Conv3d):
    pass


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation,
        )


class ConvTranspose3d(nn.ConvTranspose3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose3d(
            x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation,
        )
