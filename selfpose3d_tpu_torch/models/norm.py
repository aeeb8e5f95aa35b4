"""Eval-mode BatchNorm and the compute-dtype policy of the conv stacks.

BatchNorm applies the running statistics as one per-channel affine,
``y = x * s + b`` with ``s = weight * rsqrt(running_var + eps)`` and
``b = bias - running_mean * s`` computed in float32 on (C,) vectors and
cast to the activation dtype once (``selfpose3d_tpu/models/norm.py:119-129``).
Parameters and buffers keep ``nn.BatchNorm{2,3}d``'s names and float32, so
reference state dicts load unchanged. Only inference is ported: the
forward uses the running statistics in train mode too.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn as nn


class _EvalAffine:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        b = self.bias.float() - self.running_mean.float() * s
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * s.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)


class BatchNorm2d(_EvalAffine, nn.BatchNorm2d):
    pass


class BatchNorm3d(_EvalAffine, nn.BatchNorm3d):
    pass


_CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)


def cast_convs(module: nn.Module, dtype: torch.dtype, keep: Iterable[nn.Module] = ()) -> None:
    """Store every convolution's weight and bias in the compute ``dtype``,
    except the ``keep`` layers (the float32 output heads). BatchNorm stays
    float32."""
    keep = set(map(id, keep))
    for m in module.modules():
        if isinstance(m, _CONVS) and id(m) not in keep:
            m.to(dtype)
