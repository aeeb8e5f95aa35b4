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

Across W > 1 ranks (``parallel/mesh.py``) train mode takes the moments of
the global batch (``_GlobalBatchNorm``): float32 sums of x and x^2 and the
count, summed over ranks, with flax's fast variance E[x^2] - E[x]^2
(``selfpose3d_tpu/models/norm.py:133-142``); its backward sums the
statistics' cotangents over ranks, so that it reaches every rank's
examples. The running averages then move alike on every rank. At world
size 1 nothing changes.

Parameters and buffers keep ``nn.BatchNorm{2,3}d``'s names and float32, so
reference state dicts load unchanged. Convolutions hold float32 parameters
too and cast them to the activation dtype at use, so an optimizer updates
float32 values whatever the compute dtype.

Every convolution followed by a BatchNorm runs through ``conv_bn``, with
the ReLU and the residual sum that follow it in its block. In eval mode
(``bn.training`` False) the BatchNorm's running affine, computed at each
call from the live parameters and buffers, goes into one pass of
``ops/conv_epilogue.py`` after the convolution, with the residual and the
ReLU (and on CUDA the convolution's own bias), each operation rounded to
the activation dtype as the separate modules round it: the same bits,
fewer passes. A skip branch's convolution (``defer``) runs with no pass
of its own and hands its BatchNorm's affine to the main branch's epilogue.
Each BatchNorm so applied adds 1 to the counter ``bn_folds`` (no
convolution weight is folded). In train mode ``conv_bn`` is the modules'
own code.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from selfpose3d_tpu_torch.ops.conv_epilogue import Affine, epilogue
from selfpose3d_tpu_torch.parallel import mesh
from selfpose3d_tpu_torch.utils import spans


class _FlaxBatchNorm:
    def running_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval mode's float32 (C,) scale and shift, from the running statistics."""
        s = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        return s, self.bias.float() - self.running_mean.float() * s

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, C, ...); mask optional (B,) bool, the examples whose values
        enter the batch statistics (train mode only)."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not self.training:
            s, b = self.running_affine()
            return x * s.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)
        if mesh.world() > 1:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, mask, self.eps)
        elif mask is None:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps
            )
            mean = mean.detach().float()
            var = invstd.detach().float().pow(-2) - self.eps  # the biased variance
        else:
            # indexing by a mask reads its nonzero count, and so does the
            # backward of the indexing
            grad = torch.is_grad_enabled() and x.requires_grad
            spans.count("host_syncs.bn_mask", 2 if grad else 1)
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


def _dims(x: torch.Tensor) -> list:
    return [0] + list(range(2, x.dim()))


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    """The layout the fused kernels take ``x`` in (that of nn.SyncBatchNorm)."""
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over every rank's batch -> (y, mean, biased var).

    Forward: each rank's float32 sums of x and x^2 over the examples of
    ``mask`` (all without one) and their count, summed over ranks, give the
    global mean and E[x^2] - mean^2. Backward: the sums of dy and dy*(x -
    mean) over all of this rank's examples are summed over ranks, as the
    moments' cotangents; every example gets dy * weight * invstd, and an
    example of the mask also its share of the moments' gradient. The
    weight and bias gradients stay this rank's (DDP averages them).

    Only ``x`` in its own dtype and (C,) vectors are kept for the backward,
    as ``torch.native_batch_norm`` keeps. On CUDA the per-rank sums and the
    input gradient are the fused kernels ``nn.SyncBatchNorm`` runs
    (``torch.batch_norm_stats``, ``batch_norm_backward_reduce``,
    ``batch_norm_backward_elemt``, whose float32 accumulation reads a
    bfloat16 ``x`` as it lies); on the CPU, which has no such kernels, the
    same sums in float32 torch ops."""

    @staticmethod
    def forward(ctx, x, weight, bias, mask, eps):
        C, shape = x.shape[1], (1, -1) + (1,) * (x.dim() - 2)
        x = x.contiguous(memory_format=_memory_format(x))
        if mask is not None:
            spans.count("host_syncs.bn_mask")
        xs = x if mask is None else x[mask]
        n = xs.numel() // C
        if n == 0:  # no example of this rank in the mask
            m = v = torch.zeros(C, dtype=torch.float32, device=x.device)
        elif x.is_cuda:
            m, invstd = torch.batch_norm_stats(xs, eps)
            v = invstd.pow(-2) - eps
        else:
            v, m = torch.var_mean(xs.float(), dim=_dims(xs), unbiased=False)
        local = torch.cat([n * m, n * (v + m * m), m.new_full((1,), n)])
        sums = mesh.all_reduce_sum(local)
        count = sums[2 * C :]
        mean = sums[:C] / count
        var = (sums[C : 2 * C] / count - mean * mean).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        s = weight.float() * invstd
        b = bias.float() - mean * s
        y = torch.addcmul(b.to(x.dtype).view(shape), x, s.to(x.dtype).view(shape))
        ctx.save_for_backward(x, weight, mean, invstd, mask, count)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, mask, count = ctx.saved_tensors
        C, shape = x.shape[1], (1, -1) + (1,) * (x.dim() - 2)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dy = dy.contiguous(memory_format=_memory_format(x))
        w = weight.float()
        if x.is_cuda:
            sum_dy, sum_dy_xmu, gw, gb = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, w, need_x, need_w, need_b)
        else:
            dyf, xmu = dy.float(), x.float() - mean.view(shape)
            sum_dy, sum_dy_xmu = dyf.sum(_dims(x)), (dyf * xmu).sum(_dims(x))
            gw, gb = sum_dy_xmu * invstd, sum_dy
        dx = None
        if need_x:
            g = mesh.all_reduce_sum(torch.cat([sum_dy, sum_dy_xmu]))
            k = (w * invstd).view(shape)
            if x.is_cuda:
                dx = torch.batch_norm_backward_elemt(
                    dy, x, mean, invstd, w, g[:C], g[C:], count.to(torch.int32))
                if mask is not None:  # outside the mask: no share of the moments'
                    out = ~mask.view((-1,) + (1,) * (x.dim() - 1))
                    dx = torch.where(out, dy * k.to(dy.dtype), dx)
            else:
                share = (g[:C] / count).view(shape) + xmu * (
                    invstd * invstd * g[C:] / count).view(shape)
                if mask is not None:
                    share = share * mask.view((-1,) + (1,) * (x.dim() - 1))
                dx = ((dyf - share) * k).to(x.dtype)
        return (dx, gw.to(weight.dtype) if need_w else None,
                gb.to(weight.dtype) if need_b else None, None, None)


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


class ConvTranspose2d(_CastConv, nn.ConvTranspose2d):
    def _conv_forward(self, x, weight, bias):
        return F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class ConvTranspose3d(_CastConv, nn.ConvTranspose3d):
    def _conv_forward(self, x, weight, bias):
        return F.conv_transpose3d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


Residual = Union[torch.Tensor, Tuple[torch.Tensor, Optional[Affine]]]


def conv_bn(conv: nn.Module, bn: nn.Module, x: torch.Tensor,
            mask: Optional[torch.Tensor] = None, relu: bool = False,
            residual: Optional[Residual] = None, post: Optional[torch.Tensor] = None,
            defer: bool = False):
    """``bn(conv(x), mask)``, then ``+ residual``, a ReLU where ``relu``, then
    ``+ post`` (a block that sums after its ReLU); residual and post not both.

    ``residual`` is a tensor or the pair a skip branch's ``conv_bn(...,
    defer=True)`` returned, in the same mode (a network's BatchNorms share
    theirs). ``defer`` returns that pair: in eval mode the
    conv's output and the (scale, shift, bias) that the main branch's
    epilogue applies to it; in train mode ``(bn(conv(x), mask), None)``.
    Eval mode runs the epilogue (module doc) and ignores ``mask``; on CUDA
    it runs the convolution without its bias, which cuDNN would add in a
    pass of its own, and the epilogue adds it, rounded as that pass rounds.
    Train mode runs the modules as they are."""
    if residual is not None and post is not None:
        raise ValueError("conv_bn takes a residual or a post-ReLU sum, not both")
    r, r_affine = residual if isinstance(residual, tuple) else (residual, None)
    if bn.training:
        y = bn(conv(x), mask)
        if defer:
            return y, None
        if r is not None:
            y = y + r
        if relu:
            y = F.relu(y)
        return y if post is None else y + post
    if x.is_cuda and conv.bias is not None:
        y, bias = conv._conv_forward(x, _cast(conv.weight, x.dtype), None), conv.bias
    else:
        y, bias = conv(x), None
    affine = (*bn.running_affine(), bias)
    spans.count("bn_folds")
    if defer:
        return y, affine
    if post is not None:
        return epilogue(y, affine, post, relu=relu, after_relu=True)
    return epilogue(y, affine, r, r_affine, relu)


class ConvBN(nn.Sequential):
    """A convolution, its BatchNorm and an optional ReLU, run by ``conv_bn``
    (state-dict names those of ``nn.Sequential``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn(self[0], self[1], x, relu=len(self) > 2)
