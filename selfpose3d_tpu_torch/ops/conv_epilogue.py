"""The epilogue of a convolution followed by an eval BatchNorm: a
hand-written CUDA kernel and its plain version.

``conv_epilogue(x, affine, residual, res_affine, relu, after_relu)``
computes, with ``A(t, (s, b, c)) = (t + c) * s + b`` (``c`` the
convolution's own bias, or None),

- ``relu?(A(x, affine) [+ residual])``,
- ``relu?(A(x, affine) + A(residual, res_affine))`` with ``res_affine`` (a
  skip branch's convolution and BatchNorm), or
- ``relu?(A(x, affine)) + residual`` with ``after_relu``,

the vectors float32 (C,) over dim 1, cast to ``x``'s dtype as the modules
cast them, and each multiply and add rounded to ``x``'s dtype on its own,
in the order of the bias add, BatchNorm, ReLU and sums it replaces: the
plain version is their code, and the kernel gives its bits in bf16 and
float32. It replaces no TPU kernel: XLA fuses the JAX package's BatchNorm
affine (``selfpose3d_tpu/models/norm.py:119-129``), ReLU and residual sum
into their neighbours; see ``csrc/conv_epilogue.cu``.

Given CPU tensors it runs the plain version. Given CUDA tensors it
launches the kernel or raises (a dtype other than bfloat16 or float32, a
layout other than dense channels-last, a channel count the 16-byte vectors
do not divide, a misaligned pointer); it never falls back. ``inplace``
lets the kernel write into ``x``; the plain version always returns a new
tensor. ``epilogue`` is the differentiable form. ``LAUNCHES`` counts
kernel launches and nothing else; it is registered as the counter
``launches.conv_epilogue`` of ``utils/spans.py``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from selfpose3d_tpu_torch.ops import build
from selfpose3d_tpu_torch.utils import spans

LAUNCHES = {"conv_epilogue": 0}
spans.register("launches.", LAUNCHES)

LANES = {torch.bfloat16: 8, torch.float32: 4}  # 16 bytes of each dtype
BLOCKS_PER_SM = 8  # of 256 threads: a full SM

# (scale, shift, the convolution's own bias or None), float32 (C,) each
Affine = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def _shape(x: torch.Tensor) -> tuple:
    return (1, -1) + (1,) * (x.dim() - 2)


def _affine(t: torch.Tensor, affine: Affine, dtype: torch.dtype) -> torch.Tensor:
    """A(t): the bias add, then the BatchNorm, each a rounded op in ``dtype``."""
    scale, shift, bias = (None if v is None else v.to(dtype).view(_shape(t)) for v in affine)
    if bias is not None:
        t = t + bias
    return t * scale + shift


def conv_epilogue_plain(x: torch.Tensor, affine: Affine,
                        residual: Optional[torch.Tensor] = None,
                        res_affine: Optional[Affine] = None, relu: bool = False,
                        after_relu: bool = False) -> torch.Tensor:
    """x (B, C, ...) bf16 or float32; affine, res_affine (scale, shift,
    bias or None) of float32 (C,) vectors; residual like x."""
    y = _affine(x, affine, x.dtype)
    if residual is not None and not after_relu:
        if res_affine is not None:
            residual = _affine(residual, res_affine, x.dtype)
        y = y.add_(residual)
    if relu:
        y = y.relu_()
    if residual is not None and after_relu:
        y = y.add_(residual)
    return y


def _channels_last(t: torch.Tensor) -> bool:
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}.get(t.dim())
    return fmt is not None and t.is_contiguous(memory_format=fmt)


@functools.lru_cache(maxsize=None)
def _blocks(index: int) -> int:
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(index).multi_processor_count


def _ptr(v: Optional[torch.Tensor]) -> Optional[int]:
    return None if v is None else v.data_ptr()


def _launch(x: torch.Tensor, affine: Affine, residual: Optional[torch.Tensor],
            res_affine: Optional[Affine], relu: bool, after_relu: bool,
            out: torch.Tensor) -> torch.Tensor:
    C, dev = x.shape[1], x.device
    lanes = LANES.get(x.dtype)
    if lanes is None:
        raise TypeError(f"conv_epilogue: dtype {x.dtype}, expected bfloat16 or float32")
    if not _channels_last(x):
        raise ValueError("conv_epilogue: x is not a dense channels-last 4-D or 5-D tensor")
    if C % lanes:
        raise ValueError(f"conv_epilogue: {C} channels, not a multiple of {lanes} in {x.dtype}")
    if residual is not None and (residual.dtype != x.dtype or residual.shape != x.shape
                                 or not _channels_last(residual)):
        raise ValueError("conv_epilogue: the residual differs from x in dtype, shape or layout")
    if res_affine is not None and (residual is None or after_relu):
        raise ValueError("conv_epilogue: a residual's affine needs a residual before the ReLU")
    ra = res_affine or (None, None, None)
    for v in (*affine, *ra):
        if v is not None and (v.dtype != torch.float32 or v.shape != (C,) or v.stride() != (1,)):
            raise ValueError(f"conv_epilogue: the scales, shifts and biases are not float32 ({C},)")
        if v is not None and v.device != dev:
            raise ValueError("conv_epilogue: inputs on several devices")
    if (residual is not None and residual.device != dev) or out.device != dev:
        raise ValueError("conv_epilogue: inputs on several devices")
    if (x.data_ptr() | out.data_ptr() | (0 if residual is None else residual.data_ptr())) % 16:
        raise ValueError("conv_epilogue: a pointer not aligned to 16 bytes")
    if x.numel() == 0:
        return out
    mode = 0 if residual is None else 3 if after_relu else 2 if res_affine is not None else 1
    lib = build.library("conv_epilogue")
    args = (x.data_ptr(), *map(_ptr, affine[:3]), _ptr(residual), *map(_ptr, ra),
            out.data_ptr(), x.numel(), C, int(x.dtype == torch.bfloat16), mode, int(relu),
            _blocks(dev.index))
    if dev.index == torch.cuda.current_device():
        err = lib.sp3d_conv_epilogue(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = lib.sp3d_conv_epilogue(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sp3d_conv_epilogue launch failed: CUDA error {err}")
    LAUNCHES["conv_epilogue"] += 1
    return out


def conv_epilogue(x: torch.Tensor, affine: Affine, residual: Optional[torch.Tensor] = None,
                  res_affine: Optional[Affine] = None, relu: bool = False,
                  after_relu: bool = False, inplace: bool = False) -> torch.Tensor:
    """The epilogue of ``x`` (module doc): the kernel for CUDA tensors, into
    ``x`` itself where ``inplace``; the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return conv_epilogue_plain(x, affine, residual, res_affine, relu, after_relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv_epilogue: unsupported device {x.device}")
    out = x if inplace else torch.empty_like(x)
    return _launch(x, affine, residual, res_affine, relu, after_relu, out)


def _affine_grads(g: torch.Tensor, t: torch.Tensor, affine: Affine, need) -> list:
    """Gradients of A(t) to t, scale, shift and bias, given g of A(t)."""
    scale, _, bias = affine
    dims = [0] + list(range(2, g.dim()))
    gs = g * scale.to(g.dtype).view(_shape(g))
    t = t if bias is None else t + bias.to(t.dtype).view(_shape(t))
    return [gs if need[0] else None,
            (g.float() * t.float()).sum(dims) if need[1] else None,
            g.float().sum(dims) if need[2] else None,
            gs.float().sum(dims) if need[3] else None]


class _Epilogue(torch.autograd.Function):
    """``relu?(A(x, affine) [+ residual | + A(residual, res_affine)])``: the
    backward masks by the saved output's sign and sums the vectors'
    gradients over all but the channels."""

    @staticmethod
    def forward(ctx, x, s, b, c, residual, rs, rb, rc, relu):
        res_affine = None if rs is None else (rs, rb, rc)
        y = conv_epilogue(x, (s, b, c), residual, res_affine, relu)
        ctx.relu, ctx.res_affine = relu, rs is not None
        ctx.save_for_backward(x, s, c, residual, rs, rc, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, s, c, residual, rs, rc, y = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = dy * (y > 0) if ctx.relu else dy
        grads = _affine_grads(g, x, (s, None, c), need[0:4])
        if not ctx.res_affine:
            rest = [g if residual is not None and need[4] else None, None, None, None]
        else:
            rest = _affine_grads(g, residual, (rs, None, rc), need[4:8])
        return (*grads, *rest, None)


def epilogue(x: torch.Tensor, affine: Affine, residual: Optional[torch.Tensor] = None,
             res_affine: Optional[Affine] = None, relu: bool = False,
             after_relu: bool = False) -> torch.Tensor:
    """``conv_epilogue`` where autograd may need it: in place on CUDA when no
    input needs a gradient, else through ``_Epilogue`` (a residual after the
    ReLU then added by autograd's own sum)."""
    ra = (None, None, None) if res_affine is None else res_affine
    grads = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, residual, *affine, *ra))
    if not grads:
        return conv_epilogue(x, affine, residual, res_affine, relu, after_relu, inplace=True)
    if residual is not None and after_relu:
        return _Epilogue.apply(x, *affine, None, None, None, None, relu) + residual
    return _Epilogue.apply(x, *affine, residual, *ra, relu)
