"""k=3^3 SAME 3D convolution probe at V2V 64^3 shapes: the counterpart of
``scripts/microbench_pallas_conv.py``.

``conv3`` replaces the TPU kernel ``_kernel`` / ``pallas_conv3`` of that
script (its im2col Pallas conv) with a hand-written CUDA kernel
(``csrc/conv3.cu``: implicit GEMM on ``wgmma``, the weights repacked by
``pack_weights`` into the kernel's shared-memory layout). It is a yardstick
for the V2V's convolutions, which the port leaves to cuDNN as the JAX
package leaves them to XLA: nothing on the inference or train path calls it.

    python -m selfpose3d_tpu_torch.microbench.conv3

prints the card line, then for each of the probe's two shapes (40 cubes of
64^3, 16->32 and 32->32 channels) ``<name>_relerr`` (the kernel against
``F.conv3d`` in float32 on ``x[:1, :16]``), ``<name>_kernel_ms``,
``<name>_cudnn_ms`` (cuDNN's bf16 ``F.conv3d``, channels-last-3d: the
probe's "native" column) and ``<name>_plain_ms``.

``conv3`` takes CPU tensors to the plain version and CUDA tensors to the
kernel, which it launches or raises on; it never falls back. ``LAUNCHES``
counts kernel launches and nothing else.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from selfpose3d_tpu_torch.device import kernel_route
from selfpose3d_tpu_torch.microbench.common import card, card_line, cuda_ms
from selfpose3d_tpu_torch.ops import build

# name: (cubes, input channels, output channels), at 64^3 (the probe's :237-240)
SHAPES: Dict[str, Tuple[int, int, int]] = {
    "front_res_c1_16to32": (40, 16, 32),
    "skip_res1_32to32": (40, 32, 32),
}
EDGE = 64
LAUNCHES = {"conv3": 0}


def reset_launches() -> None:
    LAUNCHES["conv3"] = 0


def conv3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """27 shifted slices of the zero-padded input, each a float32 product
    with its (CI, CO) weight slice, summed in float32, rounded once."""
    B, X, Y, Z, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((B, X, Y, Z, w.shape[4]), dtype=torch.float32, device=x.device)
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                acc += xp[:, dx:dx + X, dy:dy + Y, dz:dz + Z] @ wf[dx, dy, dz]
    return acc.to(x.dtype)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """DHWIO weights (3, 3, 3, CI, CO) -> (27*CI/16, 2, CO, 8), the layout
    ``sp3d_conv3`` copies into shared memory: ``[k step][half][co][8]`` with
    ``k step = tap*CI/16 + ci//16``, ``half = ci//8 % 2``, last axis
    ``ci % 8``, ``tap = 9*dx + 3*dy + dz``. Each (k step, half, co) is one
    16-byte row of the wgmma B operand (K-major, no swizzle)."""
    CI, CO = w.shape[3], w.shape[4]
    if CI % 16:
        raise ValueError(f"pack_weights: CI={CI} is not a multiple of 16")
    return (w.reshape(27, CI // 16, 2, 8, CO).permute(0, 1, 2, 4, 3)
            .reshape(27 * CI // 16, 2, CO, 8).contiguous())


def unpack_weights(p: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_weights``: (27*CI/16, 2, CO, 8) -> (3, 3, 3, CI, CO)."""
    ks, _, CO, _ = p.shape
    C16 = ks // 27
    return (p.reshape(27, C16, 2, CO, 8).permute(0, 1, 2, 4, 3)
            .reshape(3, 3, 3, 16 * C16, CO).contiguous())


def conv3_library(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """cuDNN's ``F.conv3d`` on the same NDHWC input (as an NCDHW view with
    channels-last-3d strides) and DHWIO weights; NDHWC out. Timed beside the
    kernel only."""
    out = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), padding=1)
    return out.permute(0, 2, 3, 4, 1)


def conv3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """k=3^3 SAME convolution (replaces ``_kernel`` / ``pallas_conv3``).

    Args:
      x: (B, X, Y, Z, CI) bfloat16, NDHWC.
      w: (3, 3, 3, CI, CO) bfloat16, DHWIO.
    Returns:
      (B, X, Y, Z, CO) bfloat16: every product and the 27*CI-term sum in
      float32, one rounding at the end. The CUDA kernel takes CI and Z
      multiples of 16 and CO in (16, 32, 64, 128), where its window and
      weight slice fit in shared memory (CI <= 64 at Z = 64).
    """
    B, X, Y, Z, CI = x.shape
    if tuple(w.shape[:4]) != (3, 3, 3, CI) or w.dim() != 5:
        raise ValueError(f"w: shape {tuple(w.shape)}, expected (3, 3, 3, {CI}, CO)")
    CO = w.shape[4]
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: dtype {t.dtype}, expected bfloat16")
    if not kernel_route((x, w)):
        return conv3_plain(x, w)
    if CI % 16 or Z % 16 or CO not in (16, 32, 64, 128):
        raise ValueError(f"the CUDA conv3 takes CI, Z multiples of 16 and CO in "
                         f"(16, 32, 64, 128); got CI={CI}, Z={Z}, CO={CO}")
    if x.data_ptr() % 16:
        raise ValueError("the CUDA conv3 takes a 16-byte-aligned x")
    lib = build.library("conv3")
    out = torch.empty((B, X, Y, Z, CO), dtype=torch.bfloat16, device=x.device)
    wp = pack_weights(w)
    with torch.cuda.device(x.device):
        err = lib.sp3d_conv3(x.data_ptr(), wp.data_ptr(), out.data_ptr(), B, X, Y, Z, CI, CO,
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sp3d_conv3 launch failed: CUDA error {err}")
    LAUNCHES["conv3"] += 1
    return out


def make_inputs(name: str, device, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe's inputs for shape ``name``: x uniform in [0, 1) and w
    uniform in [0, 0.01) (as the JAX probe draws them), seeded numpy, bf16."""
    bk, ci, co = SHAPES[name]
    rng = np.random.default_rng(seed)
    x = rng.random((bk, EDGE, EDGE, EDGE, ci), dtype=np.float32)
    w = rng.random((3, 3, 3, ci, co), dtype=np.float32) * np.float32(0.01)
    return (torch.from_numpy(x).to(device).to(torch.bfloat16),
            torch.from_numpy(w).to(device).to(torch.bfloat16))


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |v| (8 significant bits), float32."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def measure(name: str, x: torch.Tensor, w: torch.Tensor) -> dict:
    """The probe's keys for one shape: kernel against float32 ``F.conv3d`` on
    ``x[:1, :16]``, then kernel, cuDNN and plain times (ms, CUDA events; 10
    calls each, the plain version 2)."""
    small = x[:1, :16].contiguous()
    got = conv3(small, w).float()
    ref = conv3_library(small.float(), w.float())
    relerr = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-9))
    return {
        f"{name}_relerr": relerr,
        f"{name}_kernel_ms": cuda_ms(lambda: conv3(x, w), 10),
        f"{name}_cudnn_ms": cuda_ms(lambda: conv3_library(x, w), 10),
        f"{name}_plain_ms": cuda_ms(lambda: conv3_plain(x, w), 2, warmup=1),
    }


def main(device="cuda") -> dict:
    dev = card(device)
    print(card_line(), flush=True)
    results = {}
    for i, name in enumerate(SHAPES):
        x, w = make_inputs(name, dev, seed=i)
        results.update(measure(name, x, w))
        del x, w
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
