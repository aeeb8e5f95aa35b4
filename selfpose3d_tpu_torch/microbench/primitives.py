"""Primitive-rate probe and the posenet-shape measurements beside it: the
counterpart of ``scripts/microbench.py``.

``primitive`` replaces the TPU kernel ``bench_kernel`` of that script (one
primitive body run ``reps`` times inside one program on a tile held on
chip) with a hand-written CUDA kernel (``csrc/microbench_primitives.cu``,
where the four bodies are spelled out); ``primitive_plain`` runs the same
repetitions as a loop of PyTorch ops.

    python -m selfpose3d_tpu_torch.microbench.primitives

prints the card line, then the probe's keys: A. the V2VNet forward in bf16
and in float32 (TF32 off) on 40 cubes of 64^3 with 15 channels
(``v2v_bf16_40x64c15_ms``, ``v2v_f32_40x64c15_ms``); B. the channel-major
to NDHWC feats transpose (``feats_transpose_ms``); C. the channel-major
``soft_argmax`` (``softargmax_ms``); D. each body's kernel time per
repetition at ``REPS`` (``gather_256x128_us_per_op``, ...), its plain
version's and, where one PyTorch call does a repetition's work, that
call's (``..._library_us_per_op``). Inputs are seeded uniform values in
[0, 128) (the TPU probe's are ones, which make every gather read one
column).

``primitive`` takes CPU tensors to the plain version and CUDA tensors to
the kernel, which it launches or raises on; it never falls back.
``LAUNCHES`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from selfpose3d_tpu_torch.device import kernel_route
from selfpose3d_tpu_torch.microbench.common import card, card_line, cuda_ms
from selfpose3d_tpu_torch.models import init_weights
from selfpose3d_tpu_torch.models.v2v_net import V2VNet
from selfpose3d_tpu_torch.ops import build
from selfpose3d_tpu_torch.ops.softargmax import soft_argmax

LANE = 128
REPS = 200
# body: (input shape, output shape, probe key)
BODIES: Dict[str, Tuple[Tuple[int, int], Tuple[int, int], str]] = {
    "gather": ((256, LANE), (256, LANE), "gather_256x128"),
    "transpose": ((256, LANE), (LANE, 256), "transpose_256x128"),
    "cmp_add": ((64, 256), (64, 256), "cmp_add_64x256"),
    "transpose_64x256": ((64, 256), (256, LANE), "transpose_64x256"),
}
_BODY_ID = {b: i for i, b in enumerate(BODIES)}
LAUNCHES = {"primitive": 0}


def reset_launches() -> None:
    LAUNCHES["primitive"] = 0


def _step(body: str, x: torch.Tensor, out: torch.Tensor, i: int) -> torch.Tensor:
    """One repetition of ``body`` (the probe's :124, :134, :143, :152)."""
    if body == "gather":
        idx = (x.to(torch.int32) + i).clamp(0, LANE - 1).to(torch.int64)
        return torch.gather(x, 1, idx)
    if body == "transpose":
        return x.t() + float(i)
    if body == "cmp_add":
        return out + (x <= float(i)).to(torch.float32)
    out = out.clone()
    out[:, :64] = x.t() + float(i)
    return out


def primitive_plain(body: str, x: torch.Tensor, reps: int) -> torch.Tensor:
    """``reps`` repetitions of ``body`` as PyTorch ops, from a zero output."""
    out = torch.zeros(BODIES[body][1], dtype=torch.float32, device=x.device)
    for i in range(reps):
        out = _step(body, x, out, i)
    return out


def primitive(body: str, x: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """``reps`` repetitions of one primitive body in one launch (replaces
    ``bench_kernel``).

    Args:
      body: one of ``BODIES``.
      x: the body's input tile, float32 of ``BODIES[body][0]``.
      reps: repetitions, >= 1.
    Returns:
      The output tile after the last repetition, float32 of
      ``BODIES[body][1]``. cmp_add counts from zero; transpose_64x256's
      columns 64: are zero.
    """
    if body not in BODIES:
        raise ValueError(f"body {body!r}: one of {tuple(BODIES)}")
    shape_in, shape_out, _ = BODIES[body]
    if tuple(x.shape) != shape_in:
        raise ValueError(f"{body}: input shape {tuple(x.shape)}, expected {shape_in}")
    if x.dtype != torch.float32:
        raise TypeError(f"{body}: dtype {x.dtype}, expected float32")
    if reps < 1:
        raise ValueError(f"reps={reps}: at least 1")
    if not kernel_route((x,)):
        return primitive_plain(body, x, reps)
    lib = build.library("microbench_primitives")
    out = torch.empty(shape_out, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.sp3d_primitive(x.data_ptr(), out.data_ptr(), _BODY_ID[body], reps,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sp3d_primitive launch failed: CUDA error {err}")
    LAUNCHES["primitive"] += 1
    return out


def library_call(body: str, x: torch.Tensor) -> Optional[Callable[[int], torch.Tensor]]:
    """The one PyTorch call that does repetition i's work, where there is
    one: ``torch.gather`` (its index built before the call: building it is
    part of the kernel's repetition, so this call does less), or the
    transpose and add of ``torch.add`` into the output; None for cmp_add
    (a compare and an add are two calls)."""
    if body == "gather":
        idx = (x.to(torch.int32) + REPS - 1).clamp(0, LANE - 1).to(torch.int64)
        return lambda i: torch.gather(x, 1, idx)
    if body == "cmp_add":
        return None
    out = torch.zeros(BODIES[body][1], dtype=torch.float32, device=x.device)
    dst = out if body == "transpose" else out[:, :64]
    return lambda i: torch.add(x.t(), float(i), out=dst)


def make_input(body: str, device, seed: int = 0) -> torch.Tensor:
    """The body's input tile: seeded numpy uniform in [0, 128)."""
    rng = np.random.default_rng(seed)
    a = rng.random(BODIES[body][0], dtype=np.float32) * np.float32(LANE)
    return torch.from_numpy(a).to(device)


def measure_body(body: str, x: torch.Tensor) -> dict:
    """Kernel, plain and library microseconds per repetition at ``REPS``
    (CUDA events around 10 whole launches, 2 loops of the plain version and
    of the library call)."""
    key = BODIES[body][2]
    res = {f"{key}_us_per_op": cuda_ms(lambda: primitive(body, x, REPS), 10) / REPS * 1e3,
           f"{key}_plain_us_per_op":
               cuda_ms(lambda: primitive_plain(body, x, REPS), 2, warmup=1) / REPS * 1e3}
    lib = library_call(body, x)
    res[f"{key}_library_us_per_op"] = None if lib is None else cuda_ms(
        lambda: [lib(i) for i in range(REPS)], 2, warmup=1) / REPS * 1e3
    return res


# posenet shapes of parts A-C: B scenes x K candidates = 40 cubes of 64^3, J joints
PARTS_B, PARTS_K, PARTS_EDGE, PARTS_J = 4, 10, 64, 15


def measure_posenet_parts(device, iters: int = 10) -> dict:
    """Parts A-C of the probe at posenet shapes: the V2VNet forward (eval,
    bf16 and float32 with TF32 off, weights seeded through ``init_weights``,
    zero input as in the TPU probe), the feats transpose and soft-argmax."""
    b, k, edge, j = PARTS_B, PARTS_K, PARTS_EDGE, PARTS_J
    cubes, n = b * k, edge ** 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        with torch.device("meta"):
            net = V2VNet(j, j, dtype=dtype)
        net.to_empty(device="cpu")
        init_weights(net, torch.Generator().manual_seed(0))
        net = net.to(device).eval()
        x = torch.zeros((cubes, edge, edge, edge, j), dtype=dtype, device=device)
        with torch.no_grad():
            res[f"v2v_{name}_{cubes}x{edge}c{j}_ms"] = cuda_ms(lambda: net(x), iters)
        del net, x
    feats = torch.zeros((b, j, k * n), dtype=torch.float32, device=device)
    res["feats_transpose_ms"] = cuda_ms(
        lambda: feats.reshape(b, j, k, edge, edge, edge).permute(0, 2, 3, 4, 5, 1)
        .reshape(b * k, edge, edge, edge, j), iters)
    del feats
    scores = torch.zeros((b, k, j, n), dtype=torch.float32, device=device)
    grids = torch.zeros((b, k, n, 3), dtype=torch.float32, device=device)
    res["softargmax_ms"] = cuda_ms(lambda: soft_argmax(scores, grids, beta=100.0), iters)
    return res


def main(device="cuda") -> dict:
    dev = card(device)
    print(card_line(), flush=True)
    results = measure_posenet_parts(dev)
    for i, body in enumerate(BODIES):
        results.update(measure_body(body, make_input(body, dev, seed=i)))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
