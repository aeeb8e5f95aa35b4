"""Slice-warp ablation probe: the counterpart of
``scripts/microbench_sw_variants.py``.

``sw_variant`` replaces the TPU kernel ``make_kernel(mode)`` of that script
(the column-hosted slice-warp forward in six ablation modes, which the
probe times to attribute the TPU sampler's per-slice cost) with a
hand-written CUDA kernel (``csrc/sw_variants.cu``), and ``sw_variant_plain``
computes the same function in plain PyTorch. The function and the modes
are spelled out in the CUDA source, with the kernel's design: a
channel-last copy of the planes, a block a band of slice rows with their
r tables in shared memory, taps staged a point, then one 16-byte load a
tap and channel quad. The GPU has no lane gathers or transposes to
ablate, so on the card the mode times attribute the GPU's cost: the
search, the tap selection, the channel loop. ``work`` gives the bytes and
operations each mode needs, from which ``chip_smoke.py`` prices its bound.

    python -m selfpose3d_tpu_torch.microbench.sw_variants

prints the card line, then each mode's kernel ms and plain ms at the
probe's shapes (B=4, J=15, 640 slices of 64 x 128 points, 1.26 GB out).

``sw_variant`` takes CPU tensors to the plain version and CUDA tensors to
the kernel, which it launches or raises on; it never falls back.
``LAUNCHES`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import torch

from selfpose3d_tpu_torch.device import kernel_route
from selfpose3d_tpu_torch.microbench.common import card, card_line, cuda_ms
from selfpose3d_tpu_torch.ops import build

# the probe's shapes (:15-19): image H x W, J channels, K cubes of Z slices
B, H, W, J = 4, 128, 240, 15
K, X, Y, Z = 10, 64, 64, 64
S = K * Z
SB = 8
Wp, Xp, Yp, Hp = 256, 64, 128, 128
MODES = ("full", "j1", "nosearch", "notranspose", "nopass2", "tap2")
LAUNCHES = {"sw_variant": 0}


def reset_launches() -> None:
    LAUNCHES["sw_variant"] = 0


def search_steps(n: int) -> Tuple[int, ...]:
    """Descending power-of-two steps of the branchless search over n entries
    (the JAX package's ``_search_steps``)."""
    st = 1
    while st * 2 < n:
        st *= 2
    steps = []
    while st >= 1:
        steps.append(st)
        st //= 2
    return tuple(steps)


def row_r(xs: torch.Tensor, ys: torch.Tensor, Wc: int, search: bool = True) -> torch.Tensor:
    """r(c) of every slice row for columns c < Wc: (..., Yp) -> (..., Wc) int64;
    the first Y of a row's xs are its search table."""
    sgn = torch.where(xs[..., Y - 1:Y] >= xs[..., 0:1], 1.0, -1.0)
    xs_m = xs * sgn
    cols_m = torch.arange(Wc, dtype=torch.float32, device=xs.device) * sgn
    seg = torch.zeros(cols_m.shape, dtype=torch.int64, device=xs.device)
    if search:
        for st in search_steps(Y - 1):
            cand = seg + st
            val = torch.gather(xs_m, -1, cand.clamp(max=Y - 2))
            seg = torch.where((cand <= Y - 2) & (val <= cols_m), cand, seg)
    x_k = torch.gather(xs_m, -1, seg)
    x_k1 = torch.gather(xs_m, -1, seg + 1)
    y_k = torch.gather(ys, -1, seg)
    y_k1 = torch.gather(ys, -1, seg + 1)
    t = (cols_m - x_k) / (x_k1 - x_k + 1e-6)
    y_hat = torch.clamp(y_k + t * (y_k1 - y_k), -4.0, H + 3.0)
    return torch.floor(y_hat).to(torch.int64)


def sw_variant_plain(mode: str, hm: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
    """The function of the CUDA kernel, step by step (the search as the probe
    runs it, not ``searchsorted``, so rows that are not monotone agree).
    Channels the mode does not write (j1: all but 0) are zero."""
    Bn, Jn, Wc, Hc = hm.shape
    lead = xs.shape[:-2]
    Xn, Yn = xs.shape[-2:]
    dev = xs.device
    r = row_r(xs, ys, Wc, search=mode != "nosearch")  # (..., Xn, Wc)
    out = torch.zeros((*lead[:-1], lead[-1], Jn, Xn, Yn), dtype=torch.float32, device=dev)
    nch = 1 if mode == "j1" else Jn
    hm_flat = hm.reshape(Bn, Jn, Wc * Hc)

    def tap(ch, col, rr):
        """hm[b, ch, col, clip(rr, 0, H-1)] at every point."""
        idx = (col * Hc + rr.clamp(0, H - 1)).reshape(Bn, -1)
        return torch.gather(hm_flat[:, ch], 1, idx).reshape(col.shape)

    if mode == "nopass2":
        cols = torch.arange(Yn, device=dev).expand(r[..., :Yn].shape)
        for ch in range(nch):
            acc = tap(ch, cols, r[..., :Yn] - 1)
            for j in range(1, 4):
                acc = acc + tap(ch, cols, r[..., :Yn] + j - 1)
            out[..., ch, :, :] = acc
        return out

    xf, yf = torch.floor(xs), torch.floor(ys)
    ux, vy = xs - xf, ys - yf
    x0, y0 = xf.to(torch.int64), yf.to(torch.int64)
    rows = torch.arange(Xn, device=dev)[:, None].expand(xs.shape)
    taps = []  # per corner: (column, tap row of j = lo)
    for xc in (x0.clamp(0, W - 1), (x0 + 1).clamp(0, W - 1)):
        rc = torch.gather(r, -1, xc)
        lo = torch.zeros_like(rc) if mode == "tap2" else (y0 - rc).clamp(-1, 1) + 1
        if mode == "notranspose":
            # r of slice row xc at column x, 0 where xc >= Xn
            flat = r.reshape(*r.shape[:-2], Xn * Wc)
            other = torch.gather(flat, -1, (xc.clamp(max=Xn - 1) * Wc + rows)
                                 .reshape(*r.shape[:-2], -1)).reshape(xc.shape)
            taps.append((rows, torch.where(xc < Xn, other, 0) + lo - 1))
        else:
            taps.append((xc, rc + lo - 1))
    for ch in range(nch):
        F = [tap(ch, col, row) * (1 - vy) + tap(ch, col, row + 1) * vy for col, row in taps]
        out[..., ch, :, :] = F[0] * (1 - ux) + F[1] * ux
    return out


_MODE_ID = {m: i for i, m in enumerate(MODES)}


def sw_variant(mode: str, hm: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """The slice-warp forward in one ablation mode (replaces
    ``make_kernel(mode)``).

    Args:
      mode: one of ``MODES``.
      hm: (B, J, Wp, Hp) float32 heatmap planes, hm[b, ch, column, row], of
        an image of W x H (the probe's 240 x 128; Wp >= W, Hp >= H).
      xs, ys: (B, S/SB, SB, Xp, Yp) float32 image coordinates of each slice
        row's points, Y <= Yp <= Wp; the first Y (64) of a row's xs are its
        search table.
    Returns:
      (B, S/SB, SB, J, Xp, Yp) float32. j1 writes channel 0 only: on the card
      the other channels are left as ``torch.empty`` gave them.

    On the card it also needs Xp <= Wp, Wp * Hp a multiple of 4 and at most
    65536, S <= 65535 and hm 16-byte aligned, and raises otherwise.
    """
    if mode not in _MODE_ID:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    Bn, Jn, Wc, Hc = hm.shape
    if xs.dim() != 5 or xs.shape[0] != Bn or xs.shape != ys.shape:
        raise ValueError(f"xs, ys: shapes {tuple(xs.shape)}, {tuple(ys.shape)}; "
                         f"expected (B={Bn}, S/SB, SB, Xp, Yp) each")
    for name, t in (("hm", hm), ("xs", xs), ("ys", ys)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
    Xn, Yn = xs.shape[-2:]
    if not (Y <= Yn <= Wc and W <= Wc and H <= Hc):
        raise ValueError(f"need Y={Y} <= Yp <= Wp, W={W} <= Wp, H={H} <= Hp; "
                         f"got Yp={Yn}, Wp={Wc}, Hp={Hc}")
    if not kernel_route((hm, xs, ys)):
        return sw_variant_plain(mode, hm, xs, ys)
    s_all = xs.shape[1] * xs.shape[2]
    if Xn > Wc or Wc * Hc > 65536 or (Wc * Hc) % 4 or s_all > 65535:
        raise ValueError(f"the kernel takes Xp <= Wp, Wp * Hp a multiple of 4 and at most "
                         f"65536, S <= 65535; got Xp={Xn}, Wp={Wc}, Hp={Hc}, S={s_all}")
    if hm.data_ptr() % 16:
        raise ValueError("hm: the kernel reads 16-byte aligned planes; this view is not")
    lib = build.library("sw_variants")
    out = torch.empty((*xs.shape[:3], Jn, Xn, Yn), dtype=torch.float32, device=hm.device)
    mid = _MODE_ID[mode]
    n = lib.sp3d_sw_scratch_floats(mid, Bn, Jn, Wc, Hc)
    padded = torch.empty(n, dtype=torch.float32, device=hm.device) if n else None
    with torch.cuda.device(hm.device):
        err = lib.sp3d_sw_variant(hm.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
                                  None if padded is None else padded.data_ptr(), mid, Bn,
                                  s_all, Jn, Wc, Hc, Xn, Yn, W, H, Y,
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sp3d_sw_variant launch failed: CUDA error {err}")
    LAUNCHES["sw_variant"] += 1
    return out


def work(mode: str, hm_shape, xs_shape) -> dict:
    """The work the function needs, whatever the kernel does: ``bytes``
    (the planes of the written channels read once, xs and ys read once, the
    written channels of the output written once, float32), ``flops`` (about
    8 a point and written channel and 12 a point) and ``smem_loads`` (0:
    the taps are gathers from device memory; the kernel's staging in
    shared memory is a choice of design, not part of the work).

    Args: mode (one of ``MODES``), hm's shape (B, J, Wp, Hp), xs's shape
    (B, S/SB, SB, Xp, Yp)."""
    Bn, Jn, Wc, Hc = hm_shape
    pts = int(np.prod(xs_shape[1:]))  # points a batch element
    nch = 1 if mode == "j1" else Jn
    return {"bytes": 4 * (Bn * nch * Wc * Hc + 2 * Bn * pts + Bn * pts * nch),
            "flops": Bn * pts * (8 * nch + 12), "smem_loads": 0}


def make_inputs(device, seed: int = 0):
    """The probe's inputs (its ``run``): hm uniform in [0, 1); xs uniform in
    [0, 200) sorted along each row; ys uniform in [0, 100). Seeded numpy."""
    rng = np.random.default_rng(seed)
    hm = rng.random((B, J, Wp, Hp), dtype=np.float32)
    xs = np.sort(rng.random((B, S // SB, SB, Xp, Yp), dtype=np.float32) * np.float32(200), -1)
    ys = rng.random((B, S // SB, SB, Xp, Yp), dtype=np.float32) * np.float32(100)
    return tuple(torch.from_numpy(a).to(device) for a in (hm, xs, ys))


def measure(mode: str, hm, xs, ys) -> dict:
    """Kernel and plain ms of one mode (CUDA events; 10 kernel calls, 1
    plain call)."""
    return {
        f"{mode}_ms": cuda_ms(lambda: sw_variant(mode, hm, xs, ys), 10),
        f"{mode}_plain_ms": cuda_ms(lambda: sw_variant_plain(mode, hm, xs, ys), 1, warmup=1),
    }


def main(device="cuda") -> dict:
    dev = card(device)
    print(card_line(), flush=True)
    hm, xs, ys = make_inputs(dev)
    results = {}
    for mode in MODES:
        results.update(measure(mode, hm, xs, ys))
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
