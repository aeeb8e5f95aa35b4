"""Where the PyTorch port's flagship SSV train step spends its time on one GPU.

    python3 scripts/profile_torch_train.py [--reps 3]

The flagship cam5 config with every candidate kept valid (THRESHOLD = -100),
batch cfg.TRAIN.BATCH_SIZE, random weights from seed 0, three synthetic
augmentation branches, Adam. After one warm-up step it times, with CUDA
events, the forward (``ssv_losses``), the backward and the optimizer update
of each step, and inside the forward the four sub-networks (forward hooks:
backbone on 3B*V images, attention net on 2B*V, RootNet's V2V twice, PoseNet's
V2V on 2B*K cubes); what is left of the forward is sampling, projection,
rendering, matching and the losses. Then it traces one step with
torch.profiler: device-busy share, device time by kernel family, the top
kernels, and the device time of the port's three samplers by name. One
more step reads what the adjoint kernel is given: per launch its view, the
share of cotangent rows (points) and elements that are exactly zero, which
the kernel skips, and how the zero rows split into points outside that
view's image (in-image weight 0) and points inside it; and it times the
kernel on one launch's own cotangent, on a dense uniform one at the same
points, and on the dense one with the own cotangent's zeros put in. Prints one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from chip_smoke import cuda_ms, train_branches, train_cfg  # noqa: E402
from profile_torch_inference import summarize_trace  # noqa: E402
from selfpose3d_tpu_torch.models import get_model  # noqa: E402
from selfpose3d_tpu_torch.ops import slicewarp, unproject  # noqa: E402
from selfpose3d_tpu_torch.train import create_train_state  # noqa: E402


class ForwardTimer:
    """CUDA events around every forward call of a module."""

    def __init__(self, module):
        self.pairs = []
        module.register_forward_pre_hook(self._start)
        module.register_forward_hook(self._stop)

    def _start(self, module, args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs.append([ev, None])

    def _stop(self, module, args, output):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs[-1][1] = ev

    def take_ms(self) -> float:
        total = sum(a.elapsed_time(b) for a, b in self.pairs)
        self.pairs = []
        return total


def adjoint_cotangents(one_step):
    """Run one step with ``sample_view_adjoint`` wrapped: the zero shares of
    every launch's cotangent, and the kernel's time on the first launch's
    cotangent beside a dense one at the same points."""
    launch = slicewarp.sample_view_adjoint
    bounded_mean = unproject.sample_views_bounded_mean
    seen, kept, views = [], [], []

    def remember(heatmaps, px, py, bounding):
        if heatmaps.requires_grad:  # PoseNet's call: the one with a backward
            views.append((px, bounding))
        return bounded_mean(heatmaps, px, py, bounding)

    def wrapped(g, px, py, hw):
        all_px, bounding = views[-1]
        (v,) = [v for v in range(all_px.shape[1]) if torch.equal(all_px[:, v], px)]
        zero_row = (g == 0).all(-1)
        outside = bounding[:, v] == 0
        seen.append({"view": v, "points": g.shape[0] * g.shape[1],
                     "zero_rows": float(zero_row.float().mean()),
                     "zero_elements": float((g == 0).float().mean()),
                     "points_outside_the_view": float(outside.float().mean()),
                     "zero_rows_outside_the_view": float((zero_row & outside).float().mean()),
                     "zero_rows_inside_the_view": float((zero_row & ~outside).float().mean())})
        if not kept:
            kept.append((g.clone(), px.clone(), py.clone(), hw))
        return launch(g, px, py, hw)

    slicewarp.sample_view_adjoint = wrapped
    unproject.sample_views_bounded_mean = remember
    try:
        one_step()
    finally:
        slicewarp.sample_view_adjoint = launch
        unproject.sample_views_bounded_mean = bounded_mean
    g, px, py, hw = kept[0]
    dense = torch.rand(g.shape, device=g.device, generator=torch.Generator(g.device).manual_seed(0))
    masked = dense * (g != 0)
    ms = {name: round(cuda_ms(lambda c=c: launch(c, px, py, hw), 10), 4)
          for name, c in (("own_cotangent", g), ("dense_uniform", dense),
                          ("dense_with_own_zeros", masked))}
    return {"per_launch": seen, "first_launch_kernel_ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = train_cfg()
    B = cfg.TRAIN.BATCH_SIZE
    model = get_model(cfg, device="cuda", seed=0)
    branches = train_branches(cfg, B, seed=0, device="cuda")
    state = create_train_state(cfg, model)
    gen = torch.Generator().manual_seed(0)
    timers = {"backbone_fwd": ForwardTimer(model.backbone), "attn_fwd": ForwardTimer(model.attn),
              "root_v2v_fwd_x2": ForwardTimer(model.root_net.v2v_net),
              "pose_v2v_fwd": ForwardTimer(model.pose_net.v2v_net)}

    def one_step(ms=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        _, _, _, losses = model.ssv_losses(*branches, train_posenet_stage=True,
                                           use_l1_stage=True, train=True, generator=gen)
        total = sum(v.mean() for v in losses.values())
        ev[1].record()
        total.backward()
        ev[2].record()
        state.apply_gradients()
        ev[3].record()
        torch.cuda.synchronize()
        nets = {k: t.take_ms() for k, t in timers.items()}
        if ms is not None:
            fwd = ev[0].elapsed_time(ev[1])
            for k, v in nets.items():
                ms[k] += v
            ms["forward_rest (sampling, projection, rendering, matching, losses)"] += (
                fwd - sum(nets.values()))
            ms["forward"] += fwd
            ms["backward"] += ev[1].elapsed_time(ev[2])
            ms["optimizer"] += ev[2].elapsed_time(ev[3])

    one_step()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ms = defaultdict(float)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        one_step(ms)
    wall_ms = (time.perf_counter() - t0) / args.reps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    cotangents = adjoint_cotangents(one_step)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    slicewarp.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        traced_wall_us = (time.perf_counter() - t0) * 1e6
    samplers = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "sample_view" in e.name:
            key = e.name.split("<")[0].split("::")[-1]
            samplers[key][0] += (e.time_range.end - e.time_range.start) / 1e3
            samplers[key][1] += 1
    print(json.dumps({
        "nvidia_smi": smi, "batch": B, "reps": args.reps,
        "train_step_ms": round(wall_ms, 3), "samples_per_s": round(B * 1e3 / wall_ms, 4),
        "stage_ms": {k: round(v / args.reps, 3) for k, v in ms.items()},
        "peak_mem_gib": round(peak, 3),
        "launches_per_step": dict(slicewarp.LAUNCHES),
        "adjoint_cotangents": cotangents,
        "sampler_device_ms": {k: {"ms": round(v[0], 3), "launches": v[1]}
                              for k, v in samplers.items()},
        "traced_step": summarize_trace(prof, traced_wall_us),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
