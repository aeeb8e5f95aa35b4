"""Where the PyTorch port's flagship SSV train step spends its time on one GPU.

    python3 scripts/profile_torch_train.py [--reps 3]

The flagship cam5 config with every candidate kept valid (THRESHOLD = -100),
batch cfg.TRAIN.BATCH_SIZE, random weights from seed 0, three synthetic
augmentation branches, Adam, through ``make_ssv_train_step``. After one
warm-up step it times ``--reps`` steps on the host clock. Then it traces
``--reps`` steps with torch.profiler: device-busy share, device time by
kernel family, the top kernels, the device time of the port's three
samplers by name, and the stages per step as the port's own spans record
them (``selfpose3d_tpu_torch/utils/spans.py``: backbone on 3B*V images,
attention net on 2B*V, RootNet, PoseNet on 2B*K cubes, the losses after
PoseNet with the matching, backward, optimizer; device ms from the CUDA
events around each, total and self) with the host syncs a step makes. One
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
from profile_torch_inference import stages_per_call, summarize_trace  # noqa: E402
from selfpose3d_tpu_torch.models import get_model  # noqa: E402
from selfpose3d_tpu_torch.ops import slicewarp, unproject  # noqa: E402
from selfpose3d_tpu_torch.train import create_train_state, make_ssv_train_step  # noqa: E402
from selfpose3d_tpu_torch.utils import spans  # noqa: E402


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
    step = make_ssv_train_step(model, train_posenet_stage=True, use_l1_stage=True)

    def one_step():
        step(state, *branches, generator=gen)
        torch.cuda.synchronize()

    one_step()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        one_step()
    wall_ms = (time.perf_counter() - t0) / args.reps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    cotangents = adjoint_cotangents(one_step)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    slicewarp.reset_launches()
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            one_step()
        traced_wall_us = (time.perf_counter() - t0) * 1e6
    samplers = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "sample_view" in e.name:
            key = e.name.split("<")[0].split("::")[-1]
            samplers[key][0] += (e.time_range.end - e.time_range.start) / 1e3 / args.reps
            samplers[key][1] += 1
    print(json.dumps({
        "nvidia_smi": smi, "batch": B, "reps": args.reps,
        "train_step_ms": round(wall_ms, 3), "samples_per_s": round(B * 1e3 / wall_ms, 4),
        "per_traced_step": stages_per_call(args.reps),
        "peak_mem_gib": round(peak, 3),
        "launches_per_step": {k: n / args.reps for k, n in slicewarp.LAUNCHES.items()},
        "adjoint_cotangents": cotangents,
        "sampler_device_ms_per_step": {k: {"ms": round(v[0], 3), "launches": v[1] / args.reps}
                                       for k, v in samplers.items()},
        "traced_steps": summarize_trace(prof, traced_wall_us),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
