"""Where the PyTorch port's flagship do_inference spends its time on one GPU.

    python3 scripts/profile_torch_inference.py [--batch 8] [--reps 5]

The flagship cam5 config (selfpose3d_tpu_torch.config.flagship_cfg) with
random weights from seed 0 on the synthetic 3-person scene. Times the
stages of do_inference with CUDA events (backbone; RootNet sampling, V2V
and proposals; PoseNet), then traces one call with torch.profiler: the
device-busy share of its wall time, device time by kernel family, and the
top kernels. Prints one JSON line. Needs a CUDA device.
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from selfpose3d_tpu_torch.config import flagship_cfg  # noqa: E402
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch  # noqa: E402
from selfpose3d_tpu_torch.models import get_model  # noqa: E402
from selfpose3d_tpu_torch.ops.proposal import proposals_soft  # noqa: E402


def timed(ms, name, fn, reps):
    """fn() between two CUDA events; adds its mean device time to ms[name]."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    ms[name] += a.elapsed_time(b) / reps
    return out


def run_stages(model, br, ms, reps):
    """do_inference's calls, in its order, each timed as a stage."""
    rn = model.root_net
    hm = timed(ms, "backbone", lambda: model.heatmaps(br), reps)
    cubes = timed(ms, "root_sampling", lambda: rn.unproject(
        model.root_heatmaps(hm), br.cam, br.trans, br.orig_wh), reps)
    rc = timed(ms, "root_v2v", lambda: rn.v2v_net(cubes)[..., 0], reps)
    gc = timed(ms, "proposals", lambda: proposals_soft(
        rc, rn.max_people, rn.threshold, rn.space_size, rn.space_center, rn.cube_size), reps)
    timed(ms, "pose_net", lambda: model.pose_net(hm, br.cam, br.trans, br.orig_wh, gc), reps)


def family(name: str) -> str:
    n = name.lower()
    if "sample_view" in n:
        return "port samplers (CUDA)"
    if any(k in n for k in ("conv", "cudnn", "xmma", "gemm", "cutlass", "fprop", "dgrad", "wgrad",
                            "implicit", "wgmma")):
        return "convolution / matmul"
    if "batch_norm" in n or "batchnorm" in n:
        return "batch norm (train mode)"
    if "multi_tensor" in n or "adam" in n:
        return "optimizer (foreach)"
    if "pool" in n:
        return "pooling"
    if "sort" in n or "radix" in n:
        return "sort (top-k)"
    return "elementwise / other"


def summarize_trace(prof, wall_us: float) -> dict:
    """One traced window: the device-busy share of its wall time (union of
    the kernels' spans), device time by kernel family, the top kernels."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_family, by_name, counts = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_family[family(e.name)] += d / 1e3
        by_name[e.name[:90]] += d / 1e3
        counts[e.name[:90]] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "wall_ms": round(wall_us / 1e3, 3),
        "device_busy_ms": round(busy / 1e3, 3),
        "device_idle_share": round(1 - busy / wall_us, 4),
        "kernel_launches": len(kernels),
        "device_ms_by_family": {k: round(v, 3) for k, v in
                                sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": [[n, round(v, 3), counts[n]] for n, v in top],
    }


@torch.no_grad()
def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = flagship_cfg()
    model = get_model(cfg, device="cuda", seed=0)
    br, _ = make_synthetic_branch(cfg, batch_size=args.batch, num_person=3, seed=0,
                                  with_images=True, device="cuda")
    model.do_inference(br)
    torch.cuda.synchronize()

    ms = defaultdict(float)
    for _ in range(args.reps):
        run_stages(model, br, ms, args.reps)

    t0 = time.perf_counter()
    for _ in range(args.reps):
        model.do_inference(br)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.reps * 1e3

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.do_inference(br)
        torch.cuda.synchronize()
        traced_wall_us = (time.perf_counter() - t0) * 1e6
    traced = summarize_trace(prof, traced_wall_us)
    print(json.dumps({
        "nvidia_smi": smi, "batch": args.batch, "reps": args.reps,
        "do_inference_ms": round(wall_ms, 3),
        "frames_per_s": round(args.batch * 1e3 / wall_ms, 3),
        "stage_ms": {k: round(v, 3) for k, v in ms.items()},
        "traced_call": traced,
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
