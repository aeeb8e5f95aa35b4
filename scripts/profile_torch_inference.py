"""Where the PyTorch port's flagship do_inference spends its time on one GPU.

    python3 scripts/profile_torch_inference.py [--batch 8] [--reps 5]

The flagship cam5 config (selfpose3d_tpu_torch.config.flagship_cfg) with
random weights from seed 0 on the synthetic 3-person scene. Times
do_inference on the host clock, then traces ``--reps`` calls with
torch.profiler: the device-busy share of their wall time, device time by
kernel family, the top kernels, and the stages per call as the port's own
spans record them (``selfpose3d_tpu_torch/utils/spans.py``: backbone, RootNet
holding its proposals, PoseNet; device ms from the CUDA events around each,
total and self) with the host syncs a call makes. Prints one JSON line.
Needs a CUDA device.
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
from selfpose3d_tpu_torch.utils import spans  # noqa: E402


def stages_per_call(calls: int) -> dict:
    """The spans recorded over ``calls`` traced calls, per call: each
    name's device and host ms, total and self, and the host syncs."""
    s = spans.summary()
    out = {name: {k: round(v[k] / calls, 3) for k in
                  ("device_ms", "device_self_ms", "host_ms", "host_self_ms")}
           for name, v in s["spans"].items()}
    syncs = sum(n for r in s["roots"] for k, n in r["counts"].items()
                if k.startswith("host_syncs."))
    return {"device_clock": s["device_clock"], "stages": out, "host_syncs": syncs / calls}


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

    t0 = time.perf_counter()
    for _ in range(args.reps):
        model.do_inference(br)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.reps * 1e3

    from torch.profiler import ProfilerActivity, profile

    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            model.do_inference(br)
        torch.cuda.synchronize()
        traced_wall_us = (time.perf_counter() - t0) * 1e6
    traced = summarize_trace(prof, traced_wall_us)
    print(json.dumps({
        "nvidia_smi": smi, "batch": args.batch, "reps": args.reps,
        "do_inference_ms": round(wall_ms, 3),
        "frames_per_s": round(args.batch * 1e3 / wall_ms, 3),
        "per_traced_call": stages_per_call(args.reps),
        "traced_calls": traced,
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
