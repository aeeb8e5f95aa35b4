#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port ``selfpose3d_tpu_torch`` on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. ``<cell>`` names an entry of
``BENCHMARK.json``'s ``workloads``; everything the cell needs is found by
name under ``portbench/`` (README.md there). With ``--trace 0`` the run
measures the cell's end-to-end metrics over ``--seconds``; with
``--trace 1`` it measures the same window, then traces ``trace_calls``
calls with ``torch.profiler`` (``core/trace.py``) and reports the per-layer
metrics and a breakdown. Either way it then checks
what the timed path produced against the plain reference and prints each
number compared beside its limit, last on standard error and last in the
result, the one JSON line that ends standard output.

Exits 2 without a result when there is no CUDA card (or fewer than the cell
asks for), 4 when JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "selfpose3d_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package
    (whole names: ``selfpose3d_tpu_torch`` is not ``selfpose3d_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.core import runner, spec, timeline

    bench = spec.benchmark()
    work = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"portbench: needs {work['chips']} CUDA device(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    card = card_line()
    print(f"portbench: card {card}", file=sys.stderr)

    cell = spec.cell_file(args.workload)
    if (cell["config"], cell["traffic"]) != (work["config"], work["traffic"]):
        raise ValueError(f"cells/{args.workload}.json disagrees with BENCHMARK.json")
    ctx = runner.make_ctx(args.workload, args.seed, "cuda", cell, spec.traffic_file(cell["traffic"]))
    out = runner.run(ctx, args.seconds, bool(args.trace), T_START)

    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4

    wanted = spec.metrics_of(bench, args.workload)["per_layer" if args.trace else "end_to_end"]
    metrics = runner.metric_values(out, wanted)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": work["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"],
              "attempted": sum(c[2] for c in out["calls"]),
              "failed": 0, "metrics": metrics, "device": device, "card": card,
              "seed": args.seed, "calls": len(out["calls"]),
              "sampler_launches_per_call": out["sampler_launches_per_call"]}
    if args.trace:
        t = out["trace"]
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
        # what recording costs: each pass's mean call over the measured window's
        result["trace_stretch"] = {"device_only": t["stretch"], "with_host": t["named_stretch"]}
        print(f"portbench: traced calls over the window's, device-only {t['stretch']:.4f}, "
              f"with the host {t['named_stretch']:.4f}", file=sys.stderr)
    lat = timeline.latencies_ms(out["calls"])
    print(f"portbench: {len(lat)} calls, ms per call p05 {timeline.percentile(lat, 5):.3f} "
          f"p50 {timeline.percentile(lat, 50):.3f} p95 {timeline.percentile(lat, 95):.3f} "
          f"max {max(lat):.3f}; setup {out['setup_s']:.3f} s; check {out['check_s']:.3f} s",
          file=sys.stderr)
    result["check_s"] = out["check_s"]
    limits = cell["limits"]  # the numbers compared; the entry may compute more
    print("portbench: numbers " + json.dumps({k: v for k, v in out["numbers"].items()
                                              if k not in limits}), file=sys.stderr)
    result["checks"] = {k: {"value": out["numbers"][k] if math.isfinite(out["numbers"][k])
                            else str(out["numbers"][k]), "limit": v} for k, v in limits.items()}
    for k, v in limits.items():
        print(f"check {k} {out['numbers'][k]!r} limit {v!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
