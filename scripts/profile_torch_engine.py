"""Where the PyTorch port's training engine spends its time on one GPU: the
loader's host work beside the train step.

    python3 scripts/profile_torch_engine.py [--cfg configs/synthetic/magnitude_ssv.yaml]
        [--frames 64] [--set SECTION.KEY=VALUE ...]

The config (as the train CLI reads it, ``--set`` overrides included; its
datasets must be synthetic) at PRINT_FREQ 1, random weights from seed 0.
One warm-up epoch, then two cases of one epoch each, first timed and then
traced with torch.profiler:
  loader    as the YAML runs: WORKERS loader threads build each batch
            (scenes, targets, images) while the main thread steps;
  prebuilt  the epoch's frames built before it starts, so the workers only
            collate.
For each case: ms per step (the epoch's wall over its steps), each step's
ms between the loop's synchronising metric reads, the loop's data wait,
and in the traced epoch the device-busy share (``summarize_trace`` of
profile_torch_inference.py). Prints one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from profile_torch_inference import summarize_trace  # noqa: E402
from selfpose3d_tpu_torch.cli.train_3d import load_cli_config  # noqa: E402
from selfpose3d_tpu_torch.data.registry import get_dataset  # noqa: E402
from selfpose3d_tpu_torch.models import get_model  # noqa: E402
from selfpose3d_tpu_torch.train import create_train_state  # noqa: E402
from selfpose3d_tpu_torch.train.loop import train_epoch_ssv  # noqa: E402


class Prebuilt:
    """A dataset's SSV frames of one epoch, built up front."""

    def __init__(self, dataset, epoch: int):
        self.frames = [dataset.get_ssv_frame(i, seed=epoch) for i in range(len(dataset))]

    def __len__(self):
        return len(self.frames)

    def get_ssv_frame(self, idx, seed=0, load_images=True):
        return self.frames[idx]


class StepClock:
    """A writer that notes the host clock at each step's metric read."""

    def __init__(self):
        self.t = [time.perf_counter()]

    def add_scalar(self, key, value, step):
        if key == "train/loss":
            self.t.append(time.perf_counter())

    def step_ms(self):
        return [round((b - a) * 1e3, 3) for a, b in zip(self.t, self.t[1:])]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default="configs/synthetic/magnitude_ssv.yaml")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--set", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = dataclasses.replace(load_cli_config(args), PRINT_FREQ=1)
    dataset = get_dataset(cfg, cfg.DATASET.TRAIN_DATASET, cfg.DATASET.TRAIN_SUBSET, True)
    dataset.num_frames = args.frames
    steps = len(dataset) // cfg.TRAIN.BATCH_SIZE
    model = get_model(cfg, device="cuda", seed=0)
    state = create_train_state(cfg, model, steps)
    train_epoch_ssv(cfg, model, state, dataset, epoch=0)  # warm-up
    out = {"card": smi, "config": args.cfg, "set": args.set, "frames": args.frames,
           "batch": cfg.TRAIN.BATCH_SIZE, "workers": cfg.WORKERS, "steps": steps, "cases": {}}
    epoch = 1
    for case in ("loader", "prebuilt"):
        row = {}
        for traced in (False, True):
            ds = dataset if case == "loader" else Prebuilt(dataset, epoch)
            clock, meters = StepClock(), {}
            prof = None
            if traced:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                prof.start()
            t0 = time.perf_counter()
            train_epoch_ssv(cfg, model, state, ds, epoch=epoch, writer=clock, meters_out=meters)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            epoch += 1
            if traced:
                prof.stop()
                row["traced"] = {"ms_per_step": wall / steps * 1e3,
                                 **summarize_trace(prof, wall * 1e6)}
                row["traced"].pop("top_kernels_ms")
            else:
                row.update(ms_per_step=wall / steps * 1e3, steps_per_s=steps / wall,
                           data_wait_share=meters["data_time"].sum / wall,
                           step_ms=clock.step_ms())
        out["cases"][case] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
