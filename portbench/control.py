#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the program's numbers and the
control's, seed by seed, at a cell's own size, in one process a seed list.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--control N] [--out FILE]

For each seed: the cell's set-up, the timed path's first ``check_calls``
calls (inference) or its first steps and the window's compared step
(training), the program's numbers against the float32 reference (the
lower readings), then the control's: the reference itself in the
program's place with every convolution's input and weight rounded to
float8 e4m3 (``reference/model.py``), judged by the same comparison (the
upper readings). ``--fault`` plants a fault in the program instead
(``FAULTS``) and reads the program's numbers with it. One JSON line a
seed, also appended to ``--out``. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _adjoint(scale: float):
    """The program's ``sample_view_adjoint`` with its result times ``scale``."""
    from selfpose3d_tpu_torch.ops import slicewarp

    real = slicewarp.sample_view_adjoint

    def faulty(*args, **kw):
        return real(*args, **kw) * scale

    slicewarp.sample_view_adjoint = faulty


FAULTS = {"adjoint_negated": lambda: _adjoint(-1.0), "adjoint_zeroed": lambda: _adjoint(0.0)}


def readings(workload: str, seed: int, device="cuda", traffic=None, yaml=None, cell=None,
             with_control: bool = True) -> dict:
    import torch

    from portbench.core import compare, runner, spec

    cell = cell or spec.cell_file(workload)
    traffic = traffic or spec.traffic_file(cell["traffic"])
    ctx = runner.make_ctx(workload, seed, device, cell, traffic, yaml)
    prog = spec.entry(cell["entry"]).Program(ctx)
    out = {"workload": workload, "seed": seed}
    if traffic["task"] == "train":
        for i in range(compare.STEPS, prog.window_at + 1):  # the window up to its compared step
            prog.call(i)
        prog.release()
        gc.collect()
        out["program"] = compare.train_numbers(
            prog.record, prog.reference_run(follow=prog.record["centres"]))
        out["program"].update(prog.window_numbers())
        if with_control:
            ctl = prog.reference_run(fp8=True)
            out["control"] = compare.train_numbers(ctl, prog.reference_run(follow=ctl["centres"]))
            out["control"].update(prog.window_numbers(prog.window_grads(fp8=True)["all"]))
    else:
        kept = [prog.call(i) for i in range(traffic.get("check_calls", 1))]
        prog.release()
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        out["program"] = prog.check(kept)
        del kept
        if with_control:
            out["control"] = prog.check([prog.control(i)
                                         for i in range(traffic.get("check_calls", 1))])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--control", type=int, default=None,
                    help="read the control on the first N seeds only (default: all)")
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None,
                    help="plant this fault in the program (and read no control)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if args.fault:
        FAULTS[args.fault]()
        args.control = 0

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA device", file=sys.stderr)
        return 2
    n_control = len(args.seeds) if args.control is None else args.control
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        row = readings(args.workload, seed, with_control=i < n_control)
        row["fault"] = args.fault
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
