"""Convergence harness: show that the SSV training loop learns.

Drives the real code path (``train_epoch_ssv`` -> the SSV train step ->
``validate_3d``) on a synthetic-scene config from random init, records
every per-step loss term, and evaluates root and pose metrics before,
during and after training; the counterpart of
``selfpose3d_tpu/train/convergence.py`` and
``scripts/train_convergence.py``:

    python -m selfpose3d_tpu_torch.train.convergence \\
        --cfg configs/synthetic/magnitude_ssv.yaml --epochs 60 \\
        --eval-every 4 --frames 64 --out build/magnitude.json

runs on the card (``--device cpu`` for the CPU) and prints the head->tail
drop of every loss term and the evaluations. With ``--out`` the partial
result is written to ``<out>.partial`` after every epoch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class RecordingWriter:
    """TensorBoard-writer-compatible recorder (``train_epoch_ssv`` logs each
    loss term through ``add_scalar`` every PRINT_FREQ steps)."""

    def __init__(self):
        self.series: Dict[str, List[float]] = {}

    def add_scalar(self, key: str, value: float, step: int):
        self.series.setdefault(key, []).append(float(value))

    def close(self):
        pass


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, (list, tuple)):
            out[k] = [float(x) for x in v]
        elif isinstance(v, (int, float, np.floating, np.integer)):
            out[k] = float(v)
    return out


def head_tail_means(series: List[float], k: int = 10):
    """(mean of the first k, mean of the last k): the drop statistic."""
    arr = np.asarray(series, np.float64)
    k = min(k, len(arr) // 2) or 1
    return float(arr[:k].mean()), float(arr[-k:].mean())


def run_convergence(
    cfg_path: str = "configs/synthetic/tiny_ssv.yaml",
    epochs: int = 4,
    out_path: Optional[str] = None,
    num_frames: int = 64,
    device="cuda",
    eval_every: int = 0,
) -> dict:
    """Train ``epochs`` SSV epochs of ``cfg_path`` (PRINT_FREQ 1: every step
    recorded) from the random init of ``get_model(cfg, device, seed=0)``
    on ``num_frames`` training frames; -> {"series": per-term loss lists,
    "eval_init", "eval_curve" (every ``eval_every`` epochs), "eval_final",
    "steps", "seconds" (wall time of the epochs, their evaluations
    included), "train_seconds" (of the train epochs alone),
    "data_seconds" (the train loop's wait for the loader), "device"}.
    Runs on the card unless ``device="cpu"``."""
    import torch

    from selfpose3d_tpu_torch.config import load_config
    from selfpose3d_tpu_torch.data.registry import get_dataset
    from selfpose3d_tpu_torch.models import get_model
    from selfpose3d_tpu_torch.train.loop import train_epoch_ssv, validate_3d
    from selfpose3d_tpu_torch.train.train_state import create_train_state

    cfg = dataclasses.replace(load_config(cfg_path), PRINT_FREQ=1)
    model = get_model(cfg, device=device, seed=0)
    dev = next(model.parameters()).device
    train_ds = get_dataset(cfg, cfg.DATASET.TRAIN_DATASET, cfg.DATASET.TRAIN_SUBSET, True)
    if hasattr(train_ds, "num_frames"):
        train_ds.num_frames = num_frames
    test_ds = get_dataset(cfg, cfg.DATASET.TEST_DATASET, cfg.DATASET.TEST_SUBSET, False)
    steps_per_epoch = max(1, len(train_ds) // max(1, cfg.TRAIN.BATCH_SIZE))
    state = create_train_state(cfg, model, steps_per_epoch)

    eval_init: dict = {}
    validate_3d(cfg, model, test_ds, metrics_out=eval_init)
    logger.info("init eval: recall500_root=%.4f mpjpe_root=%.1f",
                eval_init.get("recall500_root", float("nan")),
                eval_init.get("mpjpe_root", float("nan")))

    writer = RecordingWriter()
    eval_curve: List[dict] = []
    train_seconds = data_seconds = 0.0
    t0 = time.time()
    for epoch in range(epochs):
        meters: dict = {}
        state = train_epoch_ssv(cfg, model, state, train_ds, epoch, writer=writer,
                                meters_out=meters)
        train_seconds += meters["seconds"]
        data_seconds += meters["data_time"].sum
        if eval_every and (epoch + 1) % eval_every == 0:
            m: dict = {}
            validate_3d(cfg, model, test_ds, metrics_out=m)
            m = _jsonable(m)
            m["epoch"] = epoch + 1
            eval_curve.append(m)
            logger.info("epoch %d eval: recall500_root=%.4f mpjpe_root=%.1f", epoch + 1,
                        m.get("recall500_root", float("nan")),
                        m.get("mpjpe_root", float("nan")))
        if out_path:
            partial = {
                "cfg": cfg_path, "epochs_done": epoch + 1, "epochs": epochs,
                "steps": len(writer.series.get("train/loss", [])),
                "seconds": time.time() - t0, "train_seconds": train_seconds,
                "data_seconds": data_seconds, "series": writer.series,
                "eval_init": _jsonable(eval_init), "eval_curve": eval_curve,
            }
            with open(out_path + ".partial", "w") as fh:
                json.dump(partial, fh)

    seconds = time.time() - t0
    eval_final: dict = {}
    validate_3d(cfg, model, test_ds, metrics_out=eval_final)
    logger.info("final eval: recall500_root=%.4f mpjpe_root=%.1f",
                eval_final.get("recall500_root", float("nan")),
                eval_final.get("mpjpe_root", float("nan")))
    result = {
        "cfg": cfg_path,
        "epochs": epochs,
        "steps": len(writer.series.get("train/loss", [])),
        "seconds": seconds,
        "train_seconds": train_seconds,
        "data_seconds": data_seconds,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "series": writer.series,
        "eval_init": _jsonable(eval_init),
        "eval_curve": eval_curve,
        "eval_final": _jsonable(eval_final),
    }
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(result, fh)
        logger.info("wrote %s", out_path)
    return result


def report(res: dict) -> None:
    """The printout of scripts/train_convergence.py."""
    print(f"\n== convergence over {res['steps']} steps ({res['seconds']:.0f}s) ==")
    for key, series in sorted(res["series"].items()):
        h, t = head_tail_means(series)
        print(f"{key:28s} first10 {h:12.6f} -> last10 {t:12.6f} "
              f"({'down' if t < h else 'UP'} {t / max(h, 1e-12):.3f}x)")
    for tag in ("eval_init", "eval_final"):
        m = res[tag]
        print(f"{tag}: recall500_root={m.get('recall500_root', float('nan')):.4f} "
              f"mpjpe_root={m.get('mpjpe_root', float('nan')):.1f} "
              f"recall500={m.get('recall500', float('nan')):.4f} "
              f"mpjpe={m.get('mpjpe', float('nan')):.1f}")
    for m in res.get("eval_curve", []):
        print(f"  epoch {m['epoch']:3d}: "
              f"recall500_root={m.get('recall500_root', float('nan')):.4f} "
              f"mpjpe_root={m.get('mpjpe_root', float('nan')):.1f}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="SSV convergence run of the PyTorch port")
    p.add_argument("--cfg", default="configs/synthetic/tiny_ssv.yaml")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--out", default="")
    p.add_argument("--frames", type=int, default=64, help="training frames per epoch")
    p.add_argument("--eval-every", type=int, default=0,
                   help="validate every N epochs (the eval curve)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    res = run_convergence(cfg_path=args.cfg, epochs=args.epochs, out_path=args.out or None,
                          num_frames=args.frames, device=args.device,
                          eval_every=args.eval_every)
    report(res)
    return res


if __name__ == "__main__":
    main()
