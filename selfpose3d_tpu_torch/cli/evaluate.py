"""Evaluation CLI (ref: tools/evaluate.py), the port's counterpart of
``selfpose3d_tpu/cli/evaluate.py``:

    python -m selfpose3d_tpu_torch.cli.evaluate --cfg <yaml> [--test-file ckpt.pth.tar] [--epoch N]

Evaluates a reference checkpoint (``--test-file``, loaded whole and
strictly) or one of this package's own checkpoints under the config's
output directory (``--epoch``; default the best, else the latest) on the
config's test dataset, on the card unless ``--device cpu``; writes the
metrics to the log and ``predictions_dump.pkl`` beside it.
``--vis-attn`` also writes the attention maps of the first four test
frames to ``attn_vis.png``; ``--dry-assets`` only checks that the dataset
and the checkpoint load, without running the model.
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from selfpose3d_tpu_torch.cli.train_3d import add_common_args, load_cli_config
from selfpose3d_tpu_torch.data.loader import collate_branch
from selfpose3d_tpu_torch.data.registry import get_dataset
from selfpose3d_tpu_torch.device import resolve_device
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.train import checkpoint as ckpt
from selfpose3d_tpu_torch.train.loop import validate_3d
from selfpose3d_tpu_torch.train.train_state import create_train_state
from selfpose3d_tpu_torch.utils.logging_utils import create_logger
from selfpose3d_tpu_torch.utils.vis import save_batch_heatmaps
from selfpose3d_tpu_torch.utils.zipreader import imread_any


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate the multi-view 3D pose network")
    add_common_args(p)
    p.add_argument("--test-file", type=str, default="",
                   help="reference .pth.tar checkpoint to evaluate")
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch to load (default: best, else latest)")
    p.add_argument("--with-ssv", action="store_true",
                   help="accepted as the reference's command line has it; the model "
                        "is the config's MODEL")
    p.add_argument("--vis-attn", action="store_true",
                   help="write the attention maps of the first test frames to attn_vis.png")
    p.add_argument("--dry-assets", action="store_true",
                   help="only check that the test dataset and --test-file load: its "
                        "first image decodes and the checkpoint covers the model with "
                        "matching shapes; runs no model")
    return p.parse_args(argv)


def eval_dataset(cfg):
    return get_dataset(cfg, cfg.DATASET.TEST_DATASET, cfg.DATASET.TEST_SUBSET, False)


def dry_assets_check(cfg, test_file: str, logger: logging.Logger) -> int:
    """Exit code 0 when the test dataset builds from cfg.DATA_DIR, has
    frames and its first image decodes, and ``test_file`` (if given) loads
    strictly into the model (every tensor covered, shapes equal); 1 with
    each failure logged otherwise. The model is built on the CPU and never
    run."""
    failures = []
    try:
        ds = eval_dataset(cfg)
        n = len(ds)
        if n == 0:
            failures.append("dataset constructed but contains 0 frames")
        else:
            logger.info("dataset ok: %d frames", n)
            rec = getattr(ds, "db", None)
            if rec:
                img = rec[0].get("image", "")
                probe = imread_any(img)
                if probe is None:
                    failures.append(f"first image unreadable: {img}")
                else:
                    logger.info("image probe ok: %s (%dx%d)", img, probe.shape[1],
                                probe.shape[0])
    except (OSError, ValueError, KeyError, ImportError) as e:
        failures.append(f"dataset layout: {type(e).__name__}: {e}")

    if test_file:
        try:
            ckpt.load_torch_stage(get_model(cfg, device="cpu", seed=0), test_file, "all")
            logger.info("checkpoint manifest ok: %s covers the full model with matching "
                        "shapes", test_file)
        except (OSError, ValueError, KeyError, RuntimeError) as e:
            failures.append(f"checkpoint manifest: {type(e).__name__}: {e}")
    else:
        logger.info("no --test-file given; skipping checkpoint manifest check")

    for f in failures:
        logger.error("DRY-ASSETS FAIL: %s", f)
    if not failures:
        logger.info("DRY-ASSETS OK: dataset + checkpoint plumbing validated")
    return 1 if failures else 0


def save_attention(model, ds, output_dir: str, load_images: bool) -> str:
    """The attention maps of the first (up to) four test frames, as one
    heatmap grid of the first four (frame, view) maps (ref:
    tools/evaluate.py:110-118)."""
    dev = next(model.parameters()).device
    frames = [ds.get_frame(i, load_images=load_images) for i in range(min(4, len(ds)))]
    branch = collate_branch([f["views"] for f in frames]).to(dev)
    modes = {m: m.training for m in model.modules()}
    try:
        model.eval()
        with torch.no_grad():
            attns = model.do_inference(branch, visualize_attn=True)[3]
    finally:
        for m, training in modes.items():
            m.train(training)
    a = attns.float().cpu().numpy()
    path = f"{output_dir}/attn_vis.png"
    save_batch_heatmaps(None, a.reshape(-1, *a.shape[2:])[:4], path)
    return path


def main(argv=None):
    args = parse_args(argv)
    cfg = load_cli_config(args)
    logger, output_dir, _ = create_logger(cfg, args.cfg, "eval")
    if args.dry_assets:
        sys.exit(dry_assets_check(cfg, args.test_file, logger))
    model = get_model(cfg, device=resolve_device(args.device), seed=0)
    if args.test_file:
        # a missing or mismatched file is a hard error: never evaluate random weights
        logger.info("loading reference checkpoint %s", args.test_file)
        ckpt.load_torch_stage(model, args.test_file, "all")
    else:
        epoch = args.epoch or ckpt.best_checkpoint_epoch(output_dir)
        _, loaded, prec = ckpt.load_checkpoint(output_dir, create_train_state(cfg, model), epoch)
        if not loaded:
            raise FileNotFoundError(f"no checkpoint under {output_dir}/checkpoints")
        logger.info("loaded epoch %d (precision %.4f)", loaded, prec)
    ds = eval_dataset(cfg)
    load_images = not args.no_images
    if args.vis_attn and cfg.WITH_ATTN:
        logger.info("wrote attention grids to %s",
                    save_attention(model, ds, output_dir, load_images))
    precision = validate_3d(cfg, model, ds, output_dir, load_images=load_images)
    logger.info("final precision (mean AP): %s", precision)
    return precision


if __name__ == "__main__":
    main()
