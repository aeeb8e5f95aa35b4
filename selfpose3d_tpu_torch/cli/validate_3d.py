"""Validation CLI (ref: tools/validate_3d.py, tools/evaluate.py):

    python -m selfpose3d_tpu_torch.cli.validate_3d --cfg <yaml> [--test-file ckpt.pth.tar] [--epoch N]

Evaluates a reference checkpoint (``--test-file``, loaded whole and
strictly) or one of this package's own checkpoints under the config's
output directory (``--epoch``; default the best, else the latest), on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from selfpose3d_tpu_torch.cli.train_3d import add_common_args, datasets, load_cli_config
from selfpose3d_tpu_torch.device import resolve_device
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.train import checkpoint as ckpt
from selfpose3d_tpu_torch.train.loop import validate_3d
from selfpose3d_tpu_torch.train.train_state import create_train_state
from selfpose3d_tpu_torch.utils.logging_utils import create_logger


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate the multi-view 3D pose network")
    add_common_args(p)
    p.add_argument("--test-file", type=str, default="",
                   help="reference .pth.tar checkpoint to evaluate")
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch to load (default: best, else latest)")
    args = p.parse_args(argv)
    cfg = load_cli_config(args)
    logger, output_dir, _ = create_logger(cfg, args.cfg, "eval")
    model = get_model(cfg, device=resolve_device(args.device), seed=0)
    if args.test_file:
        logger.info("loading reference checkpoint %s", args.test_file)
        ckpt.load_torch_stage(model, args.test_file, "all")
    else:
        epoch = args.epoch or ckpt.best_checkpoint_epoch(output_dir)
        state, loaded, prec = ckpt.load_checkpoint(output_dir, create_train_state(cfg, model),
                                                   epoch)
        if not loaded:
            raise FileNotFoundError(f"no checkpoint under {output_dir}/checkpoints")
        logger.info("loaded epoch %d (precision %.4f)", loaded, prec)
    _, test_ds = datasets(cfg)
    precision = validate_3d(cfg, model, test_ds, output_dir, load_images=not args.no_images)
    logger.info("final precision (mean AP): %s", precision)
    return precision


if __name__ == "__main__":
    main()
