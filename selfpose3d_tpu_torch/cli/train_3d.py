"""Training CLI (ref: tools/train_3d.py):

    python -m selfpose3d_tpu_torch.cli.train_3d --cfg configs/synthetic/magnitude_ssv.yaml

Trains on the card (``--device cpu`` for the CPU), validates after every
epoch unless NETWORK.TRAIN_ONLY_2D, and writes a checkpoint per epoch
under ``OUTPUT_DIR/<dataset>/<model>/<cfg name>/checkpoints`` with the
best epoch's number in ``best_epoch.txt``. TRAIN.RESUME continues from
the latest checkpoint there. ``--set SECTION.KEY=VALUE`` overrides one
config entry (a YAML value), e.g. ``--set TRAIN.END_EPOCH=30``. With
DEBUG.DEBUG the SSV epochs write their debug dumps (PNG; the 3D plots of
DEBUG.SAVE_3D_POSES / SAVE_3D_ROOTS need matplotlib) under
``<output dir>/debug``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import yaml

from selfpose3d_tpu_torch.config import load_config
from selfpose3d_tpu_torch.data.registry import get_dataset
from selfpose3d_tpu_torch.device import resolve_device
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.train import checkpoint as ckpt
from selfpose3d_tpu_torch.train.loop import train_epoch_ssv, train_epoch_supervised, validate_3d
from selfpose3d_tpu_torch.train.train_state import create_train_state
from selfpose3d_tpu_torch.utils.logging_utils import TBWriter, create_logger


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cfg", required=True, type=str)
    p.add_argument("--no-images", action="store_true",
                   help="drive the pipeline from input heatmaps only")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", action="append", default=[], metavar="SECTION.KEY=VALUE",
                   help="override one config entry (a YAML value); repeatable")


def load_cli_config(args):
    """The YAML of ``--cfg`` with the ``--set`` overrides."""
    overrides: dict = {}
    for item in args.set:
        key, _, value = item.partition("=")
        *sections, leaf = key.strip().split(".")
        node = overrides
        for s in sections:
            node = node.setdefault(s, {})
        node[leaf] = yaml.safe_load(value)
    return load_config(args.cfg, overrides=overrides or None)


def datasets(cfg):
    train_ds = get_dataset(cfg, cfg.DATASET.TRAIN_DATASET, cfg.DATASET.TRAIN_SUBSET, True)
    test_ds = get_dataset(cfg, cfg.DATASET.TEST_DATASET, cfg.DATASET.TEST_SUBSET, False)
    return train_ds, test_ds


def load_stages(cfg, model, logger) -> None:
    """Staged weight surgery (ref: tools/train_3d.py:150-180). A missing file
    or a key layout that does not cover its component is a hard error: a
    stage never trains from random init by accident."""
    mapping = tuple(cfg.COCO_TO_PANOPTIC_MAPPING)
    if cfg.NETWORK.PRETRAINED and os.path.isfile(cfg.NETWORK.PRETRAINED):
        # the reference ships a default path here and tolerates its absence
        logger.info("loading pretrained backbone+attn from %s", cfg.NETWORK.PRETRAINED)
        ckpt.load_torch_stage(model, cfg.NETWORK.PRETRAINED, "pretrained", coco_mapping=mapping)
    if cfg.NETWORK.PRETRAINED_BACKBONE:
        logger.info("loading backbone from %s", cfg.NETWORK.PRETRAINED_BACKBONE)
        ckpt.load_torch_stage(model, cfg.NETWORK.PRETRAINED_BACKBONE, "backbone",
                              coco_mapping=mapping)
    if cfg.NETWORK.INIT_ROOTNET:
        logger.info("loading rootnet from %s", cfg.NETWORK.INIT_ROOTNET)
        ckpt.load_torch_stage(model, cfg.NETWORK.INIT_ROOTNET, "root_net")
    if cfg.NETWORK.INIT_ALL:
        logger.info("loading all weights from %s", cfg.NETWORK.INIT_ALL)
        ckpt.load_torch_stage(model, cfg.NETWORK.INIT_ALL, "all")


def main(argv=None, report: Optional[dict] = None) -> float:
    """Trains and validates as the config says -> the best precision.
    ``report``, where given, receives the last epoch's ``meters_out``
    (``epoch``) and its validation's ``metrics_out`` (``validation``)."""
    p = argparse.ArgumentParser(description="Train the multi-view 3D pose network")
    add_common_args(p)
    args = p.parse_args(argv)
    cfg = load_cli_config(args)
    logger, output_dir, tb_dir = create_logger(cfg, args.cfg, "train")
    dev = resolve_device(args.device)
    logger.info("device: %s", dev)

    model = get_model(cfg, device=dev, seed=0)
    load_stages(cfg, model, logger)
    train_ds, test_ds = datasets(cfg)
    steps_per_epoch = max(1, len(train_ds) // max(1, cfg.TRAIN.BATCH_SIZE))
    state = create_train_state(cfg, model, steps_per_epoch)
    start_epoch = cfg.TRAIN.BEGIN_EPOCH
    best_precision = 0.0
    if cfg.TRAIN.RESUME:
        state, start_epoch, best_precision = ckpt.load_checkpoint(output_dir, state)
        logger.info("resumed at epoch %d (best %.4f)", start_epoch, best_precision)

    writer = TBWriter(tb_dir)
    load_images = not args.no_images
    for epoch in range(start_epoch, cfg.TRAIN.END_EPOCH):
        logger.info("Epoch: %d", epoch)
        meters, metrics = {}, {}
        if cfg.MODEL == "multi_person_posenet_ssv":
            train_epoch_ssv(cfg, model, state, train_ds, epoch, writer=writer,
                            load_images=load_images, output_dir=output_dir, meters_out=meters)
        else:
            train_epoch_supervised(cfg, model, state, train_ds, epoch, writer=writer,
                                   load_images=load_images, meters_out=meters)
        precision = None
        if not cfg.NETWORK.TRAIN_ONLY_2D:
            precision = validate_3d(cfg, model, test_ds, output_dir, load_images=load_images,
                                    metrics_out=metrics)
        if report is not None:
            report.update(epoch=meters, validation=metrics)
        is_best = precision is not None and precision > best_precision
        if is_best:
            best_precision = precision
        logger.info("saving checkpoint (best: %s)", is_best)
        ckpt.save_checkpoint(output_dir, state, epoch + 1, best_precision, is_best)
    writer.close()
    return best_precision


if __name__ == "__main__":
    main()
