"""Experiment logging setup (ref: lib/utils/utils.py:24-77)."""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Tuple

from selfpose3d_tpu_torch.config import Config, get_model_name


def create_logger(cfg: Config, cfg_name: str, phase: str = "train") -> Tuple[logging.Logger, str, str]:
    """Per-run output dir + file/console logging + TensorBoard dir:
    ``OUTPUT_DIR/<train dataset>/<model>/<cfg name>`` and
    ``LOG_DIR/<train dataset>/<model>/<cfg name>_<time>``."""
    root_output_dir = Path(cfg.OUTPUT_DIR)
    root_output_dir.mkdir(parents=True, exist_ok=True)
    dataset = cfg.DATASET.TRAIN_DATASET
    model, _ = get_model_name(cfg)
    cfg_name = os.path.basename(cfg_name).split(".")[0]

    final_output_dir = root_output_dir / dataset / model / cfg_name
    final_output_dir.mkdir(parents=True, exist_ok=True)

    time_str = time.strftime("%Y-%m-%d-%H-%M")
    final_log_file = final_output_dir / f"{cfg_name}_{time_str}_{phase}.log"
    # explicit handlers: an earlier basicConfig would make a second one a no-op
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    fh = logging.FileHandler(str(final_log_file))
    fh.setFormatter(fmt)
    fh.setLevel(logging.INFO)
    logger.addHandler(fh)
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(fmt)
    logger.addHandler(console)

    tb_log_dir = Path(cfg.LOG_DIR) / dataset / model / (cfg_name + "_" + time_str)
    tb_log_dir.mkdir(parents=True, exist_ok=True)
    return logger, str(final_output_dir), str(tb_log_dir)


class TBWriter:
    """Minimal TensorBoard scalar writer; writes nothing when TensorBoard
    is absent."""

    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except Exception:
            pass

    def add_scalar(self, tag, value, step):
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def close(self):
        if self._writer is not None:
            self._writer.close()
