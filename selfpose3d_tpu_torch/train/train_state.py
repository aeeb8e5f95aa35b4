"""Train state: the model, its optimizer and the per-step LR schedule.

Parameters are float32 whatever the compute dtype (the convolutions cast
at use, ``models/norm.py``), so the optimizer updates float32 values.
Frozen sub-networks (ref: tools/train_3d.py:48-75) get
``requires_grad=False``, no update and no optimizer state, mirroring
``filter(lambda p: p.requires_grad, ...)``. Adam is ``m / (sqrt(v) + eps)``
with eps 1e-8 and SGD is momentum without dampening: the update rules of
the JAX package's optax transforms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn as nn

from selfpose3d_tpu_torch.config import Config
from selfpose3d_tpu_torch.train.schedule import multistep_lr


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad``, then the
        schedule moves on and the gradients are dropped."""
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def trainable_labels(cfg: Config) -> Dict[str, bool]:
    """Which top-level sub-network trains under the stage flags
    (ref: tools/train_3d.py:48-75); a name not listed trains."""
    return {
        "backbone": bool(cfg.NETWORK.TRAIN_BACKBONE),
        "attn": True,  # the attention net trains whenever present
        "pose_net": not cfg.NETWORK.TRAIN_ONLY_2D and not cfg.NETWORK.TRAIN_ONLY_ROOTNET,
        "root_net": (
            not cfg.NETWORK.TRAIN_ONLY_2D
            and not cfg.NETWORK.USE_GT
            and not cfg.NETWORK.FREEZE_ROOTNET
        ),
    }


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.Optimizer:
    """Adam or SGD from cfg.TRAIN over the trainable sub-networks; sets
    ``requires_grad`` of every parameter to its sub-network's label."""
    labels = trainable_labels(cfg)
    params = []
    for name, child in model.named_children():
        train = labels.get(name, True)
        for p in child.parameters():
            p.requires_grad_(train)
            if train:
                params.append(p)
    if cfg.TRAIN.OPTIMIZER == "adam":
        return torch.optim.Adam(params, lr=cfg.TRAIN.LR, betas=(0.9, 0.999), eps=1e-8)
    if cfg.TRAIN.OPTIMIZER == "sgd":
        return torch.optim.SGD(
            params, lr=cfg.TRAIN.LR, momentum=cfg.TRAIN.MOMENTUM, nesterov=cfg.TRAIN.NESTEROV
        )
    raise ValueError(f"unknown optimizer {cfg.TRAIN.OPTIMIZER}")


def create_train_state(cfg: Config, model: nn.Module, steps_per_epoch: int = 1) -> TrainState:
    """The train state of ``model`` (on whatever device it lies)."""
    optimizer = make_optimizer(cfg, model)
    lr = multistep_lr(1.0, cfg.TRAIN.LR_STEP, cfg.TRAIN.LR_FACTOR, steps_per_epoch)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lr)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)
