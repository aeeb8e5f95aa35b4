"""LR schedule: MultiStepLR expressed per step (ref: tools/train_3d.py:194-196)."""

from __future__ import annotations

from typing import Callable, Sequence


def multistep_lr(
    base_lr: float, lr_steps: Sequence[int], lr_factor: float, steps_per_epoch: int
) -> Callable[[int], float]:
    """Piecewise-constant decay at epoch boundaries: the learning rate of
    the update that follows ``step`` completed updates is ``base_lr *
    lr_factor ** (number of boundaries <= step)``, a boundary being
    ``epoch * steps_per_epoch`` for each epoch of ``lr_steps``."""
    boundaries = sorted(int(e) * steps_per_epoch for e in lr_steps)

    def lr(step: int) -> float:
        return base_lr * lr_factor ** sum(b <= step for b in boundaries)

    return lr
