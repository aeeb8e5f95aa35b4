"""The SSV train step (ref: lib/core/function.py:27-350).

The total loss is the sum of the mean of every loss term
(ref: function.py:95). PyTorch runs eagerly, so the step is a closure
over the stage gates, not a compiled program, and it updates the train
state in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from selfpose3d_tpu_torch.data.structures import AugBranch
from selfpose3d_tpu_torch.train.train_state import TrainState


def make_ssv_train_step(
    model, train_posenet_stage: bool, use_l1_stage: bool, k_cap: Optional[int] = None
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the SSV train step for the current epoch stage gates.

    ``k_cap`` is the PoseNet candidate cap (TRAIN.BUCKET_DISPATCH='meta').
    The returned ``train_step(state, b1, b2, b3, generator=None,
    synth_inject=None)`` runs forward, backward and one optimizer update on
    the device the model and the branches lie on, and returns the metrics:
    the mean of every loss term and their sum under ``"loss"``, detached.
    ``generator`` (a CPU ``torch.Generator``) feeds the synthetic-root
    draws; ``synth_inject`` replaces them.
    """

    def train_step(
        state: TrainState,
        b1: AugBranch,
        b2: AugBranch,
        b3: AugBranch,
        generator: Optional[torch.Generator] = None,
        synth_inject: Optional[dict] = None,
    ) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the train state belongs to another model")
        _, _, _, losses = model.ssv_losses(
            b1, b2, b3,
            train_posenet_stage=train_posenet_stage,
            use_l1_stage=use_l1_stage,
            train=True,
            k_cap=k_cap,
            generator=generator,
            synth_inject=synth_inject,
        )
        metrics = {k: v.mean() for k, v in losses.items()}
        total = sum(metrics.values())
        total.backward()
        state.apply_gradients()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = total.detach()
        return metrics

    return train_step
