"""Train and inference steps (ref: lib/core/function.py:27-350).

The total loss of a train step is the sum of the mean of every loss term
(ref: function.py:95). PyTorch runs eagerly, so each step is a closure
over its model and gates, not a compiled program, and a train step updates
the train state in place.
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
        return _update(state, losses)

    return train_step


def _update(state: TrainState, losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Backward of the sum of the terms' means and one optimizer update;
    -> the detached means and their sum under ``"loss"``."""
    metrics = {k: v.mean() for k, v in losses.items()}
    total = sum(metrics.values())
    total.backward()
    state.apply_gradients()
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss"] = total.detach()
    return metrics


def make_supervised_train_step(model) -> Callable[[TrainState, AugBranch], Dict[str, torch.Tensor]]:
    """The train step of the supervised baseline (ref: function.py:219-350):
    ``train_step(state, branch)`` runs ``model(branch, train=True)``, its
    backward and one optimizer update, and returns the metrics as
    ``make_ssv_train_step``'s do."""

    def train_step(state: TrainState, branch: AugBranch) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the train state belongs to another model")
        _, _, _, losses = model(branch, train=True)
        return _update(state, losses)

    return train_step


def make_inference_step(model) -> Callable[[AugBranch], tuple]:
    """``infer(branch)`` -> ``model.do_inference(branch)`` without autograd
    (ref: multi_person_posenet_ssv.py:105-153)."""

    @torch.no_grad()
    def infer(branch: AugBranch):
        return model.do_inference(branch)

    return infer


def make_ssv_debug_forward(model, train_posenet_stage: bool, use_l1_stage: bool):
    """The prediction-bearing forward of the train loop's debug dumps (the
    reference renders predicted heatmaps, 3D poses and root cubes every
    PRINT_FREQ, ref: lib/core/function.py:176-217; the train step returns
    only metrics): ``fwd(b1, b2, b3)`` -> (pred2, heatmaps3, grid_centers)
    of ``ssv_losses(..., train=False)``, without autograd. With
    ``train=False`` RootNet's synthetic-root pass is skipped and its
    supervised 3D-cube term reads ``target_3d``."""

    @torch.no_grad()
    def fwd(b1: AugBranch, b2: AugBranch, b3: AugBranch):
        pred2, hm3, gc, _ = model.ssv_losses(
            b1, b2, b3, train_posenet_stage=train_posenet_stage,
            use_l1_stage=use_l1_stage, train=False,
        )
        return pred2, hm3, gc

    return fwd
