"""Train and inference steps (ref: lib/core/function.py:27-350).

The total loss of a train step is the sum of the mean of every loss term
(ref: function.py:95). PyTorch runs eagerly, so each step is a closure
over its model and gates, not a compiled program, and a train step updates
the train state in place.

Across ranks (``parallel/mesh.py``) a train step takes the model that
``distribute`` wraps in DDP, which averages the gradients over ranks; the
train state holds the model inside the wrapper.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn as nn

from selfpose3d_tpu_torch.config import Config
from selfpose3d_tpu_torch.data.structures import AugBranch
from selfpose3d_tpu_torch.parallel import mesh
from selfpose3d_tpu_torch.train.train_state import TrainState


class SSVLosses(nn.Module):
    """``model.ssv_losses`` as a module's ``forward``: DDP reduces the
    gradients only of what its wrapped ``forward`` computes, and
    ``MultiPersonPoseNetSSV``'s train entry is a method."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.ssv_losses(*args, **kwargs)


def inner_model(model: nn.Module) -> nn.Module:
    """The model inside ``distribute``'s wrapper (``model`` itself otherwise)."""
    if isinstance(model, nn.parallel.DistributedDataParallel):
        model = model.module
    return model.model if isinstance(model, SSVLosses) else model


def ssv_sits_out(cfg: Config, train_posenet_stage: bool) -> bool:
    """Whether a trainable sub-network gets no gradient in an SSV train
    step: PoseNet before INIT_TRAIN_EPOCHS_ROOTNET, the attention net
    whenever PoseNet's projection losses do not run or under
    SINGLE_AUG_TRAINING_POSENET (which weighs no term by it)."""
    n = cfg.NETWORK
    has_pose_net = not (n.TRAIN_ONLY_2D or n.TRAIN_ONLY_ROOTNET)
    pose_runs = has_pose_net and train_posenet_stage
    attn_out = cfg.WITH_ATTN and (not pose_runs or n.SINGLE_AUG_TRAINING_POSENET)
    return (has_pose_net and not pose_runs) or attn_out


def distribute(model: nn.Module, cfg: Config, epochs: Iterable[int] = (0,)) -> nn.Module:
    """The model of the train steps across ranks: the SSV model's
    ``ssv_losses`` (through ``SSVLosses``) or the supervised model in DDP
    (``mesh.wrap_model``), with ``find_unused_parameters`` set when a
    trainable sub-network sits out a step of any of ``epochs``; the model
    itself without a process group. Call it after ``create_train_state``,
    which decides what trains."""
    if not hasattr(model, "ssv_losses"):
        return mesh.wrap_model(model, find_unused=False)
    find_unused = any(
        ssv_sits_out(cfg, e >= cfg.NETWORK.INIT_TRAIN_EPOCHS_ROOTNET) for e in epochs)
    return mesh.wrap_model(SSVLosses(model), find_unused=find_unused)


def make_ssv_train_step(
    model, train_posenet_stage: bool, use_l1_stage: bool, k_cap: Optional[int] = None
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the SSV train step for the current epoch stage gates.

    ``model`` is the SSV model or its ``distribute`` wrapper. ``k_cap`` is
    the PoseNet candidate cap (TRAIN.BUCKET_DISPATCH='meta').
    The returned ``train_step(state, b1, b2, b3, generator=None,
    synth_inject=None)`` runs forward, backward and one optimizer update on
    the device the model and the branches lie on, and returns the metrics:
    the mean of every loss term and their sum under ``"loss"``, detached.
    ``generator`` (a CPU ``torch.Generator``) feeds the synthetic-root
    draws; ``synth_inject`` replaces them.
    """
    inner = inner_model(model)
    ssv_losses = inner.ssv_losses if model is inner else model

    def train_step(
        state: TrainState,
        b1: AugBranch,
        b2: AugBranch,
        b3: AugBranch,
        generator: Optional[torch.Generator] = None,
        synth_inject: Optional[dict] = None,
    ) -> Dict[str, torch.Tensor]:
        if state.model is not inner:
            raise ValueError("the train state belongs to another model")
        _, _, _, losses = ssv_losses(
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
    ``train_step(state, branch)`` runs ``model(branch, train=True)`` (the
    model or its ``distribute`` wrapper), its backward and one optimizer
    update, and returns the metrics as ``make_ssv_train_step``'s do."""
    inner = inner_model(model)

    def train_step(state: TrainState, branch: AugBranch) -> Dict[str, torch.Tensor]:
        if state.model is not inner:
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
