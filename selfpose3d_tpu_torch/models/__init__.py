"""Model registry and the entry point ``get_model``."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from selfpose3d_tpu_torch.device import resolve_device
from selfpose3d_tpu_torch.models.multi_person import MultiPersonPoseNet, MultiPersonPoseNetSSV
from selfpose3d_tpu_torch.models.pose_hrnet import PoseHighResolutionNet
from selfpose3d_tpu_torch.models.pose_net import PoseNet
from selfpose3d_tpu_torch.models.pose_resnet import PoseResAttnNet, PoseResNet
from selfpose3d_tpu_torch.models.root_net import RootNet, SupervisedProposal
from selfpose3d_tpu_torch.models.v2v_net import V2VNet

_REGISTRY = {
    "multi_person_posenet": MultiPersonPoseNet,
    "multi_person_posenet_ssv": MultiPersonPoseNetSSV,
    "pose_hrnet": PoseHighResolutionNet.from_config,  # s4's top-down model
}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init drawn from ``generator`` (on the CPU), with the JAX
    package's scales: lecun-normal backbone convs; normal(0, 0.001) for the
    backbone's deconvs and final layer and every V2V conv (ref:
    pose_resnet.py:228-248, v2v_net.py:135-144) and every HRNet conv (ref:
    HRNet's pose_hrnet.py:472-490); zero biases; identity BN."""

    lecun = {
        id(sub)
        for p in model.modules() if isinstance(p, PoseResNet)
        for sub in p.modules() if isinstance(sub, nn.Conv2d) and sub is not p.final_layer
    }
    for m in model.modules():
        if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
            std = 1.0 / math.sqrt(m.weight[0].numel()) if id(m) in lecun else 0.001
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            if m.bias is not None:
                m.bias.zero_()


def get_model(cfg, device="cuda", dtype=None, seed: int = 0) -> nn.Module:
    """Build the configured model (cfg.MODEL) in eval mode on ``device``,
    randomly initialised from ``seed``. Parameters are float32; ``dtype``
    is the compute dtype the convolutions cast them to at use.

    Runs on the card unless ``device="cpu"``; raises when CUDA is asked for
    and absent. ``dtype`` defaults to cfg.DTYPE. Sets TF32 off for both
    matmuls and cuDNN convolutions, so float32 configs compute in float32.
    """
    dev = resolve_device(device)
    if cfg.MODEL not in _REGISTRY:
        raise KeyError(f"unknown MODEL {cfg.MODEL!r}; available: {sorted(_REGISTRY)}")
    if dtype is None:
        dtype = torch.bfloat16 if cfg.DTYPE == "bfloat16" else torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = _REGISTRY[cfg.MODEL](cfg, dtype=dtype)
    model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


__all__ = [
    "MultiPersonPoseNet",
    "MultiPersonPoseNetSSV",
    "PoseHighResolutionNet",
    "PoseNet",
    "PoseResAttnNet",
    "PoseResNet",
    "RootNet",
    "SupervisedProposal",
    "V2VNet",
    "get_model",
    "init_weights",
]
