"""Checkpoints: ``torch.save`` of the train state, and staged loading of the
reference's ``.pth.tar`` files.

Replaces save_checkpoint / load_checkpoint (ref: lib/utils/utils.py:91-149)
and the staged loading of tools/train_3d.py:150-185:
  * ``output_dir/checkpoints/epoch_<N>.pt``: the model's, the optimizer's
    and the LR scheduler's state dicts and {epoch, step, precision};
    ``best_epoch.txt`` names the best epoch;
  * ``load_torch_stage``: a backbone, RootNet, PoseNet or the whole model
    from a reference checkpoint. The port keeps the reference's
    state-dict names, so this is a per-component ``load_state_dict``
    after stripping ``module.``;
  * ``load_pose_hrnet``: s4's HRNet from the HRNet repository's file.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from selfpose3d_tpu_torch.parallel import mesh
from selfpose3d_tpu_torch.train.train_state import TrainState

_EPOCH_FILE = re.compile(r"^epoch_(\d+)\.pt$")


def _ckpt_dir(output_dir: str) -> str:
    return os.path.abspath(os.path.join(output_dir, "checkpoints"))


def _epoch_path(output_dir: str, epoch: int) -> str:
    return os.path.join(_ckpt_dir(output_dir), f"epoch_{epoch}.pt")


def save_checkpoint(output_dir: str, state: TrainState, epoch: int, precision: float,
                    is_best: bool) -> str:
    """Write the checkpoint of ``epoch`` (completed epochs) and, with
    ``is_best``, record it as the best (ref: utils.py:109-115); -> its path.
    Across ranks only rank 0 writes, the model inside any DDP wrapper
    (``state.model``, so the keys are the model's), and every rank waits
    at a barrier until the file is there."""
    path = _epoch_path(output_dir, epoch)
    if mesh.rank() == 0:
        _write(path, state, epoch, precision, is_best)
    mesh.barrier()
    return path


def _write(path: str, state: TrainState, epoch: int, precision: float, is_best: bool) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "meta": {"epoch": int(epoch), "step": int(state.step), "precision": float(precision)},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader never sees half a file
    if is_best:
        with open(os.path.join(os.path.dirname(path), "best_epoch.txt"), "w") as f:
            f.write(str(epoch))


def latest_checkpoint_epoch(output_dir: str) -> Optional[int]:
    path = _ckpt_dir(output_dir)
    if not os.path.isdir(path):
        return None
    epochs = [int(m.group(1)) for m in map(_EPOCH_FILE.match, os.listdir(path)) if m]
    return max(epochs) if epochs else None


def best_checkpoint_epoch(output_dir: str) -> Optional[int]:
    best = os.path.join(_ckpt_dir(output_dir), "best_epoch.txt")
    if os.path.exists(best):
        with open(best) as f:
            return int(f.read().strip())
    return None


def load_checkpoint(output_dir: str, state: TrainState, epoch: Optional[int] = None):
    """Restore ``state`` in place from the checkpoint of ``epoch`` (default:
    the latest; ref: utils.py:91-107), onto the devices its tensors lie on;
    across ranks every rank reads the same file. Returns (state, epoch, precision); (state, 0, 0.0) when there is none."""
    if epoch is None:
        epoch = latest_checkpoint_epoch(output_dir)
    if epoch is None:
        return state, 0, 0.0
    # on the CPU: load_state_dict copies the model's tensors to its device and
    # the optimizer's moments to their parameters', and leaves Adam's step
    # counts on the CPU, where a fresh optimizer keeps them (a step count on
    # the card would cost a host sync per parameter and step)
    payload = torch.load(_epoch_path(output_dir, epoch), map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.scheduler.load_state_dict(payload["scheduler"])
    meta = payload["meta"]
    state.step = int(meta["step"])
    return state, int(meta["epoch"]), float(meta["precision"])


# ----------------------------------------------------------- stage surgery
class CheckpointKeyError(ValueError):
    """A reference checkpoint did not cover the target component (strict load)."""


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A .pth / .pth.tar file as a flat CPU state dict, ``module.`` stripped
    and a ``state_dict`` entry unwrapped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {
        (k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(v)
        for k, v in obj.items()
    }


def _is_bare_pose_resnet(sd) -> bool:
    """A state dict saved from a bare PoseResNet (e.g. the released COCO
    pose_resnet_50_384x288.pth) has unprefixed keys like 'conv1.weight'."""
    return "conv1.weight" in sd and not any(
        k.startswith(("backbone.", "root_net.", "pose_net.", "attn.")) for k in sd
    )


def _loadable(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state dict without BatchNorm's ``num_batches_tracked``
    (unused by the forward; kept as it is, as the JAX package keeps none)."""
    return {k: v for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


@torch.no_grad()
def _copy_into(module: nn.Module, values: Dict[str, torch.Tensor]) -> None:
    target = module.state_dict()
    for k, v in values.items():
        target[k].copy_(v)


def _strict(module: nn.Module, sd, prefix: str, what: str, path: str) -> None:
    """Strict load (ref: tools/train_3d.py:158,171,178 load_state_dict(strict=True)):
    every entry of the module must come from the file, with its shape."""
    sub = {k[len(prefix):]: v for k, v in sd.items()
           if k.startswith(prefix) and not k.endswith("num_batches_tracked")}
    if not sub:
        raise CheckpointKeyError(f"{path}: no keys with prefix '{prefix}' load into {what}")
    want = _loadable(module)
    missing = sorted(set(want) - set(sub))
    unexpected = sorted(set(sub) - set(want))
    if missing or unexpected:
        raise CheckpointKeyError(
            f"strict load of {what}: missing={missing[:8]}{'...' if len(missing) > 8 else ''} "
            f"unexpected={unexpected[:8]}{'...' if len(unexpected) > 8 else ''} "
            f"({len(missing)} missing / {len(unexpected)} unexpected entries)"
        )
    for k, v in want.items():
        if tuple(sub[k].shape) != tuple(v.shape):
            raise CheckpointKeyError(
                f"strict load of {what}: shape mismatch at {k}: checkpoint "
                f"{tuple(sub[k].shape)} vs model {tuple(v.shape)}"
            )
    _copy_into(module, sub)


def _tolerant_resnet(module: nn.Module, sd, coco_mapping: Optional[Sequence[int]]) -> int:
    """The reference's shape-matching partial load of a bare PoseResNet file
    (ref: lib/utils/utils.py:118-149): entries whose name and shape match
    are copied, the rest skipped. The final layer is channel-remapped
    through ``coco_mapping`` when its joint count differs (ref:
    pose_resnet.py:216-222), and zeroed when the counts already match
    (the reference's init_weights quirk, pose_resnet.py:219-221).
    -> the number of entries copied."""
    want = _loadable(module)
    num_joints = want["final_layer.weight"].shape[0]
    values = {}
    for k, v in sd.items():
        if k.startswith("final_layer.") and coco_mapping is not None and v.shape[0] != num_joints:
            v = v[list(coco_mapping)]
        if k in want and tuple(v.shape) == tuple(want[k].shape):
            values[k] = v
    ck = sd.get("final_layer.weight")
    if ck is not None and ck.shape[0] == num_joints:
        for k in ("final_layer.weight", "final_layer.bias"):
            if k in values:
                values[k] = torch.zeros_like(values[k])
    _copy_into(module, values)
    return len(values)


def load_torch_stage(model: nn.Module, torch_path: str, component: str,
                     coco_mapping: Optional[Tuple[int, ...]] = None) -> nn.Module:
    """Load a reference .pth.tar / .pth checkpoint into ``model`` in place.

    component: 'backbone' | 'root_net' | 'pose_net' | 'all' | 'pretrained'.
      * full-model files (keys 'backbone.*', 'root_net.*', 'pose_net.*',
        'attn.backbone.*'; the stage files backbone_epoch20,
        cam5_rootnet_epoch2, cam5_posenet) load each component strictly;
      * a bare PoseResNet file (the released COCO pose_resnet_50_384x288.pth)
        loads tolerantly into the backbone ('backbone'), or into the
        backbone and the attention net ('pretrained', NETWORK.PRETRAINED,
        ref: pose_resnet.py:274-284,321-333), with the final-layer remap.

    Raises ``CheckpointKeyError`` when the file does not fully cover the
    requested component or nothing loads, and ``FileNotFoundError`` for a
    missing file: a stage never trains from random init by accident.
    """
    sd = load_torch_checkpoint(torch_path)
    bare = _is_bare_pose_resnet(sd)
    merged = 0
    if component in ("backbone", "all"):
        if bare:
            if component == "all":
                raise CheckpointKeyError(
                    f"{torch_path}: bare PoseResNet state dict cannot initialize the full model"
                )
            merged += _tolerant_resnet(model.backbone, sd, coco_mapping)
        else:
            _strict(model.backbone, sd, "backbone.", "backbone", torch_path)
            merged += 1
    for net in ("root_net", "pose_net"):
        if component in (net, "all") and hasattr(model, net):
            _strict(getattr(model, net).v2v_net, sd, f"{net}.v2v_net.", f"{net}/v2v_net",
                    torch_path)
            merged += 1
    if component == "all" and hasattr(model, "attn"):
        _strict(model.attn.backbone, sd, "attn.backbone.", "attn/backbone", torch_path)
        merged += 1
    if component == "pretrained":
        if not bare:
            raise CheckpointKeyError(
                f"{torch_path}: NETWORK.PRETRAINED expects a bare PoseResNet state dict "
                "(e.g. pose_resnet_50_384x288.pth)"
            )
        merged += _tolerant_resnet(model.backbone, sd, coco_mapping)
        if hasattr(model, "attn"):
            merged += _tolerant_resnet(model.attn.backbone, sd, coco_mapping)
    if not merged:
        raise CheckpointKeyError(
            f"{torch_path}: nothing loaded for component '{component}': wrong file or "
            f"wrong key layout (first keys: {sorted(sd)[:5]})"
        )
    return model


def load_pose_hrnet(model: nn.Module, path: str) -> nn.Module:
    """Load the HRNet repository's checkpoint of a top-down HRNet (a bare
    state dict, as pose_hrnet_w48_384x288.pth; ``module.`` and a
    ``state_dict`` entry taken off) into the port's ``PoseHighResolutionNet``
    strictly: a missing or unexpected entry, or a shape that differs,
    raises ``CheckpointKeyError``."""
    sd = load_torch_checkpoint(path)
    if any(k.startswith(("backbone.", "root_net.", "pose_net.", "attn.")) for k in sd):
        raise CheckpointKeyError(f"{path}: a multi-view model's checkpoint, not a bare HRNet's")
    _strict(model, sd, "", "pose_hrnet", path)
    return model


def save_reference_checkpoint(model: nn.Module, path: str) -> str:
    """``model``'s weights in the reference's released layout, which
    ``load_torch_stage`` reads: ``{"state_dict": {"module.<key>": tensor}}``
    on the CPU (a DataParallel model's state dict, ref: tools/train_3d.py
    save_checkpoint)."""
    sd = {f"module.{k}": v.detach().cpu() for k, v in model.state_dict().items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": sd}, path)
    return path
