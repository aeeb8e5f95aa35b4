"""The inputs of a run: a pool of distinct batches in pinned host memory,
copied to the device ``non_blocking`` for each call as the program's loop
copies its batches; and the program's batch type built from them."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.core import scene

FIELDS = ("cam", "trans", "orig_wh", "hflip", "views", "target_2d", "joints", "joints_vis")


def pinned(t: torch.Tensor) -> torch.Tensor:
    return t.pin_memory() if torch.cuda.is_available() else t.contiguous()


def make_pool(cfg, traffic: dict, seed: int, device, rotations=(0.0,)) -> List[List[dict]]:
    """``traffic["pool"]`` items, each a list of one batch per rotation (the
    augmentation branches of a train step share the rig and the people and
    differ in the image affine and the images), host tensors, pinned."""
    B, n = traffic["batch"], traffic["pool"]
    imgs = scene.noise_images(n * len(rotations) * B, cfg, seed, device)
    host = torch.empty(imgs.shape, dtype=imgs.dtype, pin_memory=torch.cuda.is_available())
    host.copy_(imgs)
    del imgs
    host = host.reshape(n, len(rotations), B, *host.shape[1:])
    pool = []
    for i in range(n):
        branches = []
        for r, rot in enumerate(rotations):
            b = scene.scene(cfg, B, traffic["people"], seed, i, rot_deg=rot)
            b["views"] = host[i, r]
            b["cam"] = {k: pinned(v) for k, v in b["cam"].items()}
            for k in FIELDS[1:]:
                if k != "views":
                    b[k] = pinned(b[k])
            branches.append(b)
        pool.append(branches)
    return pool


def to_device(b: dict, device, fields=FIELDS) -> Dict:
    out = {}
    for k in fields:
        v = b[k]
        out[k] = ({n: t.to(device, non_blocking=True) for n, t in v.items()} if isinstance(v, dict)
                  else v.to(device, non_blocking=True))
    return out


def aug_branch(d: dict):
    """The program's batch type over device tensors ``d``."""
    from selfpose3d_tpu_torch.data.structures import AugBranch
    from selfpose3d_tpu_torch.geometry.cameras import CameraParams

    return AugBranch(cam=CameraParams(**d["cam"]), trans=d["trans"], orig_wh=d["orig_wh"],
                     hflip=d["hflip"], views=d["views"], target_2d=d.get("target_2d"),
                     joints=d.get("joints"), joints_vis=d.get("joints_vis"))
