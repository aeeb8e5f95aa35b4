"""Synthetic multi-view scenes and seeded weights, made from the seed.

The scene generator is a frozen copy of the program's synthetic Panoptic
scene (a ring of inward-looking HD cameras around the capture space,
Panoptic-scale 15-joint skeletons, target heatmaps rendered from the
projected joints); the weight generator follows the program's seeded
"weights with spread" (fan-in-scaled kernels, BatchNorm near identity, the
root output bias lifted by 1 so that proposals are not decided by ties),
drawn on the device in two calls. Images are uniform noise drawn on the
device in one call. Batches are dicts of tensors; ``cam`` is a dict of
R, T, f, c, k, p.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import geometry as geo


def sub_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed for numpy from the run's seed and the item's keys."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *keys]).generate_state(1)[0])


def ring_cameras(views: int, orig_wh, seed32: int) -> Dict[str, np.ndarray]:
    rs = np.random.RandomState(seed32)
    target = np.array([0.0, -500.0, 800.0])
    R, T = [], []
    for i in range(views):
        ang = 2 * np.pi * i / views + rs.uniform(-0.15, 0.15)
        pos = np.array([4800.0 * np.cos(ang), 4800.0 * np.sin(ang), 1600.0 + rs.uniform(-200, 200)])
        R.append(geo.look_at(pos, target))
        T.append(pos.reshape(3, 1))
    W, H = orig_wh
    return {
        "R": np.stack(R).astype(np.float32), "T": np.stack(T).astype(np.float32),
        "f": np.full((views, 2), 1500.0, np.float32),
        "c": np.tile([W / 2.0, H / 2.0], (views, 1)).astype(np.float32),
        "k": np.zeros((views, 3), np.float32), "p": np.zeros((views, 2), np.float32),
    }


def random_poses(people: int, joints: int, seed32: int, root_idx: int) -> np.ndarray:
    rs = np.random.RandomState(seed32)
    roots = np.stack([rs.uniform(-2000, 2000, people), rs.uniform(-2500, 1500, people),
                      rs.uniform(700, 1100, people)], -1)
    poses = roots[:, None] + rs.randn(people, joints, 3) * np.array([220.0, 220.0, 320.0])
    poses[:, root_idx] = roots
    return poses.astype(np.float32)


def scene(cfg, batch: int, people: int, seed: int, item: int, rot_deg: float = 0.0) -> dict:
    """One batch of ``batch`` frame sets of one camera rig, without images:
    cameras, image affine, targets and labels, all float32 CPU tensors."""
    V, J, P = cfg.views, cfg.joints, cfg.max_people
    cams = ring_cameras(V, cfg.orig_wh, sub_seed(seed, item, 0))
    cam = {k: torch.from_numpy(np.broadcast_to(v, (batch,) + v.shape).copy()) for k, v in cams.items()}
    trans = geo.image_affine(np.array(cfg.orig_wh, np.float64) / 2.0,
                             geo.pad_scale(cfg.orig_wh, cfg.image_wh), rot_deg, cfg.image_wh)
    trans = torch.from_numpy(np.tile(trans, (batch, V, 1, 1)))
    poses = torch.from_numpy(np.stack([
        random_poses(people, J, sub_seed(seed, item, 10 + b), cfg.root_idx) for b in range(batch)]))
    pix = geo.affine(geo.project(poses.reshape(batch, 1, people * J, 3), cam), trans)
    pix = pix.reshape(batch, V, people, J, 2)
    target = geo.gaussian_heatmaps(pix, cfg.heatmap_wh, cfg.sigma).permute(0, 1, 3, 4, 2)
    joints = torch.zeros((batch, V, P, J, 2))
    joints[:, :, :people] = pix
    vis = torch.zeros((batch, V, P, J, 2))
    vis[:, :, :people] = 1.0
    return {
        "cam": cam, "trans": trans,
        "orig_wh": torch.tensor(cfg.orig_wh, dtype=torch.float32).expand(batch, V, 2).contiguous(),
        "hflip": torch.zeros(batch, dtype=torch.bool),
        "target_2d": target.contiguous(), "joints": joints, "joints_vis": vis,
    }


def noise_images(n: int, cfg, seed: int, device) -> torch.Tensor:
    """(n, V, H, W, 3) uniform noise in [0, 1), drawn on ``device`` in one call."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1 << 20))
    W, H = cfg.image_wh
    return torch.rand((n, cfg.views, H, W, 3), generator=g, device=device)


# The BatchNorm that ends each residual branch starts at a tenth of the
# others' scale (the small-gamma residual init of Goyal et al. 2017, which
# torchvision's zero_init_residual takes to 0): with every branch at full
# scale, a train-mode BatchNorm ResNet at random weights is chaotic, and
# bfloat16 rounding alone moves a ResNet-50's output by half its norm.
RESIDUAL_SCALE = 0.1
# PoseNet's score layer is drawn at this share of the fan-in scale: the
# soft-argmax (beta 100) then spreads its weight over some tens to
# thousands of voxels, as over a trained network's smooth heatmap, and not
# on the one largest of a quarter million random scores, where rounding
# picks which voxel wins.
SCORE_SCALE = 0.05


def seeded_weights(spec: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``spec`` (name -> (shape, kind)) drawn
    from the seed on ``device``: kernels N(0, 1/fan_in) (fan-in of a
    transposed kernel: its first axis), BatchNorm scales and running
    variances U(0.75, 1.25) (a residual branch's last scale times
    RESIDUAL_SCALE), biases and running means N(0, 0.05^2), counts 0; the
    root output bias lifted by 1, PoseNet's score kernel times SCORE_SCALE."""
    normal: List[tuple] = []
    uniform: List[tuple] = []
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, kind) in spec.items():
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind in ("bn_weight", "bn_last", "bn_var"):
            uniform.append((name, shape, kind))
        else:
            normal.append((name, shape, kind))
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1 << 21))
    n = sum(int(np.prod(s)) for _, s, _ in normal)
    u = sum(int(np.prod(s)) for _, s, _ in uniform)
    z = torch.randn(n, generator=g, device=device)
    r = torch.rand(u, generator=g, device=device)
    at = 0
    for name, shape, kind in normal:
        k = int(np.prod(shape))
        t = z[at:at + k].view(shape)
        if kind in ("conv", "conv_score"):
            t = t / float(np.prod(shape[1:])) ** 0.5 * (SCORE_SCALE if kind == "conv_score" else 1.0)
        elif kind == "deconv":
            t = t / float(shape[0]) ** 0.5
        else:
            t = t * 0.05
        out[name] = t.clone()
        at += k
    at = 0
    for name, shape, kind in uniform:
        k = int(np.prod(shape))
        out[name] = (0.75 + 0.5 * r[at:at + k].view(shape)) * (RESIDUAL_SCALE if kind == "bn_last" else 1.0)
        at += k
    out["root_net.v2v_net.output_layer.bias"] += 1.0
    return out
