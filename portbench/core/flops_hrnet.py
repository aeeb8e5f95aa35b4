"""The convolution FLOPs of s4's top-down HRNet (``reference/hrnet.py``), from
the shapes: 2 x the multiply-adds of every convolution, at its output's
resolution, as ``torch.utils.flop_counter`` counts them (bias, BatchNorm,
ReLU, the sums and the upsampling left out)."""

from __future__ import annotations

import re

from portbench.reference.hrnet import param_spec


def _out_hw(name: str, in_hw, branches_of_stage) -> tuple:
    """The output (H, W) of the convolution ``name`` at input ``in_hw``."""
    h, w = in_hw

    def at(level: int):  # branch ``level``: 1/4 of the crop, halved a level
        return -(-h // (4 << level)), -(-w // (4 << level))

    if name == "conv1":
        return -(-h // 2), -(-w // 2)
    if name in ("conv2", "final_layer") or name.startswith("layer1."):
        return at(0)
    m = re.match(r"transition(\d)\.(\d+)\.(?:(\d+)\.)?0$", name)
    if m:
        s, i, k = int(m.group(1)) + 1, int(m.group(2)), m.group(3)
        if k is None:  # a kept branch that changes width
            return at(i)
        return at(branches_of_stage[s - 1] - 1 + int(k) + 1)
    m = re.match(r"stage\d\.\d+\.branches\.(\d+)\.", name)
    if m:
        return at(int(m.group(1)))
    m = re.match(r"stage\d\.\d+\.fuse_layers\.(\d+)\.(\d+)\.(?:(\d+)\.)?0$", name)
    if m:
        i, j, k = int(m.group(1)), int(m.group(2)), m.group(3)
        return at(j) if k is None else at(j + int(k) + 1)
    raise ValueError(f"no resolution for {name}")


def network_flops(extra: dict, joints: int, in_hw) -> int:
    """One crop's convolution FLOPs at ``in_hw`` (H, W)."""
    branches = {1: 1, **{s: len(extra[f"STAGE{s}"]["NUM_CHANNELS"]) for s in (2, 3, 4)}}
    total = 0
    for name, (shape, kind) in param_spec(extra, joints).items():
        if kind != "conv":
            continue
        conv = name[: -len(".weight")]
        oh, ow = _out_hw(conv, in_hw, branches)
        cout, cin, kh, kw = shape
        total += 2 * cout * cin * kh * kw * oh * ow
    return total


def topdown_flops(extra: dict, joints: int, in_hw, crops: int, flip: bool) -> int:
    """A call's: ``crops`` crops, each run twice with the flip test."""
    return network_flops(extra, joints, in_hw) * crops * (2 if flip else 1)
