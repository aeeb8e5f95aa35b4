"""Horizontal-flip utilities for joints and heatmaps (the port's copy of
``selfpose3d_tpu/utils/flip.py``)
(ref: lib/utils/transforms.py:19-50)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def flip_back(output_flipped: np.ndarray, matched_parts: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Un-flip test-time-augmented heatmaps (N, J, H, W)
    (ref: transforms.py:19-33)."""
    assert output_flipped.ndim == 4
    out = output_flipped[:, :, :, ::-1].copy()
    for a, b in matched_parts:
        tmp = out[:, a].copy()
        out[:, a] = out[:, b]
        out[:, b] = tmp
    return out


def fliplr_joints(
    joints: np.ndarray,
    joints_vis: np.ndarray,
    width: int,
    matched_parts: Sequence[Tuple[int, int]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Flip 2D joints horizontally and swap left/right parts
    (ref: transforms.py:36-50)."""
    joints = joints.copy()
    joints_vis = joints_vis.copy()
    joints[:, 0] = width - joints[:, 0] - 1
    for a, b in matched_parts:
        joints[[a, b]] = joints[[b, a]]
        joints_vis[[a, b]] = joints_vis[[b, a]]
    return joints * joints_vis, joints_vis


def flip_pairs_from_order(flip_order: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """[0,1,2,9,10,...] permutation -> ((3,9),(4,10),...) swap pairs."""
    pairs = []
    for i, j in enumerate(flip_order):
        if i < j:
            pairs.append((i, j))
    return tuple(pairs)
