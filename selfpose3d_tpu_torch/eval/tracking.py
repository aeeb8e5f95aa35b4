"""Greedy 3D track association across frames.

Re-implementation of the Munkres-based tracker in the reference's offline
renderer (ref: tools/visualize.py:411-470): per consecutive frame pair, build
the MPJPE cost matrix between previous-track poses and current detections,
solve the assignment, and append unmatched detections as new tracks. The
port's copy of ``selfpose3d_tpu/eval/tracking.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment


def track_sequence(
    poses_per_frame: Sequence[np.ndarray],
    scores_per_frame: Optional[Sequence[np.ndarray]] = None,
    score_threshold: float = 0.2,
) -> List[np.ndarray]:
    """Associate per-frame 3D poses into consistent track orderings.

    Args:
      poses_per_frame: per frame, (N_i, J, 3) world-mm poses.
      scores_per_frame: optional per frame (N_i,) detection scores; detections
        below ``score_threshold`` are dropped (ref: visualize.py:423-426
        KPT3D_THRESHOLD).
    Returns:
      per frame, an int array of indices reordering that frame's poses to
      track-consistent order (same track id = same position across frames);
      -1 entries mean "no detection for this track in this frame".
    """
    frames: List[np.ndarray] = []
    for i, poses in enumerate(poses_per_frame):
        poses = np.asarray(poses)
        if scores_per_frame is not None and len(poses):
            keep = np.asarray(scores_per_frame[i]) > score_threshold
            poses = poses[keep]
        frames.append(poses)

    orderings: List[np.ndarray] = []
    prev_order: Optional[np.ndarray] = None
    prev_poses: Optional[np.ndarray] = None
    for poses in frames:
        n = len(poses)
        if n == 0:
            orderings.append(np.array([], dtype=np.int64))
            prev_order, prev_poses = None, None
            continue
        if prev_poses is None or len(prev_poses) == 0:
            order = np.arange(n)
        else:
            prev = prev_poses[prev_order]
            cost = np.mean(
                np.sqrt(
                    np.sum(
                        (prev[:, None, :, :] - poses[None, :, :, :]) ** 2, axis=-1
                    )
                ),
                axis=-1,
            )  # (n_prev, n_cur)
            ri, ci = linear_sum_assignment(cost)
            matched = set(ci.tolist())
            order = list(ci)
            for j in range(n):
                if j not in matched:
                    order.append(j)  # new track
            order = np.array(order, dtype=np.int64)
        orderings.append(order)
        prev_order, prev_poses = np.arange(len(order)), poses[order]
    return orderings
