"""Fixed-size Hungarian assignment for the SSV L1 loss
(ref: lib/models/multi_person_posenet_ssv.py:25,182).

Problem sizes are tiny (<= MAX_PEOPLE_NUM x MAX_PEOPLE_NUM = 10 x 10), so
the assignment is solved on the host, as the reference does with scipy:
all cost matrices of a call cross to the host in one copy and the classic
O(n^3) shortest-augmenting-path algorithm runs on each in numpy, with the
update order of ``selfpose3d_tpu.ops.matching.hungarian`` so that ties
break the same way. Gradients flow through the picked costs only.

Rectangular / masked problems are padded to a square with a value just
above the largest real cost: the square optimum then assigns exactly
min(rows, cols) real pairs with minimal total real cost, matching scipy's
rectangular behaviour.
"""

from __future__ import annotations

import numpy as np
import torch

from selfpose3d_tpu_torch.utils import spans

INF = np.float32(1e12)


def hungarian_np(cost: np.ndarray) -> np.ndarray:
    """Square assignment minimising total cost: (K, K) float32 -> (K,)
    int64 row2col, the column assigned to each row."""
    K = cost.shape[0]
    cost = cost.astype(np.float32)
    u = np.zeros(K + 1, np.float32)
    v = np.zeros(K + 1, np.float32)
    # col2row[j]: row assigned to column j, -1 if free; slot K is the
    # virtual column holding the row being inserted
    col2row = -np.ones(K + 1, np.int64)
    for i in range(K):
        col2row[K] = i
        minv = np.full(K + 1, INF, np.float32)
        used = np.zeros(K + 1, bool)
        way = np.full(K + 1, K, np.int64)
        j0 = K
        while True:
            used[j0] = True
            i0 = col2row[j0]
            cand = np.append(cost[i0] - u[i0] - v[:K], INF).astype(np.float32)
            better = (cand < minv) & ~used
            minv = np.where(better, cand, minv)
            way = np.where(better, j0, way)
            masked = np.where(used, INF, minv)
            j1 = int(np.argmin(masked))
            delta = masked[j1]
            # used columns' rows += delta, used cols -= delta, unused
            # columns' tentative costs shrink by delta
            np.add.at(u, col2row[used], delta)
            v = v - np.where(used, delta, np.float32(0.0))
            minv = np.where(used, minv, minv - delta)
            j0 = j1
            if col2row[j0] < 0:
                break
        while j0 != K:  # backtrack the augmenting path
            j1 = way[j0]
            col2row[j0] = col2row[j1]
            j0 = j1
        col2row[K] = -1
    row2col = np.zeros(K, np.int64)
    row2col[col2row[:K]] = np.arange(K)
    return row2col


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """Solve square assignment problems, minimising total cost.

    Args:
      cost: (..., K, K) float matrices (one host copy for all of them).
    Returns:
      (..., K) int64 row2col on ``cost``'s device.
    """
    K = cost.shape[-1]
    spans.count("host_syncs.hungarian", 2)  # the costs to the host, the assignment back
    flat = cost.detach().reshape(-1, K, K).to("cpu", torch.float32).numpy()
    out = np.stack([hungarian_np(c) for c in flat]) if len(flat) else np.zeros((0, K), np.int64)
    return torch.from_numpy(out).to(cost.device).reshape(cost.shape[:-1])


@spans.span("sp3d.matching")
def masked_assignment_cost(
    cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor
) -> torch.Tensor:
    """Minimal assignment cost over valid rows x valid cols, batched.

    Invalid entries are padded with (max real cost + 1) so exactly
    min(#rows, #cols) real pairs are matched; returns the sum of the matched
    real pairs' costs (ref: multi_person_posenet_ssv.py:182-183).

    Args:
      cost: (..., M, M); row_valid, col_valid: (..., M) bool.
    Returns:
      (...,) totals, differentiable in the picked costs.
    """
    real = row_valid[..., :, None] & col_valid[..., None, :]
    # pad just above the real max so the solver's duals stay in the
    # real-cost scale: a huge constant destroys float32 precision there
    zero = cost.new_zeros(())
    pad_val = torch.where(real, cost, zero).flatten(-2).amax(-1).detach() + 1.0
    padded = torch.where(real, cost, pad_val[..., None, None])
    row2col = hungarian(padded)
    picked = torch.gather(padded, -1, row2col[..., None])[..., 0]
    picked_real = torch.gather(real.to(cost.dtype), -1, row2col[..., None])[..., 0]
    return (picked * picked_real).sum(-1)
