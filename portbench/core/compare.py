"""The numbers that decide ``correct``: what the timed path produced against
the plain reference (``portbench/reference``), each beside its limit.

Inference (per compared batch; the worst batch counts):
  heatmap_rel   ||hm - hm_ref|| / ||hm_ref|| over the batch's heatmaps.
  root_gap      RootNet's proposals against the reference's own volume,
                over the top score: the gap between the two sorted score
                lists, the gap between each proposal's score and the
                reference's value at its voxel, and how far that voxel lies
                below its 3^3 neighbourhood's maximum (a proposal must be a
                local maximum). Infinite where a proposal is off the voxel
                grid, its flag disagrees with its score, or pred's flag and
                score columns differ from the proposals'.
  pose_rel      PoseNet's joints against the reference's at the program's
                proposals (the reference follows the proposals, which
                root_gap checks by themselves): per candidate, its largest
                joint distance over the larger of its reference joints' rms
                distance from the proposal (the part of the pose PoseNet
                adds) and the batch's median of that (an invalid candidate's
                pose must be zero); the worst frame set's mean over its
                candidates.
Training (the first STEPS steps, from the same weights and rows; the
reference follows each step's proposals of the program):
  loss_gap      the worst term of the worst step: |loss - loss_ref| / |loss_ref|.
  grad_gap      the worst leaf's | ||g1|| - ||g1_ref|| | over the larger of
                ||g1_ref|| and the median leaf's, g1 the first step's
                gradient as Adam's first moment holds it;
                grad_gap_median the median leaf's.
  update_gap    the worst leaf's gap of its change over the STEPS steps.
  root_gap      the first step's proposals, as for inference.
  bn_gap        the worst running statistic's ||d - d_ref|| over the larger of
                ||d_ref|| and the median statistic's, d its change in the
                first step.
The window's compared step (one step of the window drawn from the seed; the
reference recomputes it from the program's state before it, on the same
rows, following that step's proposals), by direction, which Adam's update
hides and a gradient's norm does not show:
  grad_cos_gap     1 - cos(g, g_ref) of the step's gradient over each trained
                   sub-network's leaves (backbone, attention net, PoseNet),
                   the worst sub-network; g as the program's Adam took it.
  adjoint_cos_gap  1 - cos(g - g2d_ref, g_ref - g2d_ref) over the backbone's
                   leaves, g2d_ref the reference's gradient of loss_2d alone:
                   the part of the backbone's gradient that reaches it
                   through the sampling's adjoint (sample_view_adjoint).
Leaves whose reference gradient is under LEAF_FLOOR of the median leaf's are
left out of grad_gap, update_gap and the window's numbers (Adam moves them
by round-off alone).
A cell's ``limits`` name the numbers it compares; the others are readings
(the train cell's loss and gradient gaps: ill-conditioned at random
weights, see PERF.md).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.model import voxel_world

LEAF_FLOOR = 1e-3
STEPS = 3
GROUPS = ("backbone.", "attn.", "pose_net.")
WINDOW_NUMBERS = ("grad_cos_gap", "adjoint_cos_gap")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a.float() - b.float()).flatten())
                 / torch.linalg.vector_norm(b.float().flatten()).clamp(min=1e-30))


def root_gap(cfg, gc: torch.Tensor, pred, rc_ref: torch.Tensor, top_ref: torch.Tensor) -> float:
    """gc (B, K, 5) and pred (B, K, J, 5), or None, of the program; the
    reference's volume (B, X, Y, Z) and its sorted top-K scores (B, K)."""
    B, K = gc.shape[:2]
    if pred is not None and not torch.equal(pred[..., 3:], gc[:, :, None, 3:].expand_as(pred[..., 3:])):
        return math.inf
    score, flag, loc = gc[..., 4], gc[..., 3], gc[..., :3]
    if not torch.equal(flag, (score > cfg.threshold).float() - 1.0):
        return math.inf
    n = torch.tensor(cfg.root_cube, dtype=torch.float32, device=gc.device)
    size = torch.tensor(cfg.space_size, device=gc.device)
    centre = torch.tensor(cfg.space_center, device=gc.device)
    idx = torch.round((loc - centre + size / 2) / size * (n - 1))
    if bool((idx < 0).any() or (idx > n - 1).any()):
        return math.inf
    if float((voxel_world(idx, cfg.space_size, cfg.space_center, cfg.root_cube) - loc).abs().max()) > 0.5:
        return math.inf
    idx = idx.long()
    b = torch.arange(B, device=gc.device)[:, None].expand(B, K)
    at = rc_ref[b, idx[..., 0], idx[..., 1], idx[..., 2]]
    pooled = F.max_pool3d(rc_ref[:, None], 3, 1, 1)[:, 0][b, idx[..., 0], idx[..., 1], idx[..., 2]]
    gaps = torch.stack([
        (score.sort(dim=-1, descending=True).values - top_ref).abs().amax(),
        (at - score).abs().amax(),
        (pooled - at).amax(),
    ])
    return float(gaps.max() / top_ref.abs().amax().clamp(min=1e-12))


def pose_rel(ref, pred: torch.Tensor, scores: torch.Tensor, centres: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Per candidate (B*K,): the largest joint distance between the program's
    pred (B, K, J, 5) and the reference's soft-argmax of its scores
    (B*K, J, X, Y, Z) at the program's centres (B, K, 3), over the rms
    distance of the reference's joints from the centre (the part of a pose
    that PoseNet adds to its proposal; at least 1 mm). An invalid candidate
    (valid (B, K) 0) reads its largest joint distance from the origin over
    1 mm (its pose is zero). ``infer_numbers`` divides by the larger of the
    candidate's spread and the batch's median one."""
    B, K, J = pred.shape[:3]
    p = pred[..., :3].reshape(B * K, J, 3)
    q = ref.soft_argmax(scores, centres)
    c = centres.reshape(B * K, 1, 3)
    spread = (q - c).norm(dim=-1).pow(2).mean(-1).sqrt().clamp(min=1.0)
    v = valid.reshape(B * K) > 0
    err = torch.where(v, (p - q).norm(dim=-1).amax(-1), p.norm(dim=-1).amax(-1))
    return torch.stack([err, torch.where(v, spread, torch.ones_like(spread)), v.float()])


def infer_numbers(ref, batch: dict, pred: torch.Tensor, hm: torch.Tensor, gc: torch.Tensor) -> Dict[str, float]:
    """The inference numbers of one batch: the program's (pred, hm, gc)
    against the reference on the batch's inputs (on the reference's device)."""
    cfg = ref.cfg
    with torch.no_grad():
        hm_ref = ref.heatmaps(batch["views"])
        out = {"heatmap_rel": rel_l2(hm, hm_ref)}
        rc = ref.root_cubes(hm_ref, batch["cam"], batch["trans"], batch["orig_wh"])
        top, _ = ref.proposals(rc, cfg.max_people)
        out["root_gap"] = root_gap(cfg, gc, pred, rc, top)
        del rc
        valid = (gc[..., 3] >= 0).float()
        gaps = []
        for i in range(gc.shape[0]):
            cam = {k: t[i:i + 1] for k, t in batch["cam"].items()}
            scores = ref.pose_scores(hm_ref[i:i + 1], cam, batch["trans"][i:i + 1],
                                     batch["orig_wh"][i:i + 1], gc[i:i + 1, :, :3], valid[i:i + 1])
            gaps.append(pose_rel(ref, pred[i:i + 1], scores, gc[i:i + 1, :, :3], valid[i:i + 1]))
            del scores
        err, spread, v = torch.cat(gaps, dim=1)
        floor = spread[v > 0].median() if bool((v > 0).any()) else spread.new_ones(())
        per_frame = (err / torch.maximum(spread, floor * v)).reshape(gc.shape[0], -1).mean(-1)
        out["pose_rel"] = float(per_frame.max())
    return out


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float().flatten()))


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def train_numbers(run: dict, ref_run: dict) -> Dict[str, float]:
    """``run`` and ``ref_run``: {"losses": [STEPS dicts term -> float],
    "grad1": name -> tensor, "delta": name -> tensor (the trained leaves'
    change over the STEPS steps), "stats": name -> tensor (each running
    statistic's change in the first step)}."""
    out = {}
    gaps = []
    for mine, theirs in zip(run["losses"], ref_run["losses"]):
        if set(mine) != set(theirs):
            return dict.fromkeys(("loss_gap", "grad_gap", "grad_gap_median", "update_gap",
                                  "root_gap", "bn_gap"), math.inf)
        gaps.append(max(abs(mine[k] - theirs[k]) / max(abs(theirs[k]), 1e-12) for k in theirs))
    out["loss_gap"] = max(gaps)
    gnorm = {k: _norm(g) for k, g in ref_run["grad1"].items()}
    med = _median(list(gnorm.values()))
    leaves = [k for k, n in gnorm.items() if n >= LEAF_FLOOR * med]
    for key, field in (("grad_gap", "grad1"), ("update_gap", "delta")):
        ref_n = {k: _norm(ref_run[field][k]) for k in leaves}
        scale = _median(list(ref_n.values()))
        mine = {k: _norm(run[field][k]) if k in run[field] else 0.0 for k in leaves}  # absent: unmoved
        leaf_gaps = [abs(mine[k] - ref_n[k]) / max(ref_n[k], scale) for k in leaves]
        out[key] = max(leaf_gaps)
        if key == "grad_gap":
            out["grad_gap_median"] = _median(leaf_gaps)
    out["root_gap"] = ref_run["root_gap"]
    ref_s = {k: _norm(t) for k, t in ref_run["stats"].items()}
    scale = _median(list(ref_s.values()))
    out["bn_gap"] = max(_norm(run["stats"][k] - t) / max(ref_s[k], scale)
                        for k, t in ref_run["stats"].items())
    return out


def _cos(a: List[torch.Tensor], b: List[torch.Tensor]) -> float:
    """The cosine of the two lists' concatenations, summed in float64 (a
    float32 sum over millions of entries reads above 1)."""
    x = torch.cat([t.double().flatten() for t in a])
    y = torch.cat([t.double().flatten() for t in b])
    return float((x @ y) / (x.norm() * y.norm()).clamp(min=1e-30))


def window_numbers(grad: Dict[str, torch.Tensor], ref: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """``grad``: name -> the program's gradient of the window's compared step
    (an absent leaf took none); ``ref``: {"all": name -> the reference's,
    "2d": backbone name -> the reference's of loss_2d alone}."""
    g_ref, g2d = ref["all"], ref["2d"]
    norms = {k: _norm(g) for k, g in g_ref.items()}
    med = _median(list(norms.values()))
    leaves = [k for k in g_ref if norms[k] >= LEAF_FLOOR * med]

    def mine(k):
        return grad[k] if k in grad else torch.zeros_like(g_ref[k])

    gaps = []
    for pre in GROUPS:
        ks = [k for k in leaves if k.startswith(pre)]
        if ks:
            gaps.append(1.0 - _cos([mine(k) for k in ks], [g_ref[k] for k in ks]))
    bb = [k for k in leaves if k in g2d]
    return {"grad_cos_gap": max(gaps),
            "adjoint_cos_gap": 1.0 - _cos([mine(k) - g2d[k] for k in bb], [g_ref[k] - g2d[k] for k in bb])}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit, and every limit's number present."""
    return set(limits) <= set(numbers) and all(
        math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
