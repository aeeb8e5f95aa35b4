"""Evaluation metric protocols (host-side numpy; the port's own copy of
``selfpose3d_tpu/eval/metrics.py``).

Panoptic: greedy score-sorted AP/recall at mpjpe thresholds {25..150}mm,
MPJPE@500 and recall@500, computed for both full poses and roots
(ref: lib/dataset/panoptic.py:293-437).

Shelf/Campus: per-actor PCP@alpha=0.5 over limb bone groups + recall@500
(ref: lib/dataset/shelf.py:172-240, campus.py:170-235).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ----------------------------------------------------------- Panoptic AP
def build_eval_list(
    preds: Sequence[np.ndarray],
    gt_poses: Sequence[Sequence[np.ndarray]],
    gt_vis: Sequence[Sequence[np.ndarray]],
) -> Tuple[List[dict], int]:
    """Per-prediction nearest-GT mpjpe entries (ref: panoptic.py:299-345).

    Args:
      preds: per frame, (N_i, J, 5) predictions [x,y,z,flag,score]; rows with
             flag < 0 are dropped.
      gt_poses: per frame, list of (J, 3) gt poses.
      gt_vis:  per frame, list of (J, 3) visibility arrays (vis[:,0] > 0).
    Returns:
      (eval_list of {mpjpe, score, gt_id}, total_gt)
    """
    eval_list: List[dict] = []
    total_gt = 0
    for pred, joints_3d, joints_vis in zip(preds, gt_poses, gt_vis):
        if len(joints_3d) == 0:
            continue
        pred = np.asarray(pred)
        pred = pred[pred[:, 0, 3] >= 0]
        for pose in pred:
            mpjpes = []
            for gt, gtv in zip(joints_3d, joints_vis):
                vis = np.asarray(gtv)[:, 0] > 0
                mpjpe = np.mean(
                    np.sqrt(np.sum((pose[vis, 0:3] - np.asarray(gt)[vis]) ** 2, axis=-1))
                )
                mpjpes.append(mpjpe)
            min_gt = int(np.argmin(mpjpes))
            eval_list.append(
                {
                    "mpjpe": float(np.min(mpjpes)),
                    "score": float(pose[0, 4]),
                    "gt_id": int(total_gt + min_gt),
                }
            )
        total_gt += len(joints_3d)
    return eval_list, total_gt


def build_root_eval_list(
    roots: Sequence[np.ndarray],
    gt_roots: Sequence[Sequence[np.ndarray]],
    gt_root_vis: Sequence[Sequence[float]],
) -> Tuple[List[dict], int]:
    """Root entries (ref: panoptic.py:334-360). gt ids share pose numbering."""
    eval_list: List[dict] = []
    total_gt = 0
    for root, gts, gtvs in zip(roots, gt_roots, gt_root_vis):
        if len(gts) == 0:
            continue
        root = np.asarray(root)
        root = root[root[:, 3] >= 0]
        for rt in root:
            mpjpes = []
            for gt, vis in zip(gts, gtvs):
                if vis > 0:
                    mpjpes.append(
                        float(np.mean(np.sqrt(np.sum((rt[0:3] - np.asarray(gt)) ** 2, axis=-1))))
                    )
            if mpjpes:
                min_gt = int(np.argmin(mpjpes))
                eval_list.append(
                    {
                        "mpjpe": float(np.min(mpjpes)),
                        "score": float(rt[4]),
                        "gt_id": int(total_gt + min_gt),
                    }
                )
        total_gt += len(gts)
    return eval_list, total_gt


def eval_list_to_ap(eval_list: List[dict], total_gt: int, threshold: float) -> Tuple[float, float]:
    """Greedy AP (ref: panoptic.py:392-418)."""
    eval_list = sorted(eval_list, key=lambda k: k["score"], reverse=True)
    total_num = len(eval_list)
    if total_num == 0:
        return 0.0, 0.0
    tp = np.zeros(total_num)
    fp = np.zeros(total_num)
    gt_det = set()
    for i, item in enumerate(eval_list):
        if item["mpjpe"] < threshold and item["gt_id"] not in gt_det:
            tp[i] = 1
            gt_det.add(item["gt_id"])
        else:
            fp[i] = 1
    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    recall = tp / (total_gt + 1e-5)
    precise = tp / (tp + fp + 1e-5)
    for n in range(total_num - 2, -1, -1):
        precise[n] = max(precise[n], precise[n + 1])
    precise = np.concatenate(([0], precise, [0]))
    recall = np.concatenate(([0], recall, [1]))
    index = np.where(recall[1:] != recall[:-1])[0]
    ap = float(np.sum((recall[index + 1] - recall[index]) * precise[index + 1]))
    return ap, float(recall[-2])


def eval_list_to_mpjpe(eval_list: List[dict], threshold: float = 500.0) -> float:
    """Matched MPJPE (ref: panoptic.py:420-431)."""
    eval_list = sorted(eval_list, key=lambda k: k["score"], reverse=True)
    gt_det = set()
    mpjpes = []
    for item in eval_list:
        if item["mpjpe"] < threshold and item["gt_id"] not in gt_det:
            mpjpes.append(item["mpjpe"])
            gt_det.add(item["gt_id"])
    return float(np.mean(mpjpes)) if mpjpes else float("inf")


def eval_list_to_recall(eval_list: List[dict], total_gt: int, threshold: float = 500.0) -> float:
    """(ref: panoptic.py:433-437)."""
    gt_ids = [e["gt_id"] for e in eval_list if e["mpjpe"] < threshold]
    return len(np.unique(gt_ids)) / max(total_gt, 1)


def panoptic_metrics(
    preds, gt_poses, gt_vis, roots=None, gt_roots=None, gt_root_vis=None,
    thresholds: Sequence[float] = (25, 50, 75, 100, 125, 150),
) -> Dict[str, object]:
    """Full Panoptic report for poses (and roots when provided)."""
    eval_list, total_gt = build_eval_list(preds, gt_poses, gt_vis)
    out: Dict[str, object] = {
        "aps": [eval_list_to_ap(eval_list, total_gt, t)[0] for t in thresholds],
        "recalls": [eval_list_to_ap(eval_list, total_gt, t)[1] for t in thresholds],
        "mpjpe": eval_list_to_mpjpe(eval_list),
        "recall500": eval_list_to_recall(eval_list, total_gt),
        "thresholds": list(thresholds),
    }
    if roots is not None:
        rl, rt = build_root_eval_list(roots, gt_roots, gt_root_vis)
        out["aps_root"] = [eval_list_to_ap(rl, rt, t)[0] for t in thresholds]
        out["recalls_root"] = [eval_list_to_ap(rl, rt, t)[1] for t in thresholds]
        out["mpjpe_root"] = eval_list_to_mpjpe(rl)
        out["recall500_root"] = eval_list_to_recall(rl, rt)
    return out


# ------------------------------------------------------------- PCP (shelf)
# limb bone list into the 14-joint shelf/campus skeleton
# (ref: lib/dataset/shelf.py:180)
SHELF_PCP_LIMBS = [
    (0, 1), (1, 2), (3, 4), (4, 5),      # legs
    (6, 7), (7, 8), (9, 10), (10, 11),   # arms
    (12, 13),                            # head
]
PCP_BONE_GROUPS = {
    # group -> limb indices into the 10-wide correct-parts table
    # (ref: shelf.py:232-236; index 9 is the virtual torso bone)
    "Head": [8],
    "Torso": [9],
    "Upper arms": [5, 6],
    "Lower arms": [4, 7],
    "Upper legs": [1, 2],
    "Lower legs": [0, 3],
}


def pcp_evaluate(
    preds: Sequence[np.ndarray],
    actor_3d: Sequence[Sequence[Optional[np.ndarray]]],
    alpha: float = 0.5,
    recall_threshold: float = 500.0,
) -> Dict[str, object]:
    """Per-actor PCP protocol for Shelf/Campus (ref: shelf.py:172-240).

    Args:
      preds:    per frame, (N, 14, 3) shelf-order predictions (already
                converted and flag-filtered).
      actor_3d: actor_3d[person][frame] -> (14, 3) gt in mm or empty.
    Returns:
      dict with actor_pcp, avg_pcp (mean over first 3 actors), bone-group
      table, and recall@500.
    """
    num_person = len(actor_3d)
    total_gt = 0
    match_gt = 0
    correct_parts = np.zeros(num_person)
    total_parts = np.zeros(num_person)
    bone_correct_parts = np.zeros((num_person, 10))

    for fi, pred in enumerate(preds):
        pred = np.asarray(pred)
        if pred.size == 0:
            continue
        for person in range(num_person):
            gt = actor_3d[person][fi]
            if gt is None or len(np.asarray(gt)) == 0 or len(np.asarray(gt)[0]) == 0:
                continue
            gt = np.asarray(gt)
            mpjpes = np.mean(
                np.sqrt(np.sum((gt[np.newaxis] - pred) ** 2, axis=-1)), axis=-1
            )
            min_n = int(np.argmin(mpjpes))
            if float(np.min(mpjpes)) < recall_threshold:
                match_gt += 1
            total_gt += 1

            for j, (a, b) in enumerate(SHELF_PCP_LIMBS):
                total_parts[person] += 1
                e_s = np.linalg.norm(pred[min_n, a, :3] - gt[a])
                e_e = np.linalg.norm(pred[min_n, b, :3] - gt[b])
                bone = np.linalg.norm(gt[a] - gt[b])
                if (e_s + e_e) / 2.0 <= alpha * bone:
                    correct_parts[person] += 1
                    bone_correct_parts[person, j] += 1
            pred_hip = (pred[min_n, 2, :3] + pred[min_n, 3, :3]) / 2.0
            gt_hip = (gt[2] + gt[3]) / 2.0
            total_parts[person] += 1
            e_s = np.linalg.norm(pred_hip - gt_hip)
            e_e = np.linalg.norm(pred[min_n, 12, :3] - gt[12])
            bone = np.linalg.norm(gt_hip - gt[12])
            if (e_s + e_e) / 2.0 <= alpha * bone:
                correct_parts[person] += 1
                bone_correct_parts[person, 9] += 1

    actor_pcp = correct_parts / (total_parts + 1e-8)
    bone_person_pcp = {
        k: (
            np.sum(bone_correct_parts[:, v], axis=-1)
            / (total_parts / 10 * len(v) + 1e-8)
        )
        for k, v in PCP_BONE_GROUPS.items()
    }
    return {
        "actor_pcp": actor_pcp,
        "avg_pcp": float(np.mean(actor_pcp[:3])) if num_person >= 3 else float(np.mean(actor_pcp)),
        "bone_person_pcp": bone_person_pcp,
        "recall500": match_gt / (total_gt + 1e-8),
    }


def pcp_shelf(
    preds_matched: Sequence[Optional[np.ndarray]],
    gts: Sequence[np.ndarray],
    alpha: float = 0.5,
) -> Dict[str, float]:
    """Simple matched-pair PCP helper (testing convenience)."""
    correct = np.zeros(len(SHELF_PCP_LIMBS) + 1)
    total = np.zeros(len(SHELF_PCP_LIMBS) + 1)
    for pred, gt in zip(preds_matched, gts):
        if gt is None or len(gt) == 0:
            continue
        total += 1
        if pred is None:
            continue
        for li, (a, b) in enumerate(SHELF_PCP_LIMBS):
            bone = np.linalg.norm(gt[a] - gt[b])
            e = (np.linalg.norm(pred[a] - gt[a]) + np.linalg.norm(pred[b] - gt[b])) / 2.0
            if e <= alpha * bone:
                correct[li] += 1
        gt_hip = (gt[2] + gt[3]) / 2.0
        pred_hip = (pred[2] + pred[3]) / 2.0
        bone = np.linalg.norm(gt_hip - gt[12])
        e = (np.linalg.norm(pred_hip - gt_hip) + np.linalg.norm(pred[12] - gt[12])) / 2.0
        if e <= alpha * bone:
            correct[-1] += 1
    out = {"avg": float(correct.sum() / total.sum()) if total.sum() > 0 else 0.0}
    return out
