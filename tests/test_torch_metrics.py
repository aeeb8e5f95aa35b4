"""The port's evaluation protocols against the JAX package's, on the CPU:
``eval/metrics.py`` (Panoptic AP / MPJPE / recall for poses and roots,
Shelf/Campus PCP) and ``SyntheticSceneDataset.evaluate``, on seeded
predictions with flag-dropped rows (flag < 0), duplicates of one person
and frames without people. Both are numpy: the reports are equal.
"""

import numpy as np
import pytest

import selfpose3d_tpu.eval.metrics as j_metrics
from selfpose3d_tpu.config import load_config as j_load_config
from selfpose3d_tpu.data.synthetic_dataset import SyntheticSceneDataset as JDataset

import selfpose3d_tpu_torch.eval.metrics as metrics
from selfpose3d_tpu_torch.config import load_config
from selfpose3d_tpu_torch.data.synthetic_dataset import SyntheticSceneDataset

TINY = "configs/synthetic/tiny_ssv.yaml"


def _assert_report_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_report_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _scene(seed, frames=6, K=5, J=15, noise=60.0):
    """GT poses (1 + f % 3 people, frame 4 empty) and predictions: a noisy
    copy of each person (and of person 0 twice: a duplicate), padding rows
    flagged -1, and far-off false positives; root rows alike."""
    rs = np.random.RandomState(seed)
    gt_poses, gt_vis, gt_roots, gt_rv, preds, roots = [], [], [], [], [], []
    for f in range(frames):
        n = 0 if f == 4 else 1 + f % 3
        poses = [rs.uniform(-2000, 2000, 3) + rs.randn(J, 3) * 250 for _ in range(n)]
        vis = [np.ones((J, 3)) for _ in poses]
        if n:
            vis[0][rs.rand(J) < 0.2] = 0  # some invisible joints
        pred = np.zeros((K, J, 5))
        pred[..., 3] = -1
        root = np.zeros((K, 5))
        root[:, 3] = -1
        rows = [0] + list(range(n)) if n else []
        for k, p in enumerate(rows):
            pred[k, :, :3] = poses[p] + rs.randn(J, 3) * noise * (1 + k)
            pred[k, :, 3], pred[k, :, 4] = 0, rs.rand()
            root[k, :3] = poses[p][2] + rs.randn(3) * noise * (1 + k)
            root[k, 3], root[k, 4] = 0, pred[k, 0, 4]
        k = len(rows)
        if k < K:  # a false positive
            pred[k, :, :3] = rs.uniform(-4000, 4000, (J, 3))
            pred[k, :, 3], pred[k, :, 4] = 0, rs.rand()
            root[k, :3], root[k, 3:] = pred[k, 2, :3], [0, pred[k, 0, 4]]
        gt_poses.append(poses)
        gt_vis.append(vis)
        gt_roots.append([p[2] for p in poses])
        gt_rv.append([1.0] * n)
        preds.append(pred)
        roots.append(root)
    return preds, gt_poses, gt_vis, roots, gt_roots, gt_rv


@pytest.mark.parametrize("seed, noise", [(0, 60.0), (1, 20.0), (2, 150.0)])
def test_panoptic_metrics_equal(seed, noise):
    preds, gt_poses, gt_vis, roots, gt_roots, gt_rv = _scene(seed, noise=noise)
    got = metrics.panoptic_metrics(preds, gt_poses, gt_vis, roots, gt_roots, gt_rv)
    want = j_metrics.panoptic_metrics(preds, gt_poses, gt_vis, roots, gt_roots, gt_rv)
    _assert_report_equal(got, want)
    assert 0 < got["recall500"] <= 1 and np.isfinite(got["mpjpe"])
    el, total = metrics.build_eval_list(preds, gt_poses, gt_vis)
    assert (el, total) == j_metrics.build_eval_list(preds, gt_poses, gt_vis)
    assert len(el) == sum(int((p[:, 0, 3] >= 0).sum()) for p, g in zip(preds, gt_poses) if g)
    rl = metrics.build_root_eval_list(roots, gt_roots, gt_rv)
    assert rl == j_metrics.build_root_eval_list(roots, gt_roots, gt_rv)
    for t in (25, 100, 500):
        assert metrics.eval_list_to_ap(el, total, t) == j_metrics.eval_list_to_ap(el, total, t)
        assert metrics.eval_list_to_recall(el, total, t) == \
            j_metrics.eval_list_to_recall(el, total, t)
        assert metrics.eval_list_to_mpjpe(el, t) == j_metrics.eval_list_to_mpjpe(el, t)
    assert metrics.eval_list_to_ap([], 3, 50.0) == (0.0, 0.0)
    assert metrics.eval_list_to_mpjpe([]) == float("inf")


def test_pcp_equal():
    rs = np.random.RandomState(7)
    actors, frames = 4, 5
    gt = rs.randn(14, 3) * 300
    actor_3d = [[gt + rs.randn(14, 3) * 100 if (a + f) % 4 else np.zeros((0,))
                 for f in range(frames)] for a in range(actors)]
    preds = [np.stack([g + rs.randn(14, 3) * 80 for g in (actor_3d[a][f] for a in range(actors))
                       if len(g)]) for f in range(frames)]
    preds[2] = np.zeros((0, 14, 3))  # a frame without predictions
    _assert_report_equal(metrics.pcp_evaluate(preds, actor_3d),
                         j_metrics.pcp_evaluate(preds, actor_3d))
    pairs = [p[0] if len(p) else None for p in preds]
    gts = [actor_3d[1][f] if len(actor_3d[1][f]) else actor_3d[0][f] for f in range(frames)]
    assert metrics.pcp_shelf(pairs, gts) == j_metrics.pcp_shelf(pairs, gts)
    assert metrics.SHELF_PCP_LIMBS == j_metrics.SHELF_PCP_LIMBS
    assert metrics.PCP_BONE_GROUPS == j_metrics.PCP_BONE_GROUPS


@pytest.mark.parametrize("image_set", ["train", "validation"])
def test_synthetic_evaluate_equal(image_set):
    cfg = load_config(TINY)
    port = SyntheticSceneDataset(cfg, image_set, num_frames=9)
    ref = JDataset(j_load_config(TINY), image_set, num_frames=9)
    rs = np.random.RandomState(3)
    K, J = cfg.MULTI_PERSON.MAX_PEOPLE_NUM, cfg.NETWORK.NUM_JOINTS
    preds, roots = [], []
    for i in range(9):
        gt = port._frame_poses(i)
        pred = np.zeros((K, J, 5), np.float32)
        pred[..., 3] = -1
        for k in range(min(K, len(gt) + 1)):
            p = gt[k % len(gt)]  # the last row duplicates person 0
            pred[k, :, :3] = p + rs.randn(J, 3) * 40 * (1 + k)
            pred[k, :, 3:] = [0, rs.rand()]
        preds.append(pred)
        roots.append(np.concatenate([pred[:, 2, :3], pred[:, 0, 3:]], -1))
    got = port.evaluate(preds, roots)
    _assert_report_equal(got, ref.evaluate(preds, roots))
    assert got["recall500"] == 1.0 and got["recall500_root"] == 1.0
    assert 0 < got["mpjpe"] < 200 and got["aps"][-1] > 0.5
