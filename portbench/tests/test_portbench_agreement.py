"""The plain reference agrees with the port run on the CPU at a small
float32 size: inference of both models and a train step (its first steps
and a step of its window); and a run of the harness there comes out
correct under the cells' limits."""

from __future__ import annotations

import time

import pytest

from portbench import control
from portbench.core import runner
from portbench.tests import tiny

TRAIN = "selfpose3d_cam5.train_ssv_b1"
THRESHOLD = {"MULTI_PERSON": {"THRESHOLD": -100.0}}


@pytest.mark.parametrize("workload,config", [("selfpose3d_cam5.offline_b32", "selfpose3d_cam5"),
                                             ("voxelpose_prn32_cam5.offline_b32", "voxelpose_prn32_cam5"),
                                             ("selfpose3d_cam5.live_b1", "selfpose3d_cam5")])
def test_inference_run_agrees_with_the_reference(workload, config):
    cell = tiny.cell(workload)
    ctx = runner.make_ctx(workload, 2 ** 31 + 77, "cpu", cell, tiny.traffic(cell["traffic"]),
                          tiny.yaml(config))
    out = runner.run(ctx, 0.5, False, time.perf_counter())
    n = out["numbers"]
    assert n["heatmap_rel"] < 1e-4 and n["root_gap"] < 1e-4 and n["pose_rel"] < 1e-3, n
    assert out["correct"]
    assert out["calls"] and out["setup_s"] > 0


def test_a_train_step_agrees_with_the_reference():
    r = control.readings(TRAIN, 5, "cpu", tiny.traffic("train_ssv_b1"),
                         tiny.yaml("selfpose3d_cam5", **THRESHOLD), tiny.cell(TRAIN))
    n = r["program"]
    assert n["loss_gap"] < 1e-3 and n["root_gap"] < 1e-4, n
    assert n["grad_gap"] < 1e-2 and n["update_gap"] < 0.05 and n["bn_gap"] < 1e-4, n
    assert n["grad_cos_gap"] < 1e-5 and n["adjoint_cos_gap"] < 1e-4, n
