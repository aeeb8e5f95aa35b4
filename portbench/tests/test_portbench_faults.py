"""A run of the harness (without its look for a card) with the timed path
broken underneath comes out not correct, once for each fault a cell can
have, and so does the control (the reference in float8 in the program's
place). One chip, so no exchange between chips can be left out; the train
cell's batch is one sample, so no half of it can be. The train cell's
backward is broken too: the sampling's adjoint negated or zeroed."""

from __future__ import annotations

import time

import pytest
import torch

from portbench.core import runner, spec
from portbench.tests import tiny

INFER = ("selfpose3d_cam5.offline_b32", "selfpose3d_cam5")
TRAIN = "selfpose3d_cam5.train_ssv_b1"
THRESHOLD = {"MULTI_PERSON": {"THRESHOLD": -100.0}}


def infer_run(program=None, seed=11):
    workload, config = INFER
    cell = tiny.cell(workload)
    ctx = runner.make_ctx(workload, seed, "cpu", cell, tiny.traffic(cell["traffic"]),
                          tiny.yaml(config))
    return runner.run(ctx, 0.3, False, time.perf_counter(), program=program)


def train_run(program=None, seed=12):
    cell = tiny.cell(TRAIN)
    # the compared window step is the window's first: a short window reaches it
    ctx = runner.make_ctx(TRAIN, seed, "cpu", cell, tiny.traffic("train_ssv_b1", trace_calls=1),
                          tiny.yaml("selfpose3d_cam5", **THRESHOLD))
    return runner.run(ctx, 0.1, False, time.perf_counter(), program=program)


def test_half_of_the_batch_left_out(monkeypatch):
    import selfpose3d_tpu_torch.models.multi_person as mp

    real = mp.backbone_heatmaps

    def half(backbone, branch, fold):
        hm = real(backbone, branch, fold)
        h = max(1, hm.shape[0] // 2)  # the first half's heatmaps stand for the rest
        return torch.cat([hm[:h]] * 2)[: hm.shape[0]]

    monkeypatch.setattr(mp, "backbone_heatmaps", half)
    out = infer_run()
    assert not out["correct"], out["numbers"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    import selfpose3d_tpu_torch.models.multi_person as mp

    real = mp.MultiPersonPoseNetSSV.do_inference

    def moved(self, branch, visualize_attn=False):
        pred, hm, gc = real(self, branch)
        b, k = (int(i) for i in torch.nonzero(gc[..., 3] >= 0)[0])
        pred[b, k, 0, 0] += 400.0  # one joint of one valid candidate, 3 voxels of 133 mm off
        return pred, hm, gc

    monkeypatch.setattr(mp.MultiPersonPoseNetSSV, "do_inference", moved)
    out = infer_run()
    assert not out["correct"], out["numbers"]
    assert out["numbers"]["pose_rel"] > 0.5


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from selfpose3d_tpu_torch.train.train_state import TrainState

    def unchanged(self):
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    monkeypatch.setattr(TrainState, "apply_gradients", unchanged)
    out = train_run()
    assert not out["correct"], out["numbers"]
    assert out["numbers"]["update_gap"] == pytest.approx(1.0)


def test_the_control_comes_out_not_correct():
    entry = spec.entry("infer")

    class Control(entry.Program):
        def call(self, i):
            return self.control(i % len(self.pool))

    out = infer_run(Control)
    assert not out["correct"], out["numbers"]


def test_the_train_control_comes_out_not_correct():
    entry = spec.entry("ssv_train")

    class Control(entry.Program):
        def __init__(self, ctx):
            super().__init__(ctx)
            self.record = self.reference_run(fp8=True)  # its own proposals, in "centres"

    out = train_run(Control)
    assert not out["correct"], out["numbers"]


@pytest.mark.parametrize("scale", [-1.0, 0.0], ids=["negated", "zeroed"])
def test_the_samplings_adjoint_broken(monkeypatch, scale):
    from selfpose3d_tpu_torch.ops import slicewarp

    real = slicewarp.sample_view_adjoint
    monkeypatch.setattr(slicewarp, "sample_view_adjoint", lambda *a, **k: real(*a, **k) * scale)
    out = train_run()
    assert not out["correct"], out["numbers"]
    assert out["numbers"]["adjoint_cos_gap"] > 0.5


def test_a_window_that_never_reaches_its_compared_step():
    entry = spec.entry("ssv_train")

    class Late(entry.Program):
        def __init__(self, ctx):
            super().__init__(ctx)
            self.window_at = 1 << 20

    out = train_run(Late)
    assert not out["correct"], out["numbers"]
