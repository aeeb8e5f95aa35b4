"""The timeline arithmetic (rates, percentiles) and the profiler arithmetic
(busy time, idle gaps by host activity, the marked device-only window) on
made-up timelines, mfu over the measured window, the reference's own
precision, and the FLOP counter against ``torch.utils.flop_counter`` on
the reference."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.core import flops, peaks, scene, spec, timeline, trace
from portbench.reference.config import ref_config
from portbench.reference.model import Reference, param_spec
from portbench.tests import tiny


def steady(n, dt=0.1, items=4, stall_at=None, stall=0.0):
    calls, t = [], 0.0
    for i in range(n):
        d = dt + (stall if i == stall_at else 0.0)
        calls.append((t, t + d, items))
        t += d
    return calls


def test_rate_and_percentile_on_a_steady_window():
    calls = steady(100)
    assert timeline.rate(calls) == pytest.approx(40.0)
    assert timeline.percentile(timeline.latencies_ms(calls), 95) == pytest.approx(100.0)
    values = list(np.random.default_rng(0).normal(size=101))
    assert timeline.percentile(values, 95) == pytest.approx(float(np.percentile(values, 95)))


def test_a_stall_inside_the_window_moves_fps_and_p95():
    base = steady(100)
    stalled = steady(100, stall_at=50, stall=2.0)
    assert timeline.rate(stalled) < 0.85 * timeline.rate(base)
    many = steady(100)
    for i in range(0, 100, 10):  # ten slow calls of a hundred: over the 95th percentile
        many[i] = (many[i][0], many[i][1] + 0.2, many[i][2])
    assert timeline.percentile(timeline.latencies_ms(many), 95) > 250


def test_busy_union_gaps_and_host_labels():
    device = [(10, 20, "k1"), (15, 30, "k2"), (50, 60, "sample_view_kernel"), (55, 58, "Memcpy HtoD")]
    host = [(0, 100, trace.WINDOW_SPAN), (0, 100, "portbench.call"), (30, 50, "aten::item"),
            (32, 48, "cudaStreamSynchronize"), (60, 100, "aten::cat")]
    s = trace.summarize(device, host, (0, 100))
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["kernels"] == 3
    assert s["sampler_s"] == pytest.approx(10e-6)
    idle = dict(s["idle_gaps"])
    assert idle["portbench.call"] == pytest.approx(10e-6)  # [0, 10)
    assert idle["cudaStreamSynchronize"] == pytest.approx(20e-6)  # [30, 50)
    assert idle["aten::cat"] == pytest.approx(40e-6)  # [60, 100)
    assert 1 - s["busy_s"] / s["window_s"] == pytest.approx(0.7)


def test_a_device_only_trace_is_windowed_by_its_marks():
    device = [(0, 1, "fill"), (10, 20, "k1"), (30, 40, "sample_view_kernel"), (35, 38, "Memset"),
              (99, 100, "fill")]
    s = trace.marked(device)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(20e-6)  # the marks are no operation
    assert s["kernels"] == 2 and s["sampler_s"] == pytest.approx(10e-6)


def test_mfu_is_read_from_the_measured_window_not_the_trace():
    mfu = spec.metric("mfu.infer")
    calls = steady(100)  # 10 s
    run = {"calls": calls, "flops_per_call": 1e12, "trace": {"window_s": 1e-3, "calls": 4}}
    assert mfu.read(run) == pytest.approx(100.0 * 100e12 / (10.0 * peaks.BF16_FLOPS))
    assert mfu.read({"calls": calls, "flops_per_call": 1e12}) is None  # untraced runs report none


def test_the_reference_switches_tf32_off():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        Reference(ref_config(tiny.yaml("selfpose3d_cam5")), {})
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    counts = fc.get_flop_counts()["Global"]
    return sum(v for k, v in counts.items() if "convolution" in str(k))


@pytest.mark.parametrize("config", ["selfpose3d_cam5", "voxelpose_prn32_cam5"])
def test_flop_counter_equals_flop_counter_mode_on_inference(config):
    cfg = ref_config(tiny.yaml(config))
    P = scene.seeded_weights(param_spec(cfg), 3, "cpu")
    ref = Reference(cfg, P)
    B = 2
    W, H = cfg.image_wh
    views = torch.rand(B, cfg.views, H, W, 3)
    b = scene.scene(cfg, B, 2, 3, 0)
    b["views"] = views

    def run():
        with torch.no_grad():
            hm = ref.heatmaps(views)
            ref.root_cubes(hm, b["cam"], b["trans"], b["orig_wh"])
            centres = torch.zeros(B, cfg.max_people, 3)
            ref.pose_scores(hm, b["cam"], b["trans"], b["orig_wh"], centres,
                            torch.ones(B, cfg.max_people))

    assert _counted(run) == flops.infer_flops(cfg, B)


def test_flop_counter_equals_flop_counter_mode_on_a_train_step():
    cfg = ref_config(tiny.yaml("selfpose3d_cam5", MULTI_PERSON={"THRESHOLD": -100.0}))
    P = scene.seeded_weights(param_spec(cfg), 4, "cpu")
    for k, v in P.items():
        if v.is_floating_point() and not k.startswith("root_net.") and "running_" not in k:
            v.requires_grad_(True)
    W, H = cfg.image_wh
    branches = []
    for rot in (15.0, -10.0, 0.0):
        b = scene.scene(cfg, 1, 2, 4, 0, rot_deg=rot)
        b["views"] = torch.rand(1, cfg.views, H, W, 3)
        branches.append(b)

    def run():
        losses = Reference(cfg, P).ssv_losses(*branches)
        sum(losses.values()).backward()

    # the Gaussian rendering's products are no convolution: only convolutions are counted
    assert _counted(run) == flops.ssv_train_flops(cfg, 1)


def test_full_size_counts_match_the_layer_arithmetic():
    """ResNet-50 at 960x512 with its deconv head, V2V on a 64^3 cube (the
    cells' sizes): the counts the benchmark divides by."""
    bb, first = flops.resnet_flops(50, 512, 960, 15)
    assert first == 2 * 3 * 64 * 49 * 256 * 480
    assert 100e9 < bb < 115e9
    v2v, _ = flops.v2v_flops(15, 15, 64, 64, 64)
    assert 150e9 < v2v < 165e9
