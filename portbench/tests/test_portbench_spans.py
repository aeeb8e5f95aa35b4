"""The per-layer metrics that read the program's own spans and counters
(``core/stages.py``): a small CPU run of each cell they list, traced, reads
a number for each of its metrics; untraced it reads none, and neither does
a program without spans."""

from __future__ import annotations

import sys
import time

import pytest

from portbench.core import runner, spec
from portbench.tests import tiny

BENCH = spec.benchmark()
READERS = ("backbone_ms", "rootnet_ms", "posenet_ms", "attn_ms", "losses_ms", "backward_ms",
           "optimizer_ms", "host_syncs")
OWN = [m for m in BENCH["per_layer"] if m["name"].split(".")[0] in READERS]
CELLS = sorted({w for m in OWN for w in m["workloads"]})


def _run(workload: str, trace: bool):
    from selfpose3d_tpu_torch.utils import spans

    spans.reset()
    cell = tiny.cell(workload)
    ctx = runner.make_ctx(workload, 2 ** 31 + 21, "cpu", cell,
                          tiny.traffic(cell["traffic"], trace_calls=1),
                          tiny.yaml(cell["config"], **cell["overrides"]))
    out = runner.run(ctx, 0.1, trace, time.perf_counter())
    return runner.metric_values(out, [m for m in OWN if workload in m["workloads"]])


def test_the_metrics_and_their_cells():
    assert len(OWN) == 16
    for m in OWN:
        assert m["unit"] == ("syncs/call" if m["name"].startswith("host_syncs.") else "ms/call")
        assert m["better"] == "lower"
        assert m["source"] == ("program_counter" if m["name"].startswith("host_syncs.")
                               else "program_span")


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reads_each_metric_of_its_cell(workload):
    values = _run(workload, trace=True)
    assert set(values) == {m["name"] for m in OWN if workload in m["workloads"]}
    assert all(v["value"] > 0 for v in values.values()), values


def test_an_untraced_run_reads_none():
    assert _run("selfpose3d_cam5.live_b1", trace=False) == {}


def test_a_program_without_spans_reads_none(monkeypatch):
    import selfpose3d_tpu_torch.utils as utils

    from portbench.core import stages

    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "selfpose3d_tpu_torch.utils.spans", None)
    run = {"trace": {"calls": 1}}
    assert stages.stage_ms(run, "sp3d.backbone") is None
    assert stages.counted(run, "host_syncs.") is None


@pytest.mark.parametrize("device_pass", [True, False])
def test_a_reading_covers_one_pass_calls_alone(device_pass):
    """With a device-only pass (``stretch`` in the trace) the reading is that
    pass's calls, the first of the two; a stage span outside every call
    (a debug dump's backbone) counts for nothing."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.core import stages
    from selfpose3d_tpu_torch.utils import spans

    def call(ms: float, syncs: int):
        with spans.span("sp3d.infer"):
            with spans.span("sp3d.backbone"):
                spans.count("host_syncs.t_site", syncs)
                time.sleep(ms / 1e3)

    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("sp3d.backbone"):  # outside every call
            time.sleep(0.2)
        call(5, 1)  # a leftover call of an earlier run
        call(20, 2)
        call(20, 2)
        if device_pass:
            call(100, 4)
            call(100, 4)
    trace = {"calls": 2, **({"stretch": 1.0} if device_pass else {})}
    ms = stages.stage_ms({"trace": trace}, "sp3d.backbone")
    assert 20 <= ms < 60
    assert stages.counted({"trace": trace}, "host_syncs.") == 2
    assert stages.stage_ms({"trace": {"calls": 6}}, "sp3d.backbone") is None  # too few calls
