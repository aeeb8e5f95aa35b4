"""Every cell, configuration, traffic mix and metric loads as data and keeps
to the benchmark's naming rules; each is found by its name."""

from __future__ import annotations

import json
import re

import pytest

from portbench.core import spec
from portbench.reference.config import ref_config

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_valid(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_loads(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"portbench/configs/{config}.json"
    data = spec.config_file(config)
    assert data["source"] and data["deployment"] and isinstance(data["assumed"], dict)
    assert sorted(data["reduced"]) == sorted(entry["reduced"])
    cfg = ref_config(data["yaml"])
    assert cfg.joints == 15 and cfg.layers == 50 and cfg.views == 5
    assert cfg.image_wh == (960, 512)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_traffic_entry_loop_found_by_name(workload):
    w = spec.workload(BENCH, workload)
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    cell = spec.cell_file(workload)
    assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
    traffic = spec.traffic_file(w["traffic"])
    assert traffic["task"] in ("infer", "train")
    assert traffic["batch"] >= 1 and traffic["pool"] >= 3 and traffic["trace_calls"] >= 1
    assert hasattr(spec.entry(cell["entry"]), "Program")
    assert hasattr(spec.loop(traffic["loop"]), "run")
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_rules_and_reader(metric):
    m = next(x for x in METRICS if x["name"] == metric)
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert set(m["workloads"]) <= set(WORKLOADS) if "workloads" in m else True
    assert callable(spec.metric(metric).read)
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        e2e = {e["name"]: e for e in BENCH["end_to_end"]}
        assert m["moves"] in e2e
        reported = e2e[m["moves"]].get("workloads", WORKLOADS)
        assert set(m["workloads"]) <= set(reported)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_reports_setup_another_e2e_and_a_layer(workload):
    mine = spec.metrics_of(BENCH, workload)
    names = [m["name"] for m in mine["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert mine["per_layer"]


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"entry (host dispatch)", "model step", "kernels", "device"}
