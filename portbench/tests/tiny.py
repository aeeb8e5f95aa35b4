"""A small float32 configuration of each model and small traffic, for
driving the harness on the CPU."""

from __future__ import annotations

from portbench.core import spec

SMALL = {
    "DTYPE": "float32",
    "NETWORK": {"IMAGE_SIZE": [256, 128], "HEATMAP_SIZE": [64, 32]},
    "POSE_RESNET": {"NUM_LAYERS": 18},
    "MULTI_PERSON": {"INITIAL_CUBE_SIZE": [16, 16, 8], "MAX_PEOPLE_NUM": 4},
    "PICT_STRUCT": {"CUBE_SIZE": [16, 16, 16]},
    "DATASET": {"CAMERA_NUM": 3},
}


def yaml(config: str, **extra) -> dict:
    return spec.merged(spec.merged(spec.config_file(config)["yaml"], SMALL), extra)


def traffic(name: str, **extra) -> dict:
    t = spec.traffic_file(name)
    t.update({"pool": 3, "warmup_calls": 1, "trace_calls": 2}, **extra)
    if t["task"] == "infer":
        t["batch"] = min(t["batch"], 2)
    return t


def cell(workload: str) -> dict:
    return spec.cell_file(workload)
