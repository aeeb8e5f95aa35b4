"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root and, found
by name under ``portbench/``, each configuration (``configs/<name>.json``),
traffic mix (``traffic/<name>.json``), cell (``cells/<workload>.json``),
entry (``entries/<name>.py``), loop (``loops/<name>.py``) and metric
(``metrics/<name up to its first dot>.py``)."""

from __future__ import annotations

import copy
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def checked_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> dict:
    return read_json(BENCH_DIR / "configs" / f"{checked_name(name)}.json")


def traffic_file(name: str) -> dict:
    return read_json(BENCH_DIR / "traffic" / f"{checked_name(name)}.json")


def cell_file(name: str) -> dict:
    return read_json(BENCH_DIR / "cells" / f"{checked_name(name)}.json")


def merged(base: dict, overrides: dict) -> dict:
    """``base`` with ``overrides`` laid over it, section by section."""
    out = copy.deepcopy(base)
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def cell_yaml(cell: dict) -> dict:
    """The configuration's keys as the cell runs them."""
    return merged(config_file(cell["config"])["yaml"], cell.get("overrides", {}))


def metrics_of(bench: dict, name: str) -> Dict[str, List[dict]]:
    """The cell's end-to-end and per-layer metrics: a metric with a
    ``workloads`` list is the listed cells'; one without it is every cell's."""
    out = {}
    for kind in ("end_to_end", "per_layer"):
        out[kind] = [m for m in bench[kind] if name in m.get("workloads", [name])]
    return out


def _module(path: Path, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str) -> ModuleType:
    return _module(BENCH_DIR / "entries" / f"{checked_name(name)}.py", f"portbench_entry_{name}")


def loop(name: str) -> ModuleType:
    return _module(BENCH_DIR / "loops" / f"{checked_name(name)}.py", f"portbench_loop_{name}")


def metric(name: str) -> ModuleType:
    base = checked_name(name).split(".")[0]
    return _module(BENCH_DIR / "metrics" / f"{base}.py", f"portbench_metric_{base}")
