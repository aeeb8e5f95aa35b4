"""No run loads JAX or the JAX package, compared by whole top-level names
(``selfpose3d_tpu_torch`` begins with ``selfpose3d_tpu``); the reference
imports nothing of the program; without a card a run fails and prints no
result."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "selfpose3d_tpu"}


def imported_roots(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "selfpose3d_tpu_torch" not in imported_roots(path)


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)


def test_loading_the_reference_loads_no_program_module():
    r = _python("import sys; import portbench.reference.model, portbench.reference.geometry, "
                "portbench.reference.config; "
                "print(sorted({m.split('.')[0] for m in sys.modules} & "
                "{'selfpose3d_tpu_torch', 'selfpose3d_tpu', 'jax'}))")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_a_run_leaves_no_jax_in_sys_modules():
    code = """
import sys, time, json
from portbench.core import runner
from portbench.tests import tiny
import portbench.run as run
w = "voxelpose_prn32_cam5.offline_b32"
cell = tiny.cell(w)
ctx = runner.make_ctx(w, 3, "cpu", cell, tiny.traffic(cell["traffic"]), tiny.yaml("voxelpose_prn32_cam5"))
out = runner.run(ctx, 0.2, False, time.perf_counter())
found = run.forbidden_modules()
sys.modules["selfpose3d_tpu"] = sys.modules["json"]
print(json.dumps([found, run.forbidden_modules(), "selfpose3d_tpu_torch" in sys.modules]))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    found, planted, port = json.loads(r.stdout.strip().splitlines()[-1])
    assert found == [] and planted == ["selfpose3d_tpu"] and port


def test_without_a_card_a_run_fails_and_prints_no_result():
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "selfpose3d_cam5.offline_b32", "--seed", str(2 ** 31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
