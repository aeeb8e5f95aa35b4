"""What the port imports: no module of JAX, Flax or the JAX package, no
OpenCV or Pillow at all (the port decodes and writes images itself), and
matplotlib only where a function needs it (the 3D plot writers).

Checked twice: in a fresh interpreter that imports every module of the
port (``sys.modules`` afterwards), and in the source of every module (the
functions that hold each ``import`` statement).
"""

import ast
import os
import subprocess
import sys

import selfpose3d_tpu_torch

PORT = os.path.dirname(selfpose3d_tpu_torch.__file__)
REPO = os.path.dirname(PORT)
NEVER = ("jax", "jaxlib", "flax", "selfpose3d_tpu")
# top-level package -> the functions allowed to import it
ONLY_IN = {"cv2": set(), "PIL": set(), "matplotlib": {"utils/vis.py:_plt"}}
# optional model backends of the pseudo-label stage s2 (as in the JAX package; s4 runs the port's HRNet)
BACKENDS = {"detectron2", "mmpose", "torchvision"}


def _modules():
    for dirpath, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)[:-3]
                yield rel.replace(os.sep, ".").removesuffix(".__init__")


def test_importing_every_module_loads_no_jax_opencv_pillow_or_matplotlib():
    code = ("import importlib, sys\n"
            f"for m in {sorted(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120).stdout.split()
    loaded = set(out)
    assert "selfpose3d_tpu_torch" in loaded
    assert not loaded & (set(NEVER) | set(ONLY_IN)), sorted(loaded & (set(NEVER) | set(ONLY_IN)))


def test_import_statements_sit_where_they_are_allowed():
    found = {}
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, PORT).replace(os.sep, "/")
            with open(path) as fh:
                tree = ast.parse(fh.read())
            funcs = [n for n in ast.walk(tree)
                     if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                owner = min((fn for fn in funcs
                             if fn.lineno <= node.lineno <= fn.end_lineno),
                            key=lambda fn: fn.end_lineno - fn.lineno, default=None)
                where = f"{rel}:{owner.name if owner else '<module>'}"
                for name in names:
                    found.setdefault(name.split(".")[0], set()).add(where)
    for top in NEVER:
        assert top not in found, (top, found.get(top))
    for top, allowed in ONLY_IN.items():
        assert found.get(top, set()) == allowed, (top, found.get(top))
    assert {w for t in BACKENDS for w in found.get(t, ())} <= {
        "pseudo_labels/inference.py:_default_detector"}
