"""Load the Pallas kernels of the measurement probes under ``scripts/``
without running the probes.

``scripts/microbench*.py`` run their whole measurement at import (and set a
persistent compile cache), so the tests parse a probe with ``ast`` and
execute only the named top-level definitions and constants, in a namespace
whose ``pl.pallas_call`` runs in interpret mode on the CPU. The probe files
are not modified.
"""

from __future__ import annotations

import ast
import functools
import types
from pathlib import Path

from jax.experimental import pallas as pl

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"

# pl.pallas_call forced into interpret mode; BlockSpec as is
INTERPRET_PL = types.SimpleNamespace(
    pallas_call=functools.partial(pl.pallas_call, interpret=True),
    BlockSpec=pl.BlockSpec,
)


def load_probe(script: str, names, namespace: dict) -> dict:
    """Execute the top-level functions and constants ``names`` of
    ``scripts/<script>`` in ``namespace`` (its imports are the caller's to
    provide) and return the namespace. A name already in ``namespace``
    overrides the script's constant of that name."""
    tree = ast.parse((SCRIPTS / script).read_text(), filename=script)
    wanted = set(names)
    keep = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in wanted:
            keep.append(node)
            wanted.discard(node.name)
        elif isinstance(node, ast.Assign):
            targets = {t.id for t in node.targets if isinstance(t, ast.Name)}
            targets |= {e.id for t in node.targets if isinstance(t, ast.Tuple)
                        for e in t.elts if isinstance(e, ast.Name)}
            if targets & wanted:
                keep.append(node)
                wanted -= targets
    if wanted:
        raise KeyError(f"{script}: no top-level definition of {sorted(wanted)}")
    overrides = {k: namespace[k] for k in names if k in namespace}
    ns = dict(namespace)
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(SCRIPTS / script), "exec"), ns)
    ns.update(overrides)
    return ns
