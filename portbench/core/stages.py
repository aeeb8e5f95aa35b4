"""Per-call readings of the program's own spans and counters
(``selfpose3d_tpu_torch/utils/spans.py``), for the ``program_span`` and
``program_counter`` metrics.

The spans record only while a profiler records, so they cover the calls of
a traced run's passes (``core/trace.py``). A reading is the mean over the
calls of one pass: on CUDA the device-only pass, the one the busy time comes
from (the pass that also records the host stretches a host-paced call
more), else the host's pass. A call is a root span ``sp3d.infer`` or
``sp3d.train_step``, and only spans inside those calls count. A stage's
time is its device ms, from the CUDA events around it (where the host sets
the pace, they include the device's wait for the stage's launches); a
count is the change of a family of counters. None where the program has no
spans (an older program), the run traced nothing, or no span of the stage
ran in the calls.
"""

from __future__ import annotations

from typing import Dict, List, Optional

CALLS = ("sp3d.infer", "sp3d.train_step")


def _calls(run: Dict) -> List[dict]:
    """The summary's roots of the pass's calls, in order."""
    trace = run.get("trace")
    if not trace:
        return []
    try:
        from selfpose3d_tpu_torch.utils import spans
    except ImportError:
        return []
    roots = [r for r in spans.summary()["roots"] if r["name"] in CALLS]
    n = trace["calls"]
    passes = 2 if "stretch" in trace else 1  # "stretch": the device-only pass ran first
    if len(roots) < passes * n:
        return []
    return roots[len(roots) - passes * n:][:n]


def stage_ms(run: Dict, name: str) -> Optional[float]:
    """The device ms of the spans ``name`` per call."""
    calls = _calls(run)
    if not calls:
        return None
    from selfpose3d_tpu_torch.utils import spans

    ids = {r["id"] for r in calls}
    ms = [r["device_ms"] for r in spans.records() if r["name"] == name and r["root"] in ids]
    return sum(ms) / len(calls) if ms else None


def counted(run: Dict, prefix: str) -> Optional[float]:
    """The change of the counters whose names start with ``prefix`` per call."""
    calls = _calls(run)
    if not calls:
        return None
    return sum(v for r in calls for k, v in r["counts"].items() if k.startswith(prefix)) / len(calls)
