"""Spans and counters of the port's own stages.

``span(name)`` marks a stage, as a context manager or as a decorator. It
records only while a ``torch.profiler`` records
(``torch.autograd._profiler_enabled()``); otherwise it costs that one check
and makes no range, no event and no object. A recorded span

- opens a ``torch.profiler.record_function`` range of its name, so that
  the profiler's trace holds it on the trace's own clock;
- reads the host clock (``time.perf_counter_ns``) at its start and end;
- where CUDA is in use, records a pair of timing events on the current
  stream;
- keeps its parent and its call: every span of one call carries the id of
  the call's root span, the outermost one open. A root span also keeps the
  change of every counter over it.

``meter(name)`` is a span that also times itself on the host clock when
nothing records: the loops' meters read it. No span records inside
``muted()``: ``utils/graphs.py`` captures a stage's CUDA graph there, where
a range and its timing events would become part of the graph.

``count(name, n)`` adds to a counter, recording or not. ``register(prefix,
counts)`` makes a dict of counts kept elsewhere (``ops/slicewarp.py:LAUNCHES``,
``ops/conv_epilogue.py:LAUNCHES``, ``utils/graphs.py:COUNTS``) part of the
counters, under ``prefix``; ``add(deltas)`` adds to any counter by its
full name (a graph's replay repeats the changes its capture made). The
counters ``host_syncs.<site>`` count every place where the port makes the
host wait for the device: a read of a device value (``int()``, ``bool()``,
``.tolist()``, ``.cpu()``, indexing by a ``nonzero``) or a blocking copy
of host values to the device. They count the same on the CPU, where nothing waits. The counter
``bn_folds`` counts each eval BatchNorm applied in a convolution's
epilogue (``models/norm.py:conv_bn``); no weight is folded, the
BatchNorm's affine is folded into the epilogue pass.

Records stay in memory, at most ``CAPACITY`` of them. ``summary()``
synchronises once and resolves the events, and gives every counter's
change since ``reset()``, which empties the buffer: so the counts of
sites outside every root (the loops' reads) are reported too.

The stage names are fixed: the benchmark's per-layer metrics read them
(``portbench/core/stages.py``). Roots: ``sp3d.infer`` (``do_inference``, the
supervised ``forward(train=False)``, s4's ``topdown_keypoints``),
``sp3d.train_step`` (both train steps). Stages: ``sp3d.backbone``,
``sp3d.attn``, ``sp3d.rootnet`` (each RootNet call) holding
``sp3d.proposals``, ``sp3d.posenet``, ``sp3d.losses`` (the terms after
PoseNet) holding ``sp3d.matching``, ``sp3d.backward``, ``sp3d.optimizer``;
s4's ``sp3d.crops`` (copies in, crops), ``sp3d.hrnet`` (the network and
its flip test), ``sp3d.keypoints`` (decode, the copy out). The loops: ``sp3d.loader_wait``, ``sp3d.debug_dump``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

CAPACITY = 1 << 16

_recording = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns
_counts: Dict[str, int] = {}
_sources: List[Tuple[str, Dict[str, int]]] = [("", _counts)]
_records: List["_Record"] = []
_dropped = 0
_since: Dict[str, int] = {}  # the counters at the last reset()
_ids = itertools.count(1)
_local = threading.local()  # each thread's stack of open records
_spans: Dict[str, "_Span"] = {}
_muted = 0  # > 0 inside muted()


class _Record:
    __slots__ = ("owner", "name", "id", "parent", "root", "t0", "t1", "events", "range",
                 "counts", "host_ms", "device_ms", "cuda")


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _open(owner: "_Span") -> None:
    stack = _stack()
    parent = stack[-1] if stack else None
    rec = _Record()
    rec.owner, rec.name, rec.id = owner, owner.name, next(_ids)
    rec.parent = parent.id if parent else 0
    rec.root = parent.root if parent else rec.id
    rec.counts = None if parent else counters()
    rec.host_ms = rec.device_ms = None
    rec.range = torch.autograd.profiler.record_function(owner.name)
    rec.range.__enter__()
    rec.events = None
    rec.cuda = torch.cuda.is_initialized()
    if rec.cuda:
        rec.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        rec.events[0].record()
    stack.append(rec)
    rec.t0 = _clock()


def _close(stack: list) -> None:
    global _dropped
    t1 = _clock()
    rec = stack.pop()
    rec.t1 = t1
    if rec.events is not None:
        rec.events[1].record()
    rec.range.__exit__(None, None, None)
    rec.owner = rec.range = None
    if rec.counts is not None:
        rec.counts = changes(rec.counts)
    if len(_records) < CAPACITY:
        _records.append(rec)
    else:
        _dropped += 1


class _Span:
    """One stage name; reentrant, shared by every use of the name."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        if _recording() and not _muted:
            _open(self)
        return self

    def __exit__(self, *exc) -> bool:
        stack = getattr(_local, "stack", None)
        if stack and stack[-1].owner is self:
            _close(stack)
        return False

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with self:
                return fn(*args, **kwargs)

        return spanned


def span(name: str) -> _Span:
    """The span of ``name``: ``with span(name):`` or ``@span(name)``."""
    s = _spans.get(name)
    if s is None:
        s = _spans[name] = _Span(name)
    return s


class meter:
    """``with m:`` spans ``name`` and leaves the block's host seconds in
    ``m.seconds``, recording or not."""

    __slots__ = ("span", "seconds", "_t0")

    def __init__(self, name: str):
        self.span, self.seconds, self._t0 = span(name), 0.0, 0

    def __enter__(self) -> "meter":
        self._t0 = _clock()
        self.span.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.span.__exit__(*exc)
        self.seconds = (_clock() - self._t0) * 1e-9
        return False


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def add(deltas: Dict[str, int]) -> None:
    """Add each ``deltas[name]`` to the counter ``name``, a registered one
    (``prefix + key``) too."""
    for name, n in deltas.items():
        for prefix, d in _sources:
            if prefix and name.startswith(prefix) and name[len(prefix):] in d:
                d[name[len(prefix):]] += n
                break
        else:
            count(name, n)


@contextlib.contextmanager
def muted():
    """No span records inside (a capture of a CUDA graph)."""
    global _muted
    _muted += 1
    try:
        yield
    finally:
        _muted -= 1


def register(prefix: str, counts: Dict[str, int]) -> None:
    """Read ``counts`` (kept up to date by its owner) as counters named
    ``prefix + key``; several dicts may share a prefix."""
    if all(d is not counts for _, d in _sources):
        _sources.append((prefix, counts))


def counters() -> Dict[str, int]:
    """Every counter's value now."""
    return {p + k: v for p, d in _sources for k, v in d.items()}


def reset() -> None:
    """Empty the buffer of records; counters keep counting, and
    ``summary()`` gives their changes from here on."""
    global _dropped, _since
    _records.clear()
    _dropped = 0
    _since = counters()


def changes(before: Dict[str, int]) -> Dict[str, int]:
    """Every counter's change since ``before`` (a ``counters()``), where it changed."""
    return {k: v - before.get(k, 0) for k, v in counters().items() if v != before.get(k, 0)}


def _resolve(recs: List[_Record]) -> None:
    """Host and device ms of each record, once."""
    pending = [r for r in recs if r.host_ms is None]
    if any(r.events is not None for r in pending):
        torch.cuda.synchronize()
    for r in pending:
        r.host_ms = (r.t1 - r.t0) * 1e-6
        r.device_ms = r.events[0].elapsed_time(r.events[1]) if r.events else r.host_ms
        r.events = None


def summary() -> dict:
    """The buffer's spans: per name ``count``, ``host_ms``, ``host_self_ms``,
    ``device_ms``, ``device_self_ms`` (self: less what its children
    cover); ``roots``, each root span's ``name``, ``id``, ``host_ms``,
    ``device_ms`` and ``counts`` (the counters' changes over it);
    ``counts_since_reset``, every counter's change since ``reset()`` (or
    since the process started), inside a span or not; ``device_clock``:
    ``"cuda_events"`` where the device ms come from CUDA events, ``"host"``
    where nothing ran on CUDA and they are the host ms; ``dropped``, the
    records a full buffer turned away."""
    recs = list(_records)
    _resolve(recs)
    cuda = any(r.cuda for r in recs)
    kids_host: Dict[int, float] = defaultdict(float)
    kids_dev: Dict[int, float] = defaultdict(float)
    for r in recs:
        if r.parent:
            kids_host[r.parent] += r.host_ms
            kids_dev[r.parent] += r.device_ms
    spans: Dict[str, Dict[str, float]] = {}
    for r in recs:
        s = spans.setdefault(r.name, {"count": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                                      "device_ms": 0.0, "device_self_ms": 0.0})
        s["count"] += 1
        s["host_ms"] += r.host_ms
        s["host_self_ms"] += r.host_ms - kids_host[r.id]
        s["device_ms"] += r.device_ms
        s["device_self_ms"] += r.device_ms - kids_dev[r.id]
    roots = [{"name": r.name, "id": r.id, "host_ms": r.host_ms, "device_ms": r.device_ms,
              "counts": dict(r.counts)} for r in recs if not r.parent]
    return {"device_clock": "cuda_events" if cuda else "host", "spans": spans, "roots": roots,
            "counts_since_reset": changes(_since), "dropped": _dropped}


def records() -> List[dict]:
    """The buffer's records in the order they closed: ``name``, ``id``,
    ``parent`` (0 for a root), ``root`` (the call's id), host start and end
    (ns), ``host_ms``, ``device_ms``."""
    recs = list(_records)
    _resolve(recs)
    return [{"name": r.name, "id": r.id, "parent": r.parent, "root": r.root, "t0_ns": r.t0,
             "t1_ns": r.t1, "host_ms": r.host_ms, "device_ms": r.device_ms} for r in recs]

