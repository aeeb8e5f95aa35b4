"""CUDA graphs of the inference call's stages.

An inference entry (``MultiPersonPoseNetSSV.do_inference``, the supervised
``MultiPersonPoseNet.forward(train=False)``, s4's ``topdown_keypoints``)
opens ``entry(model)``; inside it each stage body runs through
``run(stage, module, fn, *args)``: the backbone's heatmaps,
``RootNet.forward`` and ``PoseNet._run``; s4's HRNet with its flip test. ``run``
calls ``fn(module, *args)`` as it is unless every tensor of ``args`` is on
CUDA, autograd is off, no stream is capturing and no submodule of
``module`` is in training mode. Then the call's signature decides:

- the stage's name and function, every tensor's shape, strides, dtype and
  device, the other arguments' values (which optional inputs are None),
  the storages of ``module``'s parameters and buffers, and the modes that
  change a kernel's arithmetic (inference mode, autocast, TF32,
  deterministic algorithms);
- the first call of a signature runs eager (cuDNN's algorithm selection,
  the kernels' first build and load, the host constants' caches);
- the second captures ``fn`` into a ``torch.cuda.CUDAGraph`` and replays
  it; every later one copies its inputs into the graph's static buffers
  and replays. The same kernels run in the same order on the same
  weights: a replay equals the eager call bit for bit.

Parameters updated in place (an optimizer's step, ``load_state_dict``)
keep their storages, so a replay reads the new weights; a new storage (a
``.to()``, a state dict assigned) is a new signature and a new capture.
The graphs of a model share one memory pool and live as long as the
model; its inference calls run one at a time, as a graph's static buffers
serve every call. The static inputs are allocated outside the pool and every output
leaves ``run`` as a fresh copy, so a replay never overwrites what an
earlier call returned, in whatever order the graphs replay.

The spans of ``utils/spans.py`` stay outside a replay: the stage's span,
around ``run``, times the replay with its CUDA events; spans inside the
stage (``sp3d.proposals``) record in an eager call, never in a capture,
and not in a replay, where no Python of the stage runs. The counters a
stage changed while it was captured (``launches.*``) are changed again at
each replay. ``graphs.captures.<stage>`` and ``graphs.replays.<stage>``
count the captures and replays (the replay that follows a capture too).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import weakref
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

from selfpose3d_tpu_torch.utils import spans

STAGES = ("backbone", "rootnet", "posenet", "hrnet")
COUNTS: Dict[str, int] = {f"{k}.{s}": 0 for k in ("captures", "replays") for s in STAGES}
spans.register("graphs.", COUNTS)

_LEAF = "tensor"
_local = threading.local()  # the thread's open entry: its model's _State
_states: "weakref.WeakKeyDictionary[nn.Module, _State]" = weakref.WeakKeyDictionary()


class _State:
    """One model's graphs: the signatures seen once, the graphs, their pool."""

    __slots__ = ("seen", "graphs", "pool")

    def __init__(self):
        self.seen: set = set()
        self.graphs: Dict[tuple, _Graph] = {}
        self.pool = None


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "out_spec", "counts")


@contextlib.contextmanager
def entry(model: nn.Module):
    """The scope of one inference call of ``model``: ``run`` may replay
    graphs inside it."""
    outer = getattr(_local, "state", None)
    state = _states.get(model)
    if state is None:
        state = _states[model] = _State()
    _local.state = state
    try:
        yield
    finally:
        _local.state = outer


def _flatten(x, leaves: List[torch.Tensor]):
    """The structure of ``x`` with its tensors taken out into ``leaves``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _LEAF
    if x is None or isinstance(x, bool):
        return ("value", x)
    if isinstance(x, tuple):
        return (tuple, tuple(_flatten(v, leaves) for v in x))
    if dataclasses.is_dataclass(x):
        return (type(x), tuple((f.name, _flatten(getattr(x, f.name), leaves))
                               for f in dataclasses.fields(x)))
    raise TypeError(f"a stage argument of type {type(x).__name__}")


def _unflatten(spec, leaves):
    """``_flatten``'s inverse, taking the tensors from the iterator ``leaves``."""
    if spec == _LEAF:
        return next(leaves)
    kind, body = spec
    if kind == "value":
        return body
    if kind is tuple:
        return tuple(_unflatten(s, leaves) for s in body)
    return kind(**{name: _unflatten(s, leaves) for name, s in body})


def submodules(module: nn.Module) -> List[nn.Module]:
    """``module`` and every module under it: ``module.modules()`` without
    its names and its set of seen modules, which cost the most of a walk."""
    out = [module]
    i = 0
    while i < len(out):
        out.extend(m for m in out[i]._modules.values() if m is not None)
        i += 1
    return out


def set_training(module: nn.Module, mode: bool) -> None:
    """``module.train(mode)``, setting only the modules in the other mode."""
    if not isinstance(mode, bool):
        raise ValueError("training mode is expected to be boolean")
    for m in submodules(module):
        if m.training != mode:
            m.training = mode


def _weights(module: nn.Module) -> Optional[tuple]:
    """The storages of ``module``'s parameters and buffers; None where a
    submodule is in training mode."""
    ptrs = []
    for sub in submodules(module):
        if sub.training:
            return None
        ptrs.extend([t.data_ptr() for t in sub._parameters.values() if t is not None])
        ptrs.extend([t.data_ptr() for t in sub._buffers.values() if t is not None])
    return tuple(ptrs)


def _modes() -> tuple:
    return (torch.is_inference_mode_enabled(), torch.is_autocast_enabled("cuda"),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())


def run(stage: str, module: nn.Module, fn: Callable, *args):
    """``fn(module, *args)``, eager or from the stage's graph (module doc)."""
    state = getattr(_local, "state", None)
    if state is None or torch.is_grad_enabled():
        return fn(module, *args)
    leaves: List[torch.Tensor] = []
    spec = _flatten(args, leaves)
    if not leaves or any(not t.is_cuda for t in leaves):
        return fn(module, *args)
    if torch.cuda.is_current_stream_capturing():
        return fn(module, *args)
    weights = _weights(module)
    if weights is None:
        return fn(module, *args)
    sig = (stage, fn, spec, weights, _modes(),
           tuple((t.shape, t.stride(), t.dtype, t.device) for t in leaves))
    g = state.graphs.get(sig)
    if g is None:
        if sig not in state.seen:
            state.seen.add(sig)
            return fn(module, *args)
        g = state.graphs[sig] = _capture(state, stage, module, fn, spec, leaves)
    else:
        for dst, src in zip(g.inputs, leaves):
            dst.copy_(src)
        spans.add(g.counts)
    g.graph.replay()
    COUNTS["replays." + stage] += 1
    return _unflatten(g.out_spec, iter([t.clone() for t in g.outputs]))


@contextlib.contextmanager
def _expandable_segments():
    """New segments of the caching allocator expandable while a graph is
    captured. A capture gives no memory back (no cudaFree while a stream
    captures), and in fixed segments each large allocation takes one of its
    own that a later, larger one cannot use: PoseNet's capture at batch 32
    reserved 75 GB so, twice its peak, and 41 GB in one expandable segment
    (NVIDIA H100 80GB HBM3, PyTorch 2.11). Left as it is where the process
    set it (``PYTORCH_ALLOC_CONF``) or does not use the native allocator."""
    conf = os.environ.get("PYTORCH_ALLOC_CONF") or os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
    if ("expandable_segments:true" in conf.replace(" ", "").lower()
            or torch.cuda.memory.get_allocator_backend() != "native"):
        yield
        return
    torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
    try:
        yield
    finally:
        torch._C._accelerator_setAllocatorSettings("expandable_segments:False")


def _capture(state: _State, stage: str, module: nn.Module, fn: Callable, spec, leaves) -> _Graph:
    g = _Graph()
    g.inputs = [torch.empty_like(t).copy_(t) for t in leaves]
    g.graph = torch.cuda.CUDAGraph()
    before = spans.counters()
    # thread_local: the loader's threads may pin host memory during a capture
    with spans.muted(), _expandable_segments(), torch.cuda.graph(
            g.graph, pool=state.pool, capture_error_mode="thread_local"):
        out = fn(module, *_unflatten(spec, iter(g.inputs)))
    g.outputs = []
    g.out_spec = _flatten(out, g.outputs)
    g.counts = {k: n for k, n in spans.changes(before).items() if not k.startswith("graphs.")}
    if state.pool is None:
        state.pool = g.graph.pool()
    COUNTS["captures." + stage] += 1
    return g
