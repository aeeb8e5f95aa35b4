"""Data parallelism over processes (counterpart of
``selfpose3d_tpu/parallel/mesh.py``).

The reference trains with single-process ``nn.DataParallel`` over 2 GPUs
(ref: tools/train_3d.py:140); the JAX package runs one SPMD program over
a mesh, the batch sharded over the 'data' axis, so every reduction of its
losses and BatchNorm moments runs over the global batch. Here one process
drives one device, ``torch.distributed`` joins the processes, and
``DistributedDataParallel`` (DDP) averages the gradients. A W-rank step at
per-rank batch b computes what one process computes at W*b:

  * BatchNorm takes its batch moments from sums over ranks, and its
    backward sums the moments' cotangents over ranks, so it reaches every
    rank's examples (``models/norm.py``);
  * a ratio loss contributes ``W * local numerator / global denominator``
    on each rank, so DDP's mean over ranks is the global ratio; a gate is
    reduced with MAX; no gradient passes through a count
    (``models/multi_person.py``).

Every function is the identity at world size 1, and without a process
group the callers run exactly their one-process code.
"""

from __future__ import annotations

import inspect
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from selfpose3d_tpu_torch.utils import spans


def init_distributed(backend: Optional[str] = None) -> torch.device:
    """Join the process group that ``torch.distributed.run`` describes
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) -> this
    process's device: ``cuda:LOCAL_RANK`` under nccl, the CPU under gloo.

    ``backend`` None: nccl where CUDA is available, else gloo. Under nccl
    the process's CUDA device is set before the group is formed. A process
    that already belongs to a group (its caller formed one) keeps it; the
    group's backend must then be ``backend``."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if _group():
        if dist.get_backend() != backend:
            raise ValueError(f"this process is in a {dist.get_backend()} group, not {backend}")
        return _group_device()
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cpu")
    if backend == "nccl":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="env://",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _group() else 0


def world() -> int:
    return dist.get_world_size() if _group() else 1


def local_batch_size(per_device_batch: int) -> int:
    """Per-process batch of the input pipeline: one device a process, so
    the per-device batch (TRAIN.BATCH_SIZE / TEST.BATCH_SIZE)."""
    return per_device_batch


def _group_device() -> torch.device:
    """Where the group's collectives take their tensors: the current CUDA
    device under nccl, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce(t: torch.Tensor, op) -> torch.Tensor:
    """A reduced copy of ``t`` on ``t``'s device (through the group's
    device when they differ)."""
    buf = t.detach().to(_group_device(), copy=True).contiguous()
    dist.all_reduce(buf, op=op)
    return buf.to(t.device)


class AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its backward sums the cotangents over ranks, so each
    rank's inputs receive the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return _all_reduce(x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return _all_reduce(g, dist.ReduceOp.SUM)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum over ranks; ``x`` itself at world size 1."""
    return AllReduceSum.apply(x) if world() > 1 else x


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over ranks, without gradient; ``x`` at world size 1."""
    return _all_reduce(x, dist.ReduceOp.MAX) if world() > 1 else x.detach()


def agree_max(value: int) -> int:
    """The largest of every rank's ``value`` (a host integer)."""
    if world() == 1:
        return int(value)
    spans.count("host_syncs.agree_max", 2)  # through the group's device and back
    return int(_all_reduce(torch.tensor([int(value)], dtype=torch.int64),
                           dist.ReduceOp.MAX)[0])


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of ``x`` (reported metrics), without gradient."""
    if world() == 1:
        return x
    return _all_reduce(x, dist.ReduceOp.SUM) / world()


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def process_allgather_tree(tree: Any) -> Any:
    """All-gather host numpy arrays over ranks, concatenated on axis 0 in
    rank order (a tuple, list or dict of arrays, or one array). Every rank
    passes arrays of the same shapes (``validate_3d`` pads its rows to a
    fixed count); the identity at world size 1. The gather runs on the
    group's device, so nccl gets CUDA tensors."""
    if world() == 1:
        return tree
    if isinstance(tree, dict):
        return {k: process_allgather_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(process_allgather_tree(v) for v in tree)
    spans.count("host_syncs.allgather", 2)  # through the group's device and back
    x = torch.from_numpy(np.ascontiguousarray(tree)).to(_group_device())
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x)
    return torch.cat(parts).cpu().numpy()


def wrap_model(model: nn.Module, find_unused: bool) -> nn.Module:
    """``model`` in ``DistributedDataParallel`` when a process group exists
    (also at world size 1), else ``model`` itself. Buffers are not
    broadcast: the running statistics agree by construction, every rank's
    BatchNorm seeing the global moments. ``find_unused`` must be set when
    a trainable parameter gets no gradient in a step."""
    if not _group():
        return model
    dev = next(model.parameters()).device
    ddp = nn.parallel.DistributedDataParallel
    # newer releases name broadcast_buffers=False forward_sync_buffers=False
    sync = ("forward_sync_buffers" if "forward_sync_buffers" in inspect.signature(ddp).parameters
            else "broadcast_buffers")
    return ddp(model, device_ids=[dev] if dev.type == "cuda" else None,
               find_unused_parameters=find_unused, **{sync: False})
