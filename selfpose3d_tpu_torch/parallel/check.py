"""Holding a W-rank train step against one process's step at the global
batch, shared by the CPU tests (gloo processes) and ``chip_smoke.py``
(two gloo processes on one card).

``train_step_record`` runs one train step of a seeded model on this rank's
rows of a global batch through ``distribute`` (the plain step without a
process group) and records it; ``compare`` reduces a rank's record and the
one-process record of the same batch to the numbers ``BARS`` bounds.

Float32 gradients through batch-statistics BatchNorm agree only loosely
between any two arithmetics (tests/test_torch_train_step.py): BatchNorm's
backward removes the batch mean of the incoming gradient and its
projection on the normalised input, and what is left of a large gradient
carries the rounding of both. One process's SSV step of the CPU test at 1
and at 4 threads (two summation orders) differs by up to 0.076 of a
tensor's largest entry, 0.0044 in a net's relative L2, and Adam's first
step flips sign on entries the gradient decides; two ranks against one
process differ as much. So the gradients and Adam's update are held
tightly on a step whose BatchNorm runs on its running statistics
(``bn_eval``, the train step's loss composition), and within about three
times that noise on the batch-statistics step, whose loss terms and
running statistics are held tightly.
"""

from __future__ import annotations

import zlib
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from selfpose3d_tpu_torch.data.structures import AugBranch
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.models.multi_person import branch_rows
from selfpose3d_tpu_torch.ops import slicewarp
from selfpose3d_tpu_torch.parallel import mesh
from selfpose3d_tpu_torch.train.step import (
    distribute,
    make_ssv_train_step,
    make_supervised_train_step,
)
from selfpose3d_tpu_torch.train.train_state import create_train_state

NETS = ("backbone.", "attn.", "root_net.", "pose_net.")
# gradients zero in exact arithmetic: the soft-argmax ignores a constant
# added to a joint's scores, so PoseNet's output bias gets rounding alone
# (and ``zero_by_structure``'s biases in a batch-statistics step)
ZERO = ("pose_net.v2v_net.output_layer.bias",)
BARS = {
    "loss_rel": 1e-4, "loss_abs": 1e-7,  # each loss term (tests/test_ssv_loss_parity.py)
    "stats_rel": 1e-4, "stats_abs": 1e-5,  # running statistics
    # bn_eval: each gradient tensor to 1e-3 of its largest entry (float32
    # summation order alone, cuDNN's at batch 1 against batch 2, moves the
    # gradients of PoseNet's biases, which largely cancel, by 2.5e-4 of
    # their largest entry on the card); a tensor whose gradient is zero in
    # exact arithmetic (ZERO, or below 1e-6 of its net's largest: rounding
    # alone) to 1e-4 of the net's largest
    "grad_share": 1e-3, "grad_zero": 1e-4, "live": 1e-6,
    # Adam's parameters to 1e-5 where the gradient decides the step: an
    # entry at least 1e-3 of its tensor's largest and 100 eps, in a tensor
    # not zero in exact arithmetic; Adam's first step elsewhere is of any
    # sign, at most lr, so held to 2 lr
    "param_abs": 1e-5, "decided": 1e-3, "decided_abs": 1e-6,
    # batch statistics (the module docstring): each tensor's share, per
    # net the median tensor's share and the relative L2 distance of the
    # whole net's gradient, about three times what two summation orders
    # of one process give (0.076, 0.0079, 0.0044); a tensor zero in exact
    # arithmetic to 1e-2 of its net's largest (the rounding of BatchNorm's
    # sum over every voxel of the batch: up to 6.4e-4 at small_train_cfg);
    # every parameter after Adam to 2 lr
    "train_grad_share": 0.25, "train_grad_median": 0.03, "train_grad_l2": 1.5e-2,
    "train_grad_zero": 1e-2,
}


def local_rows(branches: Sequence[AugBranch]) -> list:
    """This rank's equal part of each global-batch branch, in rank order."""
    b, r = branches[0].batch_size // mesh.world(), mesh.rank()
    if b * mesh.world() != branches[0].batch_size:
        raise ValueError("the global batch must split evenly over the ranks")
    return [branch_rows(x, r * b, (r + 1) * b) for x in branches]


def zero_by_structure(model: nn.Module) -> list:
    """ZERO and the biases whose gradient the step just run made zero in
    exact arithmetic: a convolution's bias feeding, in an ``nn.Sequential``,
    a BatchNorm on batch statistics, which subtracts the batch mean and the
    bias with it (every V2V block)."""
    out = list(ZERO)
    for name, seq in model.named_modules():
        if not isinstance(seq, nn.Sequential):
            continue
        kids = list(seq.named_children())
        for (i, a), (_, b) in zip(kids, kids[1:]):
            if (isinstance(a, nn.modules.conv._ConvNd) and a.bias is not None
                    and isinstance(b, nn.modules.batchnorm._BatchNorm) and b.training):
                out.append(f"{name}.{i}.bias")
    return out


def _numpy(named) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in named}


def digest(rec: dict) -> int:
    """A checksum of a record's gradients, buffers and parameters (equal
    records, equal checksums)."""
    h = 1
    for part in ("grads", "buffers", "params"):
        for k in sorted(rec[part]):
            h = zlib.adler32(k.encode(), h)
            h = zlib.adler32(np.ascontiguousarray(rec[part][k]).tobytes(), h)
    return h


def train_step_record(cfg, branches: Sequence[AugBranch], device="cpu", seed: int = 0,
                      epoch: int = 0, bn_eval: bool = False) -> dict:
    """One train step of the model of ``seed`` at ``epoch``'s stage gates on
    this rank's rows of ``branches`` (three for the SSV model, one for the
    supervised baseline) -> {"metrics": the loss terms' means over ranks,
    "grads": the averaged gradients the optimizer saw, "buffers": the
    buffers after the step, "params": the parameters after the optimizer,
    "launches": this rank's sampler kernel launches, "digest": their
    checksum, "ranks_equal": whether every rank's is the same}, numpy or
    Python. ``bn_eval`` keeps every BatchNorm on its running statistics.
    The synthetic-root draws come from a generator seeded with ``epoch``.
    cuDNN runs its deterministic algorithms, so that on the card two runs
    of one step differ only by the sampler adjoint's atomic adds."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _record(cfg, branches, device, seed, epoch, bn_eval)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _record(cfg, branches, device, seed, epoch, bn_eval) -> dict:
    model = get_model(cfg, device=device, seed=seed)
    state = create_train_state(cfg, model)
    wrapped = distribute(model, cfg, (epoch,))
    if bn_eval:  # the step's own mode setting leaves every module in eval
        model._set_modes = lambda *_: model.eval()
    if hasattr(model, "ssv_losses"):
        step = make_ssv_train_step(
            wrapped, train_posenet_stage=epoch >= cfg.NETWORK.INIT_TRAIN_EPOCHS_ROOTNET,
            use_l1_stage=epoch >= cfg.TRAIN.L1_EPOCH)
        kw = {"generator": torch.Generator().manual_seed(epoch)}
    else:
        step, kw = make_supervised_train_step(wrapped), {}
    grads: Dict[str, np.ndarray] = {}
    apply = state.apply_gradients

    def record_and_apply():
        grads.update(_numpy((k, p.grad) for k, p in model.named_parameters()
                            if p.grad is not None))
        apply()

    state.apply_gradients = record_and_apply
    local = [x.to(device) for x in local_rows(branches)]
    slicewarp.reset_launches()
    metrics = step(state, *local, **kw)
    launches = dict(slicewarp.LAUNCHES)
    names = list(metrics)
    means = mesh.mean_over_ranks(torch.stack([metrics[k].float() for k in names])).tolist()
    rec = {"metrics": dict(zip(names, means)), "grads": grads,
           "buffers": _numpy(model.named_buffers()), "params": _numpy(model.named_parameters()),
           "launches": launches, "lr": float(cfg.TRAIN.LR), "zero": zero_by_structure(model)}
    rec["digest"] = digest(rec)
    digests = [rec["digest"]]
    if mesh.world() > 1:
        digests = [None] * mesh.world()
        dist.all_gather_object(digests, rec["digest"])
    rec["ranks_equal"] = len(set(digests)) == 1
    return rec


def pack(rec: dict) -> dict:
    """A record with each array part as one flat tensor, which a
    ``torch.multiprocessing`` queue moves through shared memory (the sender
    keeps it alive until the receiver has unpacked it)."""
    out = {k: v for k, v in rec.items() if k not in ("grads", "buffers", "params")}
    for part in ("grads", "buffers", "params"):
        names = sorted(rec[part])
        flat = np.concatenate([rec[part][k].ravel() for k in names])
        out[part] = (names, [rec[part][k].shape for k in names], torch.from_numpy(flat))
    return out


def unpack(msg: dict) -> dict:
    """The record ``pack`` flattened."""
    rec = dict(msg)
    for part in ("grads", "buffers", "params"):
        names, shapes, flat = msg[part]
        flat, arrays, at = flat.numpy(), {}, 0
        for k, shape in zip(names, shapes):
            n = int(np.prod(shape))
            arrays[k], at = flat[at : at + n].reshape(shape), at + n
        rec[part] = arrays
    return rec


def _net(name: str) -> str:
    return next((n for n in NETS if name.startswith(n)), "")


def compare(got: dict, want: dict) -> dict:
    """A rank's record against the one-process record -> the numbers BARS
    bounds: each term's relative error, the running statistics' largest
    excess over the relative bar, per gradient tensor the largest error as
    a share of its largest entry (``grad_share``; ``grad_zero`` for the
    tensors zero in exact arithmetic, as a share of the net's largest), per
    net the median share and the relative L2 distance, per
    parameter the largest error where the gradient decides Adam's step and
    the largest error anywhere. The tensors zero in exact arithmetic are
    ``want``'s ``zero`` (``zero_by_structure``)."""
    terms = {k: abs(got["metrics"][k] - w) / max(abs(w), BARS["loss_abs"] / BARS["loss_rel"])
             for k, w in want["metrics"].items()}
    stats = max((float(np.max(np.abs(got["buffers"][k] - w) - BARS["stats_rel"] * np.abs(w)))
                 for k, w in want["buffers"].items() if "running_" in k), default=0.0)
    # one pass over each gradient tensor: its largest error and entry, and
    # the squared sums of the per-net L2 distance
    per = {}
    for k, w in want["grads"].items():
        d = (got["grads"][k] - w).ravel()
        wf = w.ravel()
        per[k] = (float(np.abs(d).max()), float(np.abs(wf).max()),
                  float(np.dot(d, d)), float(np.dot(wf, wf)))
    net_max: Dict[str, float] = {}
    for k, (_, top, _, _) in per.items():
        net_max[_net(k)] = max(net_max.get(_net(k), 0.0), top)
    share, zero = {}, {}
    for k, (err, top, _, _) in per.items():
        if top >= BARS["live"] * net_max[_net(k)] and k not in want["zero"]:
            share[k] = err / top
        else:
            zero[k] = err / max(net_max[_net(k)], 1e-30)
    nets = {}
    for n in net_max:
        keys = [k for k in per if _net(k) == n]
        diff, norm = sum(per[k][2] for k in keys), sum(per[k][3] for k in keys)
        nets[n] = {"l2": (diff / max(norm, 1e-30)) ** 0.5,
                   "median": float(np.median([share[k] for k in keys if k in share] or [0.0]))}
    params = {}
    for k, w in want["params"].items():
        err = np.abs(got["params"][k] - w)
        if k not in want["grads"] or k in zero:  # no gradient decides the step
            params[k] = (0.0, float(err.max()))
            continue
        g = np.abs(want["grads"][k])
        decided = g >= max(BARS["decided"] * per[k][1], BARS["decided_abs"])
        params[k] = (float(err[decided].max(initial=0.0)), float(err.max()))
    return {"terms": terms, "stats_excess": stats, "grad_share": share, "grad_zero": zero,
            "nets": nets, "params": params, "lr": want["lr"],
            "same_keys": (set(got["grads"]) == set(want["grads"])
                          and set(got["params"]) == set(want["params"])),
            "ranks_equal": got["ranks_equal"]}


def failures(c: dict, bn_eval: bool) -> Dict[str, dict]:
    """What of a ``compare`` result lies outside BARS, by aspect (empty
    when all holds). ``bn_eval``: the tight gradient and parameter bars;
    else the batch-statistics bars (the module docstring)."""
    out = {
        "ranks": {} if c["same_keys"] and c["ranks_equal"] else {"ranks differ": True},
        "loss terms": {k: v for k, v in c["terms"].items() if v > BARS["loss_rel"]},
        "running statistics": ({} if c["stats_excess"] <= BARS["stats_abs"]
                               else {"excess": c["stats_excess"]}),
    }
    share, zero = ((BARS["grad_share"], BARS["grad_zero"]) if bn_eval
                   else (BARS["train_grad_share"], BARS["train_grad_zero"]))
    bad = {k: v for k, v in c["grad_share"].items() if v > share}
    bad.update({k: v for k, v in c["grad_zero"].items() if v > zero})
    if not bn_eval:
        bad.update({n: v for n, v in c["nets"].items()
                    if v["median"] > BARS["train_grad_median"] or v["l2"] > BARS["train_grad_l2"]})
    out["gradients"] = bad
    decided = BARS["param_abs"] if bn_eval else float("inf")
    out["parameters"] = {k: v for k, v in c["params"].items()
                         if v[0] > decided or v[1] > 2 * c["lr"]}
    return out
