"""Train and validation loops: datasets, the loader, the train steps and
metric logging (ref: lib/core/function.py:27-508, the epoch orchestration
of tools/train_3d.py:78-236).

The model lies on its device; each loop reads it from the model's
parameters. Loader workers build CPU batches (pinned for a CUDA model);
the loop copies each to the device with ``non_blocking=True``. The stage
gates and the host bucket dispatch read only host values: ``epoch`` and
the host batch's ``num_person``.

Across ranks (``parallel/mesh.py``, the counterpart of
``selfpose3d_tpu/train/loop.py``'s mesh paths) the trainers take the model
``train.step.distribute`` wraps; every rank reads its stripe of each
epoch's order, the bucket dispatch agrees on the largest person count of
all ranks, the logged metrics are the means over ranks, and validation
gathers every rank's predictions before ``dataset.evaluate`` runs on the
full set. Logging and the debug dumps are rank 0's.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from selfpose3d_tpu_torch.config import Config
from selfpose3d_tpu_torch.data.loader import PrefetchLoader, collate_branch
from selfpose3d_tpu_torch.ops import slicewarp
from selfpose3d_tpu_torch.parallel import mesh
from selfpose3d_tpu_torch.train.step import (
    inner_model,
    make_inference_step,
    make_ssv_debug_forward,
    make_ssv_train_step,
    make_supervised_train_step,
)
from selfpose3d_tpu_torch.train.train_state import TrainState
from selfpose3d_tpu_torch.utils import spans
from selfpose3d_tpu_torch.utils.meters import AverageMeter
from selfpose3d_tpu_torch.utils.vis import save_debug_images

logger = logging.getLogger(__name__)


def _waited(loader, wait: spans.meter):
    """The loader's batches, each fetched inside ``wait`` (the span
    ``sp3d.loader_wait``; ``wait.seconds`` is the last fetch's wait)."""
    batches = iter(loader)
    while True:
        with wait:
            batch = next(batches, None)
        if batch is None:
            return
        yield batch


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The sampler kernels' launches since ``before``, a copy of
    ``slicewarp.LAUNCHES`` (zero on the CPU, where no kernel launches)."""
    return {k: slicewarp.LAUNCHES[k] - n for k, n in before.items()}


def _syncs_since(before: Dict[str, int]) -> Dict[str, int]:
    """The changes of the counters ``host_syncs.<site>`` since ``before``, a
    copy of ``spans.counters()``: every wait for the device, in a call or in
    the loop around it."""
    return {k: v - before.get(k, 0) for k, v in spans.counters().items()
            if k.startswith("host_syncs.") and v != before.get(k, 0)}


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _info(msg: str, *args) -> None:
    """Log on rank 0 only."""
    if mesh.rank() == 0:
        logger.info(msg, *args)


def _loader(num_samples: int, batch: int, make_batch, **kw) -> PrefetchLoader:
    """The loader of this rank's stripe (every rank the same order)."""
    return PrefetchLoader(num_samples, mesh.local_batch_size(batch), make_batch,
                          process_index=mesh.rank(), process_count=mesh.world(), **kw)


def dispatch_buckets(cfg: Config, posenet_stage: bool) -> Tuple[int, ...]:
    """The PoseNet candidate caps of the host bucket dispatch
    (TRAIN.BUCKET_DISPATCH 'meta' in the PoseNet stage): the
    CANDIDATE_BUCKETS below MAX_PEOPLE_NUM, then MAX_PEOPLE_NUM; empty
    when the dispatch is off."""
    K_max = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
    if not (cfg.TRAIN.BUCKET_DISPATCH == "meta" and posenet_stage
            and cfg.MULTI_PERSON.CANDIDATE_BUCKETS):
        return ()
    return tuple(b for b in cfg.MULTI_PERSON.CANDIDATE_BUCKETS if b < K_max) + (K_max,)


def pick_k_cap(buckets: Tuple[int, ...], num_person: torch.Tensor, K_max: int) -> Optional[int]:
    """The smallest bucket holding the batch's largest person count plus
    one, from the host tensor ``num_person``; None for no cap. Every rank
    decides on the largest count of all ranks, so all run one cap
    (``selfpose3d_tpu/train/loop.py:77-86``)."""
    if not buckets:
        return None
    need = mesh.agree_max(min(int(num_person.max()) + 1, K_max))
    k = next(b for b in buckets if b >= need)
    return None if k == K_max else k


class _Profile:
    """``SP3D_PROFILE=dir``: a ``torch.profiler`` trace of steps [2, 2 +
    SP3D_PROFILE_STEPS) of epoch 0, written to ``dir/trace.json``, and the
    summary of the port's spans recorded over them (``utils/spans.py``) to
    ``dir/spans.json`` (rank 0's)."""

    def __init__(self, epoch: int, dev: torch.device):
        self.dir = os.environ.get("SP3D_PROFILE", "") if epoch == 0 and mesh.rank() == 0 else ""
        self.steps = max(1, int(os.environ.get("SP3D_PROFILE_STEPS", "3")))
        self.dev = dev
        self.prof = None

    def at(self, i: int) -> None:
        if self.dir and i == 2:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            spans.reset()
            self.prof.start()
        if self.prof is not None and i == 2 + self.steps:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        with open(os.path.join(self.dir, "spans.json"), "w") as f:
            json.dump(spans.summary(), f, indent=1)
        logger.info("wrote the profile of %d steps to %s", self.steps, self.dir)
        self.prof = None


def _run_epoch(cfg: Config, state: TrainState, loader: PrefetchLoader, epoch: int,
               run_step: Callable, writer, meters_out: Optional[dict]) -> TrainState:
    """The epoch loop shared by both trainers: ``run_step(i, batch)`` moves
    the i-th host batch to the device and takes one step -> metrics. Meters and
    logging every PRINT_FREQ steps (a synchronising read of the metrics).
    ``meters_out`` receives the meters, the steps, the wall seconds, the
    sampler kernels' launches and the host syncs of the epoch."""
    dev = _device(state.model)
    meters: Dict[str, AverageMeter] = {}
    batch_time, data_time = AverageMeter(), AverageMeter()
    prof = _Profile(epoch, dev)
    launched, synced = dict(slicewarp.LAUNCHES), spans.counters()
    wait = spans.meter("sp3d.loader_wait")
    t0 = end = time.time()
    steps = 0
    for i, batch in enumerate(_waited(loader, wait)):
        data_time.update(wait.seconds)
        prof.at(i)
        metrics = run_step(i, batch)
        steps += 1
        if i % cfg.PRINT_FREQ == 0:
            names = list(metrics)
            spans.count("host_syncs.log_read")
            values = mesh.mean_over_ranks(torch.stack([metrics[k].float() for k in names])).tolist()
            batch_time.update(time.time() - end)
            for k, v in zip(names, values):
                meters.setdefault(k, AverageMeter()).update(v)
            speed = cfg.TRAIN.BATCH_SIZE / max(batch_time.val, 1e-9)
            _info(
                f"Epoch: [{epoch}][{i}/{len(loader)}] "
                f"Time: {batch_time.val:.3f}s ({batch_time.avg:.3f}s) "
                f"Speed: {speed:.1f} samples/s "
                f"Data: {data_time.val:.3f}s ({data_time.avg:.3f}s) "
                + " ".join(f"{k}: {m.val:.6f} ({m.avg:.6f})" for k, m in meters.items())
            )
            if writer is not None:
                for k, m in meters.items():
                    writer.add_scalar(f"train/{k}", m.val, state.step)
        end = time.time()
    prof.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if meters_out is not None:
        meters_out.update(
            steps=steps, seconds=time.time() - t0, data_time=data_time, batch_time=batch_time,
            launches=_launches_since(launched), host_syncs=_syncs_since(synced), **meters,
        )
    return state


def train_epoch_ssv(
    cfg: Config,
    model,
    state: TrainState,
    dataset,
    epoch: int,
    writer=None,
    load_images: bool = True,
    output_dir: str = "",
    meters_out: Optional[dict] = None,
) -> TrainState:
    """One SSV training epoch (ref: function.py:27-217), in place on
    ``state``; ``model`` is the SSV model or its ``distribute`` wrapper.
    The synthetic-root draws come from a CPU ``torch.Generator``
    seeded with ``epoch``. ``meters_out`` receives
    the epoch's meters (data_time, batch_time, each metric), its steps, wall
    seconds and sampler launches. With ``cfg.DEBUG.DEBUG`` and an
    ``output_dir``, every PRINT_FREQ-th step re-runs the prediction-bearing
    forward on its batch (``make_ssv_debug_forward``) and writes
    ``utils/vis.save_debug_images`` under ``output_dir/debug/train_{epoch}_{i}``
    (ref: function.py:176-217); ``meters_out`` then also receives the dumps'
    count, host seconds (the forward and the writing, which reads the
    forward's results back) and sampler launches, which are among the
    epoch's (``debug_dumps``, ``debug_seconds``, ``debug_launches``)."""
    dev = _device(model)
    posenet_stage = epoch >= cfg.NETWORK.INIT_TRAIN_EPOCHS_ROOTNET
    l1_stage = epoch >= cfg.TRAIN.L1_EPOCH
    buckets = dispatch_buckets(cfg, posenet_stage)
    K_max = cfg.MULTI_PERSON.MAX_PEOPLE_NUM
    steps: Dict[Optional[int], Callable] = {}
    generator = torch.Generator().manual_seed(epoch)
    pin = dev.type == "cuda"

    def make_batch(idxs):
        frames = [dataset.get_ssv_frame(i, seed=epoch, load_images=load_images) for i in idxs]
        return tuple(collate_branch([f[k] for f in frames], pin_memory=pin) for k in range(3))

    debug_fwd = (make_ssv_debug_forward(inner_model(model), posenet_stage, l1_stage)
                 if cfg.DEBUG.DEBUG and output_dir and mesh.rank() == 0 else None)
    debug = {"debug_dumps": 0, "debug_seconds": 0.0,
             "debug_launches": dict.fromkeys(slicewarp.LAUNCHES, 0)}
    dump = spans.meter("sp3d.debug_dump")

    def run_step(i, batch):
        k_cap = pick_k_cap(buckets, batch[2].num_person, K_max)
        if k_cap not in steps:
            steps[k_cap] = make_ssv_train_step(
                model, train_posenet_stage=posenet_stage, use_l1_stage=l1_stage, k_cap=k_cap)
        b1, b2, b3 = (b.to(dev, non_blocking=True) for b in batch)
        metrics = steps[k_cap](state, b1, b2, b3, generator=generator)
        if debug_fwd is not None and i % cfg.PRINT_FREQ == 0:
            launched = dict(slicewarp.LAUNCHES)
            with dump:
                pred2, hm3, gc = debug_fwd(b1, b2, b3)
                save_debug_images(cfg, b3, hm3, pred2, gc,
                                  os.path.join(output_dir, "debug", f"train_{epoch}_{i}"))
            debug["debug_dumps"] += 1
            debug["debug_seconds"] += dump.seconds
            for k, n in _launches_since(launched).items():
                debug["debug_launches"][k] += n
        return metrics

    loader = _loader(len(dataset), cfg.TRAIN.BATCH_SIZE, make_batch, shuffle=cfg.TRAIN.SHUFFLE,
                     num_workers=cfg.WORKERS, seed=epoch, drop_last=True)
    state = _run_epoch(cfg, state, loader, epoch, run_step, writer, meters_out)
    if meters_out is not None and debug_fwd is not None:
        meters_out.update(debug)
    return state


def train_epoch_supervised(
    cfg: Config,
    model,
    state: TrainState,
    dataset,
    epoch: int,
    writer=None,
    load_images: bool = True,
    meters_out: Optional[dict] = None,
) -> TrainState:
    """One supervised (VoxelPose baseline) epoch (ref: function.py:219-350),
    in place on ``state``; frames drawn with seed ``epoch``. ``model`` is
    the model or its ``distribute`` wrapper."""
    dev = _device(model)
    step_fn = make_supervised_train_step(model)
    pin = dev.type == "cuda"

    def make_batch(idxs):
        frames = [dataset.get_frame(i, load_images=load_images, seed=epoch) for i in idxs]
        return collate_branch([f["views"] for f in frames], pin_memory=pin)

    def run_step(i, branch):
        return step_fn(state, branch.to(dev, non_blocking=True))

    loader = _loader(len(dataset), cfg.TRAIN.BATCH_SIZE, make_batch, shuffle=cfg.TRAIN.SHUFFLE,
                     num_workers=cfg.WORKERS, seed=epoch, drop_last=True)
    return _run_epoch(cfg, state, loader, epoch, run_step, writer, meters_out)


def validate_3d(
    cfg: Config,
    model,
    dataset,
    output_dir: str = "",
    load_images: bool = True,
    metrics_out: Optional[dict] = None,
) -> Optional[float]:
    """Validation pass + ``dataset.evaluate`` (ref: function.py:352-490).
    The model (or the one inside a ``distribute`` wrapper) runs in eval
    mode without autograd, and every module's mode is restored afterwards;
    the last batch is padded to the full TEST.BATCH_SIZE and trimmed;
    predictions are sorted by frame index. Across ranks each rank infers
    its stripe of the frames, pads its rows to the longest stripe's count
    (an empty stripe when there are fewer frames than ranks), and every
    rank gathers all of them (``selfpose3d_tpu/train/loop.py:262-310``).
    ``metrics_out`` receives the whole report, and the sampler kernels'
    launches (``launches``) and the host syncs (``host_syncs``) of this
    rank's pass, the gather included.

    Returns the model-selection metric: the mean AP over the thresholds
    (the PCP under the Shelf/Campus protocol), or None.
    """
    model = inner_model(model)
    dev = _device(model)
    batch = cfg.TEST.BATCH_SIZE
    pin = dev.type == "cuda"
    if hasattr(model, "do_inference"):
        infer = make_inference_step(model)
    else:  # the supervised baseline's forward
        def infer(branch):
            return model(branch, train=False)[:3]

    def make_batch(idxs):
        views = [dataset.get_frame(i, load_images=load_images)["views"] for i in idxs]
        while len(views) < batch:  # pad the last batch to a full shape
            views.append(views[-1])
        return collate_branch(views, pin_memory=pin), list(idxs)

    loader = _loader(len(dataset), batch, make_batch, shuffle=False, num_workers=cfg.WORKERS)
    modes = {m: m.training for m in model.modules()}
    launched, synced = dict(slicewarp.LAUNCHES), spans.counters()
    idx_list, pred_list, root_list = [], [], []
    try:
        model.eval()
        with torch.no_grad():
            for branch, idxs in _waited(loader, spans.meter("sp3d.loader_wait")):
                pred, _, gc = infer(branch.to(dev, non_blocking=True))
                n = len(idxs)
                idx_list.extend(idxs)
                spans.count("host_syncs.validate_read", 2)
                pred_list.append(pred[:n].float().cpu().numpy())
                root_list.append(gc[:n].float().cpu().numpy())
    finally:
        for m, training in modes.items():
            m.train(training)

    idx = np.asarray(idx_list, np.int64)
    preds = np.concatenate(pred_list) if pred_list else np.zeros((0,))
    roots = np.concatenate(root_list) if root_list else np.zeros((0,))
    if mesh.world() > 1:
        # fixed-shape rows for the gather; padding rows carry index -1
        K, J = cfg.MULTI_PERSON.MAX_PEOPLE_NUM, cfg.NETWORK.NUM_JOINTS
        if not pred_list:
            preds, roots = np.zeros((0, K, J, 5), np.float32), np.zeros((0, K, 5), np.float32)
        pad = -(-len(dataset) // mesh.world()) - len(idx)
        idx = np.concatenate([idx, np.full(pad, -1, np.int64)])
        preds = np.concatenate([preds, np.zeros((pad,) + preds.shape[1:], preds.dtype)])
        roots = np.concatenate([roots, np.zeros((pad,) + roots.shape[1:], roots.dtype)])
        idx, preds, roots = mesh.process_allgather_tree((idx, preds, roots))
        keep = idx >= 0
        idx, preds, roots = idx[keep], preds[keep], roots[keep]
    order = np.argsort(idx, kind="stable")
    metrics = dataset.evaluate([preds[i] for i in order], [roots[i] for i in order], output_dir)
    if metrics_out is not None:
        metrics_out.update(metrics, launches=_launches_since(launched),
                           host_syncs=_syncs_since(synced))
    if metrics.get("aps") is None:
        if "avg_pcp" in metrics:  # Shelf/Campus PCP protocol (ref: :477-487)
            _info(
                "actor PCP: %s | avg PCP: %.4f | recall@500: %.4f",
                np.round(metrics["actor_pcp"], 4).tolist(),
                metrics["avg_pcp"], metrics["recall500"],
            )
            return float(metrics["avg_pcp"])
        return None
    msg = (
        "AP@25..150: " + " ".join(f"{a*100:.2f}" for a in metrics["aps"])
        + f" | MPJPE@500: {metrics['mpjpe']:.2f}mm"
        + f" | recall@500: {metrics['recall500']*100:.2f}"
    )
    if "aps_root" in metrics:
        msg += (
            " || root AP@25..150: " + " ".join(f"{a*100:.2f}" for a in metrics["aps_root"])
            + f" | root MPJPE: {metrics['mpjpe_root']:.2f}mm"
        )
    _info(msg)
    return float(np.mean(metrics["aps"]))
