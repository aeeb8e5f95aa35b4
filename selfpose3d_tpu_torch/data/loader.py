"""Host input pipeline: collate view items into AugBranch batches, with a
threaded prefetch loader (ref: tools/train_3d.py:105-111, a torch
DataLoader with default_collate).

Worker threads build numpy / CPU-tensor batches only (pinned when the
consumer will copy them to a CUDA device); the consumer thread moves a
batch to its device (``AugBranch.to(device, non_blocking=True)``).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Sequence

import numpy as np
import torch

from selfpose3d_tpu_torch.data.structures import AugBranch
from selfpose3d_tpu_torch.geometry.cameras import CameraParams


def collate_branch(view_items_per_sample: Sequence[Sequence[dict]], pin_memory: bool = False) -> AugBranch:
    """Stack per-sample, per-view item dicts into one AugBranch of CPU
    tensors (page-locked with ``pin_memory``, which needs CUDA).

    Args:
      view_items_per_sample: [sample][view] -> dict from a dataset's
        ``_build_view`` (keys: image, target_2d, weights_2d, target_3d,
        trans, orig_wh, camera, joints, joints_vis, joints_3d,
        joints_3d_vis, roots_3d, num_person, hflip, optional
        input_heatmap).
    """
    B = len(view_items_per_sample)
    V = len(view_items_per_sample[0])

    def t(x):
        if x is None:
            return None
        x = torch.from_numpy(np.ascontiguousarray(x))
        return x.pin_memory() if pin_memory else x

    def stack(key, per_view=True):
        if view_items_per_sample[0][0].get(key) is None:
            return None
        if per_view:
            return t(np.stack(
                [np.stack([s[v][key] for v in range(V)]) for s in view_items_per_sample]
            ))
        return t(np.stack([s[0][key] for s in view_items_per_sample]))

    cams = {
        field: np.stack([
            np.stack([np.asarray(s[v]["camera"][field], np.float32) for v in range(V)])
            for s in view_items_per_sample
        ])
        for field in ("R", "T", "fx", "fy", "cx", "cy", "k", "p")
    }
    cam = CameraParams(
        R=t(cams["R"].reshape(B, V, 3, 3)),
        T=t(cams["T"].reshape(B, V, 3, 1)),
        f=t(np.stack([cams["fx"].reshape(B, V), cams["fy"].reshape(B, V)], -1)),
        c=t(np.stack([cams["cx"].reshape(B, V), cams["cy"].reshape(B, V)], -1)),
        k=t(cams["k"].reshape(B, V, 3)),
        p=t(cams["p"].reshape(B, V, 2)),
    )
    return AugBranch(
        cam=cam,
        trans=stack("trans"),
        orig_wh=stack("orig_wh"),
        hflip=t(np.array([bool(s[0].get("hflip", False)) for s in view_items_per_sample])),
        views=stack("image"),
        input_heatmaps=stack("input_heatmap"),
        target_2d=stack("target_2d"),
        weights_2d=stack("weights_2d"),
        target_3d=stack("target_3d", per_view=False),
        joints=stack("joints"),
        joints_vis=stack("joints_vis"),
        joints_3d=stack("joints_3d", per_view=False),
        joints_3d_vis=stack("joints_3d_vis", per_view=False),
        roots_3d=stack("roots_3d", per_view=False),
        num_person=t(np.array([s[0]["num_person"] for s in view_items_per_sample], np.int32)),
    )


class PrefetchLoader:
    """Threaded batch loader with bounded prefetch.

    ``make_batch(indices) -> batch`` runs in worker threads; batches come
    out in submission order, and an exception raised by ``make_batch``
    is raised to the consumer at its batch. With ``shuffle`` the order of
    epoch e (the e-th iteration) is ``RandomState(seed + e)``'s
    permutation. With ``process_count > 1`` every process draws the same
    order and keeps its ``process_index``-th stripe, so data-parallel
    processes consume disjoint data; ``batch_size`` is the per-process
    batch.
    """

    def __init__(
        self,
        num_samples: int,
        batch_size: int,
        make_batch: Callable[[List[int]], object],
        shuffle: bool = False,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        drop_last: bool = False,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.make_batch = make_batch
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self._epoch = 0

    @property
    def _local_samples(self) -> int:
        n, r = divmod(self.num_samples, self.process_count)
        return n + (1 if self.process_index < r else 0)

    def __len__(self):
        if self.drop_last:
            return self._local_samples // self.batch_size
        return (self._local_samples + self.batch_size - 1) // self.batch_size

    def batches(self) -> List[List[int]]:
        """This iteration's index lists (advances the epoch)."""
        order = np.arange(self.num_samples)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        order = order[self.process_index :: self.process_count]
        self._epoch += 1
        batches = [
            order[i : i + self.batch_size].tolist()
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator:
        batches = self.batches()
        results = {}
        emit_cv = threading.Condition()
        # bounds how far the workers run ahead of the consumer
        slots = threading.Semaphore(self.prefetch + self.num_workers)
        task_q: "queue.Queue" = queue.Queue()
        for bi, idxs in enumerate(batches):
            task_q.put((bi, idxs))

        def worker():
            while True:
                slots.acquire()
                try:
                    bi, idxs = task_q.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                try:
                    batch = self.make_batch(idxs)
                except Exception as e:  # surfaced to the consumer at its batch
                    batch = e
                with emit_cv:
                    results[bi] = batch
                    emit_cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for th in threads:
            th.start()
        try:
            for bi in range(len(batches)):
                with emit_cv:
                    while bi not in results:
                        emit_cv.wait(timeout=1.0)
                    batch = results.pop(bi)
                slots.release()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            # a consumer that stops early (or an error) ends the workers
            # after their current batch
            while True:
                try:
                    task_q.get_nowait()
                except queue.Empty:
                    break
            for _ in threads:
                slots.release()
