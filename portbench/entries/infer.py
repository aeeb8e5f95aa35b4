"""Inference entry: a batch of frame sets in, poses out on the host.

The SSV model's ``do_inference`` (``MultiPersonPoseNetSSV``), or the
supervised model's ``forward(branch, train=False)`` under ``no_grad`` as the
program's validation loop calls it (``MultiPersonPoseNet``). One call
copies the batch's inputs to the device ``non_blocking`` from pinned
memory, runs the entry, and copies the poses and proposals to the host,
which waits for the device.
"""

from __future__ import annotations

import torch

from portbench.core import compare, feed, flops, scene
from portbench.reference.model import Reference, param_spec

INPUTS = ("cam", "trans", "orig_wh", "hflip", "views")


class Program:
    def __init__(self, ctx):
        from selfpose3d_tpu_torch.models import get_model

        self.ctx, self.cfg, dev = ctx, ctx.ref_cfg, ctx.device
        self.batch = ctx.traffic["batch"]
        self.P = scene.seeded_weights(param_spec(self.cfg), ctx.seed, dev)
        self.model = get_model(ctx.prog_cfg, device=dev)
        self.model.load_state_dict(self.P)
        self.ssv = hasattr(self.model, "do_inference")
        self.pool = [items[0] for items in feed.make_pool(self.cfg, ctx.traffic, ctx.seed, dev)]
        for i in range(ctx.traffic.get("warmup_calls", 2)):
            self.call(i)

    def call(self, i: int):
        d = feed.to_device(self.pool[i % len(self.pool)], self.ctx.device, INPUTS)
        branch = feed.aug_branch(d)
        with torch.no_grad():
            if self.ssv:
                pred, hm, gc = self.model.do_inference(branch)
            else:
                pred, hm, gc, _ = self.model(branch, train=False)
        pred.to("cpu")
        gc.to("cpu")
        return i, pred, hm, gc

    @property
    def items_per_call(self) -> int:
        return self.batch

    def flops_per_call(self) -> int:
        return flops.infer_flops(self.cfg, self.batch)

    def sampler_bytes_per_call(self) -> int:
        return flops.infer_sampler_bytes(self.cfg, self.batch)

    def release(self) -> None:
        del self.model

    def check(self, kept):
        """The worst of the kept calls' numbers against the reference."""
        ref = Reference(self.cfg, self.P)
        rows = []
        for i, pred, hm, gc in kept:
            batch = feed.to_device(self.pool[i % len(self.pool)], self.ctx.device, INPUTS)
            rows.append(compare.infer_numbers(ref, batch, pred, hm, gc))
        return compare.worst(rows)

    def control(self, i: int, fp8: bool = True):
        """The reference put in the program's place (``fp8`` rounding) on
        call ``i``'s inputs: (i, pred, hm, gc) as ``call`` returns them."""
        batch = feed.to_device(self.pool[i % len(self.pool)], self.ctx.device, INPUTS)
        pred, hm, gc = Reference(self.cfg, self.P, fp8=fp8).infer(batch)
        return i, pred, hm, gc
