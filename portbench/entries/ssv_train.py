"""SSV training entry: one train step of ``make_ssv_train_step`` (three
augmentation branches, forward, backward, Adam) per call, on batches
prebuilt in pinned memory, at the PoseNet and L1 stage of the schedule.

Set-up builds the train state once and drives it through its first
``compare.STEPS`` steps on distinct pool items through the same call the
window times; the check compares those steps (each step's loss terms, the
first gradient as Adam's first moment holds it, each trained leaf's change
over the steps and each running statistic's change in the first step) and
one step of the window, drawn from the seed among its first
``trace_calls``: its state is copied before it, and its gradient is read
from Adam's first moment before and after it, so that the reference
recomputes that step from the program's own state.
"""

from __future__ import annotations

import random

import torch

from portbench.core import compare, feed, flops, scene
from portbench.reference.model import Reference, adam_step, param_spec

ROTATIONS = (15.0, -10.0, 0.0)
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
# steps per epoch of the schedule: the window never reaches a LR milestone
STEPS_PER_EPOCH = 1 << 30


def trained(cfg, name: str) -> bool:
    """Whether the parameter ``name`` trains in this stage (a frozen RootNet,
    the backbone as TRAIN_BACKBONE says)."""
    if name.rsplit(".", 1)[-1] in BUFFERS:
        return False
    if name.startswith("root_net."):
        return not cfg.freeze_rootnet
    if name.startswith("backbone."):
        return cfg.train_backbone
    return True


class Program:
    def __init__(self, ctx):
        from selfpose3d_tpu_torch.models import get_model
        from selfpose3d_tpu_torch.train import create_train_state, make_ssv_train_step

        self.ctx, self.cfg, dev = ctx, ctx.ref_cfg, ctx.device
        self.batch = ctx.traffic["batch"]
        self.P = scene.seeded_weights(param_spec(self.cfg), ctx.seed, dev)
        self.model = get_model(ctx.prog_cfg, device=dev)
        self.model.load_state_dict(self.P)
        self.state = create_train_state(ctx.prog_cfg, self.model, steps_per_epoch=STEPS_PER_EPOCH)
        self.step = make_ssv_train_step(self.model, train_posenet_stage=True, use_l1_stage=True)
        self.pool = feed.make_pool(self.cfg, ctx.traffic, ctx.seed, dev, ROTATIONS)
        self.record = {"losses": [], "centres": []}
        self.window_at = compare.STEPS + random.Random(ctx.seed).randrange(ctx.traffic["trace_calls"])
        self.window_step = None
        # the proposals each checked step hands PoseNet (RootNet's output), for
        # the reference to follow; the hook is gone before the window
        hook = self.model.root_net.register_forward_hook(
            lambda mod, args, out: self.record["centres"].append(out[1].detach().clone()))
        for i in range(compare.STEPS):
            self.record["losses"].append(self.call(i, keep=True))
            if i == 0:
                self.record["grad1"] = self._first_grad()
                self.record["stats"] = {k: (v.detach().float() - self.P[k]).clone()
                                        for k, v in self.model.named_buffers() if "running_" in k}
        hook.remove()
        named = dict(self.model.named_parameters())
        self.record["delta"] = {k: (named[k].detach() - self.P[k]).clone()
                                for k in named if trained(self.cfg, k)}

    def _first_grad(self):
        """The first step's gradient of every trained leaf, from Adam's first
        moment after one step (m = (1 - beta1) g)."""
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        out = {}
        for k, p in self.model.named_parameters():
            st = self.state.optimizer.state.get(p)
            if st and "exp_avg" in st:
                out[k] = (st["exp_avg"] / (1 - beta1)).clone()
        return out

    def _moments(self):
        """Adam's first moment of every trained leaf that has one, copied."""
        out = {}
        for k, p in self.model.named_parameters():
            st = self.state.optimizer.state.get(p)
            if st and "exp_avg" in st:
                out[k] = st["exp_avg"].detach().clone()
        return out

    def call(self, i: int, keep: bool = False):
        snap = i == self.window_at
        if snap:  # the state the window's compared step starts from
            before = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            m_before = self._moments()
            centres = []
            hook = self.model.root_net.register_forward_hook(
                lambda mod, args, out: centres.append(out[1].detach().clone()))
        branches = [feed.aug_branch(feed.to_device(b, self.ctx.device))
                    for b in self.pool[i % len(self.pool)]]
        metrics = self.step(self.state, *branches)
        loss = float(metrics["loss"])  # the host reads the step's loss, as a train loop logs it
        if snap:
            hook.remove()
            self.window_step = {"index": i, "state": before, "m_before": m_before,
                                "m_after": self._moments(), "centres": centres[0]}
        if keep:
            return {k: float(v) for k, v in metrics.items() if k != "loss"}
        return loss

    @property
    def items_per_call(self) -> int:
        return self.batch

    def flops_per_call(self) -> int:
        return flops.ssv_train_flops(self.cfg, self.batch)

    def sampler_bytes_per_call(self) -> int:
        return flops.ssv_train_sampler_bytes(self.cfg, self.batch)

    def release(self) -> None:
        self.beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        del self.model, self.state, self.step

    def window_grads(self, fp8: bool = False) -> dict:
        """The reference's gradient of the window's compared step, from the
        program's state before it and on the same rows, following the
        proposals that step handed PoseNet: {"all": name -> gradient of the
        summed losses, "2d": backbone name -> gradient of loss_2d alone}."""
        ws = self.window_step
        P = {k: v.float().clone().requires_grad_(trained(self.cfg, k)) if v.is_floating_point()
             else v.clone() for k, v in ws["state"].items()}
        leaves = [k for k in P if P[k].requires_grad]
        branches = [feed.to_device(b, self.ctx.device) for b in self.pool[ws["index"] % len(self.pool)]]
        losses = Reference(self.cfg, P, fp8=fp8).ssv_losses(*branches, centres=ws["centres"])
        g_all = torch.autograd.grad(sum(losses.values()), [P[k] for k in leaves],
                                    retain_graph=True, allow_unused=True)
        bb = [k for k in leaves if k.startswith("backbone.")]
        g_2d = torch.autograd.grad(losses["loss_2d"], [P[k] for k in bb], allow_unused=True)

        def named(keys, gs):
            return {k: (g.detach() if g is not None else torch.zeros_like(P[k]))
                    for k, g in zip(keys, gs)}

        return {"all": named(leaves, g_all), "2d": named(bb, g_2d)}

    def program_window_grad(self) -> dict:
        """The compared step's gradient as the program's Adam took it:
        (m_after - beta1 m_before) / (1 - beta1); a leaf without a first
        moment before the step starts from zero."""
        ws, b1 = self.window_step, self.beta1
        return {k: (m - b1 * ws["m_before"].get(k, torch.zeros_like(m))) / (1 - b1)
                for k, m in ws["m_after"].items()}

    def reference_run(self, fp8: bool = False, follow=None) -> dict:
        """The reference's own first steps from the same weights and rows,
        following the proposals ``follow`` (one (B, K, 5) a step) where
        given, its own otherwise; ``root_gap`` of the first step's followed
        proposals against its own volume, ``centres`` the proposals it used."""
        P = {k: v.clone().requires_grad_(trained(self.cfg, k)) for k, v in self.P.items()}
        leaves = [k for k in P if P[k].requires_grad]
        out = {"losses": [], "centres": []}
        adam = {}
        for t in range(compare.STEPS):
            branches = [feed.to_device(b, self.ctx.device) for b in self.pool[t % len(self.pool)]]
            ref = Reference(self.cfg, P, fp8=fp8)
            losses = ref.ssv_losses(*branches, centres=None if follow is None else follow[t])
            used = ref.root["centres"] if follow is None else follow[t]
            out["centres"].append(used)
            if t == 0:  # later steps' proposals come from weights Adam's sign noise has moved
                out["root_gap"] = compare.root_gap(self.cfg, used, None, ref.root["volume"],
                                                   ref.root["top"])
            grads = torch.autograd.grad(sum(losses.values()), [P[k] for k in leaves],
                                        allow_unused=True)
            grads = {k: (g.detach() if g is not None else torch.zeros_like(P[k]))
                     for k, g in zip(leaves, grads)}
            if t == 0:
                out["grad1"] = {k: g.clone() for k, g in grads.items()}
            with torch.no_grad():
                adam_step({k: P[k] for k in leaves}, grads, adam, self.cfg.lr, t + 1)
                for k, v in ref.stats.items():
                    P[k].copy_(v)
            if t == 0:
                out["stats"] = {k: (v - self.P[k]) for k, v in ref.stats.items()}
            out["losses"].append({k: float(v.detach()) for k, v in losses.items()})
            del ref, losses, grads
        out["delta"] = {k: (P[k].detach() - self.P[k]) for k in leaves}
        return out

    def check(self, kept):
        numbers = compare.train_numbers(self.record, self.reference_run(follow=self.record["centres"]))
        numbers.update(self.window_numbers())
        return numbers

    def window_numbers(self, grad=None) -> dict:
        """The window step's numbers: the program's gradient (or ``grad``, the
        control's) against the reference's; infinite where the window never
        reached the step."""
        if self.window_step is None:
            return dict.fromkeys(compare.WINDOW_NUMBERS, float("inf"))
        return compare.window_numbers(grad or self.program_window_grad(), self.window_grads())
