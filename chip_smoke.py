#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. card     nvidia-smi name and power limit, the highest SM clock (the
              shared-memory load rate of the bounds), torch/CUDA versions,
              and the build of every CUDA kernel from csrc/ (one nvcc per source,
              all started together), with the registers, static shared
              memory and spills of the redesigned kernels (REDESIGNED);
  2. main     flagship do_inference (ResNet-50, 5 x 960x512 views, 80x80x20
              root grid, 64^3 pose cubes, bf16, batch 8, random weights from
              a seed) on the synthetic scene: shapes, finite outputs, and
              every kernel's launch count during that one call;
  3. geometry the RootNet unprojection of rendered heatmaps lights the voxel
              nearest every person's root (> 0.5) and equals the CPU's plain
              version;
  4. parity   a small float32 model gives the same proposals and poses on
              the card as on the CPU;
  5. train    three SSV train steps (after one warm-up step) of the same
              flagship config at batch 1, every candidate kept valid
              (THRESHOLD = -100), Adam, three synthetic augmentation
              branches: six finite loss terms, every kernel's launch count
              per step, parameters and BatchNorm statistics that moved;
  6. train_parity  the train-stage losses and their gradients of a small
              float32 model on the card against the CPU, same weights and
              injected synthetic-root draws: with BatchNorm on its running
              statistics the losses and every parameter's gradient are
              held, with batch statistics the losses;
  7. supervised  the supervised baseline (configs/panoptic/resnet50/
              prn64_cpn80x80x20_960x512_cam5.yaml, MODEL multi_person_posenet)
              at full width: ResNet-50, 5 x 960x512, RootNet on all 15
              heatmap channels over the 80x80x20 space, 64^3 cubes, K = 10,
              bf16, batch 2, random weights from seed 0, a 3-person scene
              with three GT people moved onto proposals (the GT matching
              leaves holes; PoseNet gets a gradient): three timed train steps
              after a warm-up as the YAML stands (frozen backbone) and with
              NETWORK.TRAIN_BACKBONE true, one under NETWORK.USE_GT
              (loss_cord > 0), each step's launch counts and the sub-networks
              that moved asserted; the forward at TEST.BATCH_SIZE 4; the
              small float32 supervised model on the card against the CPU;
  8. stages   the paper's SSL stages 1 and 2 at full width:
              backbone_pseudo_hrnet_soft_9videos.yaml (TRAIN_ONLY_2D) at
              batch 4, two steps, only the backbone moves and no sampler
              runs; cam5_rootnet.yaml (TRAIN_ONLY_ROOTNET) at batch 1, three
              steps after a warm-up, only RootNet moves, 10 sample_view
              launches a step and no adjoint;
  9. kernels  each kernel at its main path's shapes and sample points (with
              seeded uniform heatmaps), held against its plain version,
              timed beside it, beside its bound, and beside one PyTorch
              library call where one computes the same function (for
              sample_views_mean, which none computes, F.grid_sample's time
              for the sampling part alone); the adjoint also on a
              step-like cotangent (each of the five views' launches with
              the rows of points outside that view's image zeroed), and
              sample_view also at the train shapes, one view and the five
              of a train step; then the three samplers at the supervised
              path's shapes (sample_view and its adjoint, on a dense
              cotangent, at RootNet's whole space with J = 15;
              sample_views_mean on the supervised forward's cubes), and
              every sampler's launches on each path;
 10. microbench  the three measurement probes (selfpose3d_tpu_torch/
              microbench/: conv3, sw_variants, primitives) at their full
              shapes, each probe's measurement driven with its kernel's
              launch count set to 0 just before and read just after; then
              each kernel held against its plain version on the same
              inputs (conv3 within one bf16 ulp, the six slice-warp modes
              1e-5 on the entries each defines, the four primitive bodies
              exactly), the primitive kernel's time at 400 repetitions at
              least 1.5 times its time at 200, and no module of JAX or of
              the JAX package loaded. Each probe's bound is priced from its
              module's work(): bytes, FLOPs and shared-memory loads, the
              largest of the three (bound_terms).
Then the kernels line, and last {"ok": true, "device": {...}}. Any failed
check raises and the script exits non-zero. It needs a CUDA device and
exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from selfpose3d_tpu_torch.config import flagship_cfg, load_config  # noqa: E402
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch  # noqa: E402
from selfpose3d_tpu_torch.models import get_model  # noqa: E402
from selfpose3d_tpu_torch.models.multi_person import cat_branches  # noqa: E402
from selfpose3d_tpu_torch.train import (  # noqa: E402
    create_train_state, make_ssv_train_step, make_supervised_train_step)
from selfpose3d_tpu_torch.geometry.grid import compute_grid  # noqa: E402
from selfpose3d_tpu_torch.microbench import conv3 as mb_conv3  # noqa: E402
from selfpose3d_tpu_torch.microbench import primitives as mb_prim  # noqa: E402
from selfpose3d_tpu_torch.microbench import sw_variants as mb_sw  # noqa: E402
from selfpose3d_tpu_torch.microbench.common import (  # noqa: E402
    card_line, cuda_ms, sm_clock_max_mhz)
from selfpose3d_tpu_torch.ops import build, slicewarp  # noqa: E402
from selfpose3d_tpu_torch.ops.unproject import compute_sample_grid, to_pixels  # noqa: E402

# H100 SXM published peaks (HBM3 bandwidth, dense FP32 rate); shared
# memory serves 32 four-byte loads a clock on each of the 132 SMs, at the
# card's highest SM clock (read in phase_card)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
SMS, SMEM_LOADS_PER_CLOCK = 132, 32
SM_CLOCK_HZ = 1.98e9  # replaced by the card's clocks.max.sm in phase_card
SOURCE = "selfpose3d_tpu_torch/csrc/slicewarp.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def small_cfg():
    """A small float32 configuration (ResNet-18, 3 views at 256x128, 16^3
    cubes, 4 candidates kept valid at random init)."""
    return load_config(overrides={
        "MODEL": "multi_person_posenet_ssv",
        "DTYPE": "float32",
        "NETWORK": {"NUM_JOINTS": 15, "IMAGE_SIZE": [256, 128], "HEATMAP_SIZE": [64, 32],
                    "SIGMA": 3, "ROOTNET_ROOTHM": True},
        "POSE_RESNET": {"NUM_LAYERS": 18},
        "MULTI_PERSON": {"SPACE_SIZE": [8000.0, 8000.0, 2000.0],
                         "SPACE_CENTER": [0.0, -500.0, 800.0],
                         "INITIAL_CUBE_SIZE": [16, 16, 8], "MAX_PEOPLE_NUM": 4,
                         "THRESHOLD": -100.0},
        "PICT_STRUCT": {"CUBE_SIZE": [16, 16, 16]},
        "DATASET": {"ROOTIDX": 2, "CAMERA_NUM": 3},
    })


def small_train_cfg():
    """``small_cfg`` with every SSV loss term on: attention net, L1 stage,
    synthetic-root training, a trainable backbone."""
    cfg = small_cfg()
    return dataclasses.replace(
        cfg, WITH_SSV=True, WITH_ATTN=True, USE_L1=True, L1_ATTN=True,
        NETWORK=dataclasses.replace(cfg.NETWORK, ROOTNET_TRAIN_SYNTH=True,
                                    TRAIN_BACKBONE=True, FREEZE_ROOTNET=False),
    )


def train_cfg():
    """The flagship config with every candidate kept valid at random init
    (THRESHOLD = -100), so the pose losses are not gated off."""
    cfg = flagship_cfg()
    return dataclasses.replace(
        cfg, MULTI_PERSON=dataclasses.replace(cfg.MULTI_PERSON, THRESHOLD=-100.0))


def train_branches(cfg, batch_size, seed, device):
    """Three augmentation branches of one synthetic scene (rotation 15,
    -10 and 0 degrees)."""
    return [make_synthetic_branch(cfg, batch_size=batch_size, num_person=3, seed=seed,
                                  with_images=True, rot_deg=rot, device=device)[0]
            for rot in (15.0, -10.0, 0.0)]


TERMS = ("loss_2d", "loss_root_syn", "loss_root_reg", "loss_pose3d_ssv", "loss_attn_ssv",
         "loss_pose3d_l1_ssv")


@torch.no_grad()
def randomize(model, seed):
    """Seeded weights with spread (fan-in-scaled kernels, BatchNorm near
    identity) and the root output bias lifted by 1, so proposals are not
    decided by exact ties."""
    g = torch.Generator().manual_seed(seed)
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if not t.dtype.is_floating_point:
            continue
        if name.endswith("running_var") or (name.endswith("weight") and t.dim() == 1):
            v = 0.75 + 0.5 * torch.rand(t.shape, generator=g)
        elif t.dim() > 1:
            fan_in = t[0].numel() if "deconv" not in name and "upsample" not in name else t.shape[0]
            v = torch.randn(t.shape, generator=g) / fan_in ** 0.5
        else:
            v = torch.randn(t.shape, generator=g) * 0.05
        t.copy_(v)
    model.root_net.v2v_net.output_layer.bias += 1.0
    return model


def bound_terms(bytes_moved, flops, peak=F32_FLOPS, smem_loads=0):
    """ms of each basis of the bound: the bytes at the HBM rate, the FLOPs at
    ``peak``, the shared-memory loads at the card's load rate."""
    return {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3, "FLOPs": flops / peak * 1e3,
            "shared-memory loads": smem_loads / (SMS * SMEM_LOADS_PER_CLOCK * SM_CLOCK_HZ) * 1e3}


def bound(bytes_moved, flops, peak=F32_FLOPS, smem_loads=0):
    """The least time (ms) and what bounds it, "bytes" or "operations" (FLOPs
    or shared-memory loads; ``bound_terms`` names which)."""
    terms = bound_terms(bytes_moved, flops, peak, smem_loads)
    basis = max(terms, key=terms.get)
    return terms[basis], ("bytes" if basis == "bytes" else "operations")


# the kernels redesigned for Hopper (conv3, the adjoint, the forward
# samplers and their channel padding, the slice-warp probe and its
# channel-last copy, the primitive probe): the card phase prints their
# registers, static shared memory and spills
REDESIGNED = ("conv3_kernel", "sample_view_adjoint_kernel", "sample_views_kernel",
              "sample_view_j1_kernel", "sample_view_pad_kernel", "sw_slice_kernel",
              "sw_pad_kernel", "primitive_band_kernel")
# template arguments as they appear mangled: integers, booleans, types
MANGLED_ARG = r"L[ib](\d+)E|f|13__nv_bfloat16"
MANGLED_TYPES = {"f": "float", "13__nv_bfloat16": "bf16"}


def ptxas_figures(log, names=REDESIGNED):
    """{kernel: {"registers", "smem_bytes" (static), "spill_stores",
    "spill_loads"}} from an ``nvcc -Xptxas -v`` log, for the kernels whose
    mangled name contains one of ``names`` (a template instance as
    ``name<N>`` or ``name<type>``; the dynamic shared memory a launch asks
    for is not in the log: see the sources)."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = next((n for n in names if re.search(r"\d" + n + "(I|E|P)", m.group(1))), None)
            t = fn and re.search(fn + r"I((?:" + MANGLED_ARG + r")+)E", m.group(1))
            if t:
                args = [a.group(1) or MANGLED_TYPES[a.group(0)]
                        for a in re.finditer(MANGLED_ARG, t.group(1))]
                fn = f"{fn}<{','.join(args)}>"
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(fn, {}).update(spill_stores=int(m.group(1)),
                                          spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.setdefault(fn, {}).update(registers=int(m.group(1)),
                                          smem_bytes=int(smem.group(1)) if smem else 0)
    return out


def phase_card():
    global SM_CLOCK_HZ
    smi = card_line()
    print(smi, flush=True)
    SM_CLOCK_HZ = sm_clock_max_mhz() * 1e6
    t0 = time.perf_counter()
    built = build.build()
    for name in built:
        build.library(name)
    ptxas = [ln.strip() for info in built.values() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "card", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "sm_clock_max_mhz": SM_CLOCK_HZ / 1e6,
          "build_s": round(time.perf_counter() - t0, 3),
          "nvcc_s": {k: round(v["seconds"], 3) for k, v in built.items()},
          "ptxas": ptxas,
          "ptxas_redesigned": {fn: fig for info in built.values()
                               for fn, fig in ptxas_figures(info["log"]).items()}})


def phase_main():
    cfg = flagship_cfg()
    model = get_model(cfg, device="cuda", seed=0)
    br, _ = make_synthetic_branch(cfg, batch_size=8, num_person=3, seed=0,
                                  with_images=True, device="cuda")
    model.do_inference(br)  # warm-up: cuDNN algorithm selection, library load
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        model.do_inference(br)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3

    torch.cuda.reset_peak_memory_stats()
    slicewarp.reset_launches()
    pred, hm, gc = model.do_inference(br)
    torch.cuda.synchronize()
    launches = dict(slicewarp.LAUNCHES)

    assert pred.shape == (8, 10, 15, 5), pred.shape
    assert hm.shape == (8, 5, 128, 240, 15), hm.shape
    assert gc.shape == (8, 10, 5), gc.shape
    for t in (pred, hm, gc):
        assert torch.isfinite(t).all()
    assert launches["sample_view"] == 5, launches  # one per view (RootNet)
    assert launches["sample_views_mean"] == 1, launches  # one for all cubes (PoseNet)
    emit({"phase": "main", "config": "flagship cam5 (ResNet-50, 5x960x512, 80x80x20, 64^3, bf16)",
          "batch": 8, "ms_per_batch": round(ms, 3), "frames_per_s": round(8e3 / ms, 3),
          "candidates_run": model.pose_net.bucket(gc),
          "valid_candidates": int((gc[..., 3] >= 0).sum()),
          "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
          "launches": launches})
    return model, launches, br, gc


def phase_geometry(model):
    """Rendered root heatmaps unproject onto every person's root voxel."""
    cfg = flagship_cfg()
    br, poses = make_synthetic_branch(cfg, batch_size=2, num_person=3, seed=7,
                                      with_images=False, device="cuda")
    rid = cfg.DATASET.ROOTIDX
    root_hm = br.input_heatmaps[..., rid : rid + 1].contiguous()
    before = slicewarp.LAUNCHES["sample_view"]
    cubes = model.root_net.unproject(root_hm, br.cam, br.trans, br.orig_wh)
    torch.cuda.synchronize()
    assert slicewarp.LAUNCHES["sample_view"] == before + 5
    cpu = model.root_net.unproject(root_hm.cpu(), br.cam.to("cpu"), br.trans.cpu(),
                                   br.orig_wh.cpu())
    err = float((cubes.cpu() - cpu).abs().max())
    assert err <= 1e-5, err

    size = torch.tensor(cfg.MULTI_PERSON.SPACE_SIZE)
    lo = torch.tensor(cfg.MULTI_PERSON.SPACE_CENTER) - size / 2
    n = torch.tensor(cfg.MULTI_PERSON.INITIAL_CUBE_SIZE)
    values = []
    for b in range(poses.shape[0]):
        for root in torch.from_numpy(poses[b, :, rid]):
            ix, iy, iz = torch.round((root - lo) / size * (n - 1)).long().tolist()
            values.append(float(cubes[b, ix, iy, iz, 0]))
    assert min(values) > 0.5, values
    emit({"phase": "geometry", "root_voxel_values": [round(v, 4) for v in values],
          "card_vs_cpu_max_abs_err": err})


def phase_parity():
    cfg = small_cfg()
    cpu = randomize(get_model(cfg, device="cpu"), seed=3)
    gpu = get_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    br, _ = make_synthetic_branch(cfg, batch_size=2, num_person=3, seed=1,
                                  with_images=True, device="cpu")
    pc, _, gcc = cpu.do_inference(br)
    pg, _, gcg = (t.cpu() for t in gpu.do_inference(br.to("cuda")))
    assert torch.equal(gcg[..., 3], gcc[..., 3]), (gcg[..., 3], gcc[..., 3])
    loc_err = float((gcg[..., :3] - gcc[..., :3]).abs().max())
    pose_err = float((pg[..., :3] - pc[..., :3]).norm(dim=-1).max())
    assert loc_err <= 1e-3 and pose_err < 1.0, (loc_err, pose_err)
    emit({"phase": "parity", "config": "small f32 (ResNet-18, 3x256x128, 16^3, K=4)",
          "proposal_max_abs_err_mm": loc_err, "pose_max_err_mm": pose_err})


def phase_train():
    """Three flagship train steps; returns the model, its branches and the
    kernels' launch counts of one step."""
    cfg = train_cfg()
    B = cfg.TRAIN.BATCH_SIZE
    model = get_model(cfg, device="cuda", seed=0)
    branches = train_branches(cfg, B, seed=0, device="cuda")
    state = create_train_state(cfg, model)
    step = make_ssv_train_step(model, train_posenet_stage=True, use_l1_stage=True)
    gen = torch.Generator().manual_seed(0)
    nets = ("backbone", "attn", "root_net", "pose_net")
    before = {n: [p.detach().clone() for p in getattr(model, n).parameters()] for n in nets}
    stats_before = {k: v.clone() for k, v in model.named_buffers() if "running_" in k}

    step(state, *branches, generator=gen)  # warm-up: cuDNN algorithm selection
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    times = []
    for _ in range(reps):
        slicewarp.reset_launches()
        t0 = time.perf_counter()
        metrics = step(state, *branches, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(slicewarp.LAUNCHES)
        # per step: RootNet main 5 + synthetic 5 + PoseNet 5 forward
        # launches; 5 adjoints (PoseNet only: RootNet's heatmaps are detached)
        assert launches == {"sample_view": 15, "sample_view_adjoint": 5,
                            "sample_views_mean": 0}, launches
    losses = {k: float(v) for k, v in metrics.items()}
    assert set(TERMS) <= set(losses), sorted(losses)
    assert all(torch.isfinite(torch.tensor(v)) for v in losses.values()), losses
    assert losses["loss_pose3d_ssv"] > 0, losses
    for n in nets:
        moved = sum(int(not torch.equal(a, b.detach()))
                    for a, b in zip(before[n], getattr(model, n).parameters()))
        assert moved > 0.9 * len(before[n]), (n, moved, len(before[n]))
    moved_stats = sum(int(not torch.equal(stats_before[k], v))
                      for k, v in model.named_buffers() if "running_" in k)
    assert moved_stats == len(stats_before), (moved_stats, len(stats_before))
    assert state.step == reps + 1
    ms = sum(times) / reps
    emit({"phase": "train", "config": "flagship cam5, THRESHOLD -100 (ResNet-50 + ResNet-18 "
          "attention, 5x960x512, 80x80x20, 64^3 x 10 candidates, bf16 compute, f32 parameters)",
          "batch": B, "optimizer": cfg.TRAIN.OPTIMIZER, "steps_timed": reps,
          "ms_per_step": round(ms, 3), "ms_each": [round(t, 3) for t in times],
          "samples_per_s": round(B * 1e3 / ms, 4),
          "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
          "launches_per_step": launches, "losses": losses,
          "parameters": sum(p.numel() for p in model.parameters()),
          "bn_buffers_moved": moved_stats})
    return model, branches, launches


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-12)


def phase_train_parity():
    """The train-stage losses and their gradients of the small float32
    model on the card (kernels, atomics, cuDNN with TF32 off) against the
    CPU (plain samplers), same weights and injected synthetic-root draws,
    float32 against float32, in two runs.

    BatchNorm on its running statistics (``bn_eval``; the loss composition
    and the samplers' adjoint are the train step's): losses rel 1e-4; the
    gradient of the heatmap-producing layer (backbone.final_layer.weight)
    within 1e-3 of its largest value, every other parameter's within 1e-2
    of its own and the median within 1e-3.

    Train-mode BatchNorm: losses rel 1e-4. The gradients' distances are
    printed and held to nothing: through stacks of batch-statistics
    BatchNorm two float32 runs differ by percents of a tensor's largest
    gradient on any device (tests/test_torch_train_step.py)."""
    cfg = small_train_cfg()
    B = 2
    cpu = randomize(get_model(cfg, device="cpu"), seed=3)
    gpu = get_model(cfg, device="cuda")
    start = cpu.state_dict()
    branches = train_branches(cfg, B, seed=1, device="cpu")
    branches_gpu = [b.to("cuda") for b in branches]
    g = torch.Generator().manual_seed(5)
    P, V = cfg.MULTI_PERSON.MAX_PEOPLE_NUM, cfg.DATASET.CAMERA_NUM
    W, H = cfg.NETWORK.HEATMAP_SIZE
    lo, hi = (torch.tensor(v) for v in zip(*cpu.root_net.synth_bounds()))
    inject = {"counts": torch.randint(1, P, (3,), generator=g),
              "roots": lo + (hi - lo) * torch.rand((3 * B, P, 3), generator=g),
              "noise": 0.02 * torch.randn((3 * B, V, 1, H, W), generator=g)}
    nets = ("backbone.", "attn.", "root_net.", "pose_net.")

    def run(model, brs, bn_eval):
        model.load_state_dict(start)  # a train-mode run moves the statistics
        model.zero_grad(set_to_none=True)
        _, _, gc, losses = model.ssv_losses(*brs, train_posenet_stage=True, use_l1_stage=True,
                                            train=True, bn_eval=bn_eval, synth_inject=inject)
        sum(v.mean() for v in losses.values()).backward()
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        return {k: float(v.detach()) for k, v in losses.items()}, grads, gc.detach().cpu()

    def errors(grads, ref):
        """Per tensor: max abs distance to the CPU's gradient over that
        gradient's max; tensors below 1e-5 of their net's largest gradient
        (zero in exact arithmetic) are left out."""
        out = {}
        for net in nets:
            top = max(float(v.abs().max()) for k, v in ref.items() if k.startswith(net))
            out.update({k: float((grads[k] - v).abs().max() / v.abs().max())
                        for k, v in ref.items()
                        if k.startswith(net) and float(v.abs().max()) > 1e-5 * top})
        return out

    hm_layer = "backbone.final_layer.weight"
    report = {}
    for bn_eval in (True, False):
        lc, grads_c, gcc = run(cpu, branches, bn_eval)
        slicewarp.reset_launches()
        lg, grads_g, gcg = run(gpu, branches_gpu, bn_eval)
        assert slicewarp.LAUNCHES["sample_view_adjoint"] == V, dict(slicewarp.LAUNCHES)
        assert slicewarp.LAUNCHES["sample_views_mean"] == 0, dict(slicewarp.LAUNCHES)
        assert torch.equal(gcg[..., 3], gcc[..., 3]), (gcg[..., 3], gcc[..., 3])
        assert set(TERMS) <= set(lc), sorted(lc)
        loss_rel = {k: _rel(lc[k], lg[k]) for k in lc}
        err = errors(grads_g, grads_c)
        med = sorted(err.values())[len(err) // 2]
        worst = max(err, key=err.get)
        report["bn_eval" if bn_eval else "train_mode"] = {
            "loss_max_rel_err": max(loss_rel.values()),
            "grad_err_card_vs_cpu": {"max": err[worst], "max_at": worst, "median": med,
                                     hm_layer: err[hm_layer]},
            "parameters_compared": len(err), "losses_card": lg}
    emit({"phase": "train_parity", "config": "small f32 (ResNet-18 + attention, 3x256x128, "
          "16^3, K=4), batch 2", **report})
    for mode in report.values():
        assert mode["loss_max_rel_err"] <= 1e-4, mode
    held = report["bn_eval"]["grad_err_card_vs_cpu"]
    assert held[hm_layer] <= 1e-3, held
    assert held["max"] <= 1e-2 and held["median"] <= 1e-3, held


# the supervised baseline and the paper's SSL stages 1 and 2, at full width
SUPERVISED_YAML = "configs/panoptic/resnet50/prn64_cpn80x80x20_960x512_cam5.yaml"
STAGE1_YAML = "configs/panoptic_ssl/resnet50/backbone_pseudo_hrnet_soft_9videos.yaml"
STAGE2_YAML = "configs/panoptic_ssl/resnet50/cam5_rootnet.yaml"
SAMPLERS = ("sample_view", "sample_views_mean", "sample_view_adjoint")


def yaml_cfg(path, **network):
    """A config under configs/ as the port's ``load_config`` reads it, with
    the NETWORK fields given changed."""
    return load_config(os.path.join(ROOT, path),
                       overrides={"NETWORK": network} if network else None)


def sampler_counts(view, mean, adjoint):
    """Launches of sample_view, sample_views_mean, sample_view_adjoint."""
    return dict(zip(SAMPLERS, (view, mean, adjoint)))


def small_supervised_cfg():
    """``small_cfg`` as the supervised baseline: RootNet on all 15
    channels, K = 4 candidates (THRESHOLD -100), a trainable backbone."""
    cfg = small_cfg()
    return dataclasses.replace(
        cfg, MODEL="multi_person_posenet",
        NETWORK=dataclasses.replace(cfg.NETWORK, ROOTNET_ROOTHM=False, TRAIN_BACKBONE=True))


def snapshot(model):
    return {n: [p.detach().clone() for p in m.parameters()] for n, m in model.named_children()}


def moved(model, before):
    """The sub-networks whose parameters changed since ``before``."""
    return sorted(n for n, ps in before.items()
                  if any(not torch.equal(a, b.detach())
                         for a, b in zip(ps, getattr(model, n).parameters())))


@torch.no_grad()
def gt_at_proposals(model, branch, slots=((0, 0, 2), (0, 1, 5), (1, 1, 1))):
    """The branch with GT people moved next to the model's train-mode
    proposals, each (sample, person, candidate slot) of ``slots`` 100 mm
    from its slot (roots_3d and the person's joints_3d): random weights
    propose nothing near the scene's people, and this way the GT matching
    assigns a later slot while leaving earlier ones invalid, and PoseNet
    has a gradient. The proposals do not depend on the GT. The model's
    state is as before."""
    start = {k: v.clone() for k, v in model.state_dict().items()}
    _, _, gc, _ = model(branch, train=True)
    model.load_state_dict(start)
    roots, joints = branch.roots_3d.clone(), branch.joints_3d.clone()
    for b, p, k in slots:
        new = gc[b, k, :3] + torch.tensor([100.0, 0.0, 0.0], device=gc.device)
        joints[b, p] += new - roots[b, p]
        roots[b, p] = new
    return dataclasses.replace(branch, roots_3d=roots, joints_3d=joints)


def timed_steps(run, steps, expect):
    """``steps`` calls of the train step ``run()``, each synchronised and
    timed by the host clock, with the kernels' launch counts set to 0
    before it and held to ``expect`` after; -> (ms of each, the finite
    metrics of each)."""
    times, metrics = [], []
    for _ in range(steps):
        slicewarp.reset_launches()
        t0 = time.perf_counter()
        m = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = dict(slicewarp.LAUNCHES)
        assert got == expect, (got, expect)
        metrics.append({k: float(v) for k, v in m.items()})
        assert all(math.isfinite(v) for v in metrics[-1].values()), metrics[-1]
    return times, metrics


def supervised_train(cfg, branch, steps, expect, warmup=True):
    """``steps`` timed supervised train steps (after one warm-up step) of a
    fresh model from seed 0, the GT moved onto its proposals unless USE_GT;
    every step's kernel launches held to ``expect`` (``timed_steps``)."""
    model = get_model(cfg, device="cuda", seed=0)
    state = create_train_state(cfg, model)
    step = make_supervised_train_step(model)
    if not cfg.NETWORK.USE_GT:
        branch = gt_at_proposals(model, branch)
    before = snapshot(model)
    if warmup:
        step(state, branch)  # cuDNN algorithm selection
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = timed_steps(lambda: step(state, branch), steps, expect)
    ms = sum(times) / steps
    report = {"batch": branch.batch_size, "steps_timed": steps, "warm_up_step": warmup,
              "ms_per_step": ms, "ms_each": times,
              "samples_per_s": branch.batch_size * 1e3 / ms,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "launches_per_step": expect, "losses_each_step": losses,
              "moved": moved(model, before)}
    return model, branch, report


def phase_supervised():
    """The supervised baseline (configs/panoptic/resnet50/prn64_...yaml) at
    full width: ResNet-50, 5 views at 960x512, the 80x80x20 root space
    (RootNet on all 15 channels, not detached), 64^3 cubes, K = 10,
    TRAIN.BATCH_SIZE 2, bf16 (the Config default), random weights from
    seed 0, a 3-person synthetic scene. Train steps as the YAML stands
    (frozen backbone), with NETWORK.TRAIN_BACKBONE true (loss_3d reaches
    the backbone through RootNet's sampler adjoint), and one under
    NETWORK.USE_GT; the forward at TEST.BATCH_SIZE 4; the small float32
    model on the card against the CPU. Returns what the kernels phase
    prices at these shapes."""
    base = yaml_cfg(SUPERVISED_YAML)
    B, Bt = base.TRAIN.BATCH_SIZE, base.TEST.BATCH_SIZE
    V = base.DATASET.CAMERA_NUM
    branch = make_synthetic_branch(base, batch_size=B, num_person=3, seed=0, device="cuda")[0]
    report = {"config": SUPERVISED_YAML, "dtype": base.DTYPE}

    # 1. as the YAML stands: PoseNet samples through the fused kernel
    model, matched, r = supervised_train(base, branch, 3, sampler_counts(V, 1, 0))
    assert r["moved"] == ["pose_net", "root_net"], r["moved"]
    report["yaml"] = {"changed": {}, **r}

    # the forward at TEST.BATCH_SIZE, no autograd
    br_test = make_synthetic_branch(base, batch_size=Bt, num_person=3, seed=1, device="cuda")[0]
    with torch.no_grad():
        model(br_test, train=False)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reps, t0 = 3, time.perf_counter()
        for _ in range(reps):
            model(br_test, train=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        slicewarp.reset_launches()
        pred, hm, gc, losses = model(br_test, train=False)
        torch.cuda.synchronize()
    got = dict(slicewarp.LAUNCHES)
    assert got == sampler_counts(V, 1, 0), got
    K, J = base.MULTI_PERSON.MAX_PEOPLE_NUM, base.NETWORK.NUM_JOINTS
    assert pred.shape == (Bt, K, J, 5) and gc.shape == (Bt, K, 5), (pred.shape, gc.shape)
    assert hm.shape == (Bt, V, *base.NETWORK.HEATMAP_SIZE[::-1], J), hm.shape
    for t in (pred, hm, gc, *losses.values()):
        assert torch.isfinite(t).all()
    report["inference"] = {
        "batch": Bt, "ms_per_batch": ms, "frames_per_s": Bt * 1e3 / ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": got,
        "candidates_run": model.pose_net.bucket(gc),
        "valid_candidates": int((gc[..., 3] >= 0).sum()),
        "losses": {k: float(v) for k, v in losses.items()}}
    kernel_inputs = {"branch": matched, "rootnet": model.root_net, "test_branch": br_test,
                     "test_gc": gc, "pose_net": model.pose_net}
    del model, pred, hm, losses
    torch.cuda.empty_cache()

    # 2. the backbone trains: RootNet's and PoseNet's samplers both carry a
    # gradient back to the heatmaps
    cfg = yaml_cfg(SUPERVISED_YAML, TRAIN_BACKBONE=True)
    model, _, r = supervised_train(cfg, branch, 3, sampler_counts(2 * V, 0, 2 * V))
    assert r["moved"] == ["backbone", "pose_net", "root_net"], r["moved"]
    report["train_backbone"] = {"changed": {"NETWORK.TRAIN_BACKBONE": True}, **r}
    del model
    torch.cuda.empty_cache()

    # 3. USE_GT: every GT person is a candidate, so loss_cord > 0
    cfg = yaml_cfg(SUPERVISED_YAML, USE_GT=True)
    model, _, r = supervised_train(cfg, branch, 1, sampler_counts(0, 1, 0), warmup=False)
    assert r["losses_each_step"][0]["loss_cord"] > 0, r["losses_each_step"]
    assert r["moved"] == ["pose_net"], r["moved"]
    report["use_gt"] = {"changed": {"NETWORK.USE_GT": True}, **r}
    del model
    torch.cuda.empty_cache()

    report["small_f32_card_vs_cpu"] = supervised_parity()
    emit({"phase": "supervised", **report})
    paths = {"supervised step": report["yaml"]["launches_per_step"],
             "supervised step, TRAIN_BACKBONE": report["train_backbone"]["launches_per_step"],
             "supervised step, USE_GT": report["use_gt"]["launches_per_step"],
             "supervised forward": report["inference"]["launches"]}
    return kernel_inputs, paths


def supervised_parity():
    """The small float32 supervised model (``small_supervised_cfg``) on
    the card against the CPU, same weights, the GT moved onto the CPU's
    proposals: the eval-mode forward (flags equal, proposals to 1e-3 mm,
    poses < 1 mm, losses rel 1e-4) and the train-mode one (batch-statistics
    BatchNorm, GT matching: flags equal, proposals to 1e-3 mm, losses rel
    1e-3)."""
    cfg = small_supervised_cfg()
    cpu = randomize(get_model(cfg, device="cpu"), seed=3)
    gpu = get_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    br = make_synthetic_branch(cfg, batch_size=2, num_person=3, seed=1, device="cpu")[0]
    br = gt_at_proposals(cpu, br, slots=((0, 0, 1), (0, 1, 3), (1, 2, 2)))
    out = {}
    for train in (False, True):
        with torch.no_grad():
            pc, _, gcc, lc = cpu(br, train=train)
            pg, _, gcg, lg = (x if isinstance(x, dict) else x.cpu()
                              for x in gpu(br.to("cuda"), train=train))
        assert torch.equal(gcg[..., 3], gcc[..., 3]), (gcg[..., 3], gcc[..., 3])
        loss_rel = {k: _rel(float(lc[k]), float(lg[k])) for k in lc}
        loc_err = float((gcg[..., :3] - gcc[..., :3]).abs().max())
        pose_err = float((pg[..., :3] - pc[..., :3]).norm(dim=-1).max())
        out["train_mode" if train else "eval_mode"] = {
            "loss_max_rel_err": max(loss_rel.values()), "losses_card": {
                k: float(v) for k, v in lg.items()},
            "proposal_max_abs_err_mm": loc_err, "pose_max_err_mm": pose_err,
            "valid_candidates": int((gcc[..., 3] >= 0).sum())}
        assert max(loss_rel.values()) <= (1e-3 if train else 1e-4), loss_rel
        assert loc_err <= 1e-3, loc_err
        if not train:
            assert pose_err < 1.0, pose_err
    assert out["train_mode"]["losses_card"]["loss_cord"] > 0, out
    return out


def phase_stages():
    """The paper's SSL stages 1 and 2 at full width, random weights from
    seed 0: stage 1 (backbone_pseudo_hrnet_soft_9videos.yaml, the
    supervised model under TRAIN_ONLY_2D) at its TRAIN.BATCH_SIZE 4, two
    steps: only the backbone moves and no sampler runs; stage 2
    (cam5_rootnet.yaml, the SSV model under TRAIN_ONLY_ROOTNET, frozen
    backbone) at its batch 1, a warm-up and three steps with the synthetic
    roots drawn from a seeded generator: only RootNet moves, its main and
    synthetic passes launching sample_view once a view each, no adjoint
    (the root channel is detached)."""
    report = {}
    cfg = yaml_cfg(STAGE1_YAML)
    B = cfg.TRAIN.BATCH_SIZE
    model = get_model(cfg, device="cuda", seed=0)
    assert [n for n, _ in model.named_children()] == ["backbone"]
    state = create_train_state(cfg, model)
    step = make_supervised_train_step(model)
    br = make_synthetic_branch(cfg, batch_size=B, num_person=3, seed=0, device="cuda")[0]
    before = snapshot(model)
    torch.cuda.reset_peak_memory_stats()
    expect = sampler_counts(0, 0, 0)
    times, losses = timed_steps(lambda: step(state, br), 2, expect)
    assert set(losses[-1]) == {"loss_2d", "loss"}, sorted(losses[-1])
    assert moved(model, before) == ["backbone"], moved(model, before)
    report["stage1"] = {"config": STAGE1_YAML, "model": cfg.MODEL, "batch": B,
                        "ms_each": times, "ms_second_step": times[1],
                        "samples_per_s": B * 1e3 / times[1],
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                        "launches_per_step": expect, "losses": losses[-1],
                        "moved": moved(model, before)}
    del model, state, step, br, before
    torch.cuda.empty_cache()

    cfg = yaml_cfg(STAGE2_YAML)
    B, V = cfg.TRAIN.BATCH_SIZE, cfg.DATASET.CAMERA_NUM
    model = get_model(cfg, device="cuda", seed=0)
    assert [n for n, _ in model.named_children()] == ["backbone", "root_net"]
    state = create_train_state(cfg, model)
    step = make_ssv_train_step(model, train_posenet_stage=True, use_l1_stage=True)
    brs = train_branches(cfg, B, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(0)
    before = snapshot(model)
    step(state, *brs, generator=gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    expect = sampler_counts(2 * V, 0, 0)
    times, losses = timed_steps(lambda: step(state, *brs, generator=gen), 3, expect)
    assert set(losses[-1]) == {"loss_2d", "loss_root_syn", "loss_root_reg", "loss"}, \
        sorted(losses[-1])
    assert moved(model, before) == ["root_net"], moved(model, before)
    ms = sum(times) / 3
    report["stage2"] = {"config": STAGE2_YAML, "model": cfg.MODEL, "batch": B,
                        "ms_each": times, "ms_per_step": ms, "samples_per_s": B * 1e3 / ms,
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                        "launches_per_step": expect, "losses": losses[-1],
                        "moved": moved(model, before)}
    del model, state, step, brs
    torch.cuda.empty_cache()
    emit({"phase": "stages", **report})
    return report


def identity_bar(hm, px, py, cot):
    """The bar of the inner-product identity <sample_view(h), g> == <h,
    adjoint(g)> (tests/test_torch_cuda.py ``_identity_bar``): 1e-5 of the
    float64 sum of |w_tap * h * g| over all points, taps and channels,
    which bounds the float32 atomic-order error of the adjoint."""
    terms = slicewarp.sample_view_plain(hm.double().abs(), px, py) * cot.double().abs()
    return 1e-5 * float(terms.sum())


def whole_space_points(root_net, br, heatmap_wh, view=0):
    """RootNet's sample points of one view over its whole space: pixel
    coordinates px, py (B, N), the normalised grid F.grid_sample takes
    (B, 1, N, 2) and the in-image mask (B, N); consecutive points walk z,
    then y, then x of the grid."""
    W, H = heatmap_wh
    grid = compute_grid(root_net.space_size,
                        torch.tensor(root_net.space_center, device=br.trans.device),
                        root_net.cube_size)
    sg, inside = compute_sample_grid(grid[None, None], br.cam, br.trans, root_net.image_wh,
                                     (W, H), br.orig_wh)
    px, py = (t[:, view].contiguous() for t in to_pixels(sg, (W, H)))
    return px, py, sg[:, view, None].contiguous(), inside[:, view].contiguous()


def phase_kernels_supervised(rows, sup, path_launches):
    """The three samplers at the supervised path's shapes, each against its
    plain version on the card, timed beside it, its bound (bytes, as the
    rows above are priced) and a library call: sample_view at RootNet's
    whole space with all 15 channels (B = 2, N = 128,000, on 240x128; the
    channel-padded copy), its adjoint on a dense cotangent at the same
    shape (float64 plain 1e-5 of its largest entry, and the identity bar),
    and sample_views_mean on the supervised forward's 64^3 cubes of every
    candidate at TEST.BATCH_SIZE. Adds them to ``rows`` (sample_view,
    sample_views_mean, sample_view_adjoint), with each path's launches."""
    cfg = yaml_cfg(SUPERVISED_YAML)
    W, H = cfg.NETWORK.HEATMAP_SIZE
    J = cfg.NETWORK.NUM_JOINTS
    br = sup["branch"]
    B = br.batch_size
    dev = br.trans.device
    g = torch.Generator(device=dev).manual_seed(1)
    px, py, lib_grid, _ = whole_space_points(sup["rootnet"], br, (W, H))
    N = px.shape[1]
    hm = torch.rand(B, H, W, J, generator=g, device=dev)
    padded = build.library("slicewarp").sp3d_forward_scratch_floats(
        hm.data_ptr(), 0, B, 1, H, W, J)
    got = slicewarp.sample_view(hm, px, py)
    err = float((got - slicewarp.sample_view_plain(hm, px, py)).abs().max())
    assert err <= 1e-5, ("sample_view, RootNet J=15", err)
    hm_nchw = hm.permute(0, 3, 1, 2).contiguous()
    lib_err = float((torch.nn.functional.grid_sample(hm_nchw, lib_grid, align_corners=True)
                     [:, :, 0].permute(0, 2, 1) - got).abs().max())
    bms, by = bound(4 * (B * H * W * J + 2 * B * N + B * N * J), B * N * (8 * J + 12))
    rows[0]["supervised_rootnet_j15"] = {
        "shapes": {"hm": [B, H, W, J], "points": [B, N]}, "channel_padded_copy": padded > 0,
        "max_abs_err": err, "bound_ms": bms, "bound_by": by,
        "ms": cuda_ms(lambda: slicewarp.sample_view(hm, px, py), 50),
        "plain_ms": cuda_ms(lambda: slicewarp.sample_view_plain(hm, px, py), 5),
        "library_ms": cuda_ms(lambda: torch.nn.functional.grid_sample(
            hm_nchw, lib_grid, align_corners=True), 50),
        "library_max_abs_err": lib_err}

    # the adjoint on a dense cotangent: RootNet's loss_3d is an MSE over
    # every voxel, so no row of points is zero
    cot = torch.randn(B, N, J, generator=g, device=dev)
    got = slicewarp.sample_view_adjoint(cot, px, py, (H, W))
    plain64 = slicewarp.sample_view_adjoint_plain(cot.double(), px, py, (H, W))
    peak = float(plain64.abs().max())
    err = float((got.double() - plain64).abs().max())
    del plain64
    assert err <= 1e-5 * peak, ("sample_view_adjoint, RootNet J=15 dense", err, peak)
    lhs = float((slicewarp.sample_view(hm, px, py).double() * cot.double()).sum())
    rhs = float((hm.double() * got.double()).sum())
    bar = identity_bar(hm, px, py, cot)
    assert abs(lhs - rhs) <= bar, ("adjoint identity", lhs, rhs, bar)
    hm_req = hm_nchw.clone().requires_grad_()
    lib_out = torch.nn.functional.grid_sample(hm_req, lib_grid, align_corners=True)
    cot_lib = cot.permute(0, 2, 1)[:, :, None].contiguous()  # (B, J, 1, N)
    lib_grad = torch.autograd.grad(lib_out, hm_req, cot_lib, retain_graph=True)[0]
    lib_err = float((lib_grad.permute(0, 2, 3, 1) - got).abs().max())
    bms, by = bound(4 * (B * N * J + 2 * B * N + B * H * W * J), B * N * (8 * J + 12))
    rows[2]["supervised_rootnet_j15_dense"] = {
        "shapes": {"g": [B, N, J], "hm": [B, H, W, J]}, "max_abs_err_vs_float64_plain": err,
        "max_abs_grad": peak, "identity_abs_err": abs(lhs - rhs), "identity_bar": bar,
        "bound_ms": bms, "bound_by": by,
        "ms": cuda_ms(lambda: slicewarp.sample_view_adjoint(cot, px, py, (H, W)), 20),
        "plain_ms": cuda_ms(lambda: slicewarp.sample_view_adjoint_plain(cot, px, py, (H, W)), 5),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            lib_out, hm_req, cot_lib, retain_graph=True)[0], 10),
        "library": "torch.autograd.grad of F.grid_sample(align_corners=True) w.r.t. its input",
        "library_max_abs_err": lib_err}
    del cot, got, hm, hm_nchw, hm_req, lib_out, lib_grad, cot_lib, px, py, lib_grid

    # sample_views_mean on the supervised forward's cubes (every candidate:
    # the YAML sets no candidate buckets), bf16 out
    br, gc, pn = sup["test_branch"], sup["test_gc"], sup["pose_net"]
    B, V = br.trans.shape[:2]
    k = pn.bucket(gc)
    grids = compute_grid(pn.grid_size, gc[:, :k, :3], pn.cube_size).reshape(B, -1, 3)
    sg, bnd = compute_sample_grid(grids[:, None], br.cam, br.trans, pn.image_wh, (W, H),
                                  br.orig_wh)
    px, py = to_pixels(sg, (W, H))
    del sg, grids
    N = px.shape[-1]
    hm = torch.rand(B, V, H, W, J, generator=g, device=dev)
    out = torch.bfloat16
    err = float((slicewarp.sample_views_mean(hm, px, py, bnd, out).float()
                 - slicewarp.sample_views_mean_plain(hm, px, py, bnd, out).float()).abs().max())
    assert err <= 4e-3, ("sample_views_mean, supervised", err)
    bms, by = bound(4 * (B * V * H * W * J + 3 * B * V * N) + 2 * B * N * J,
                    B * N * (V * (8 * J + 12) + 3 * J))
    hm_views = hm.reshape(B * V, H, W, J).permute(0, 3, 1, 2)
    grid_views = torch.stack([px / (W - 1) * 2 - 1, py / (H - 1) * 2 - 1], -1).reshape(
        B * V, 1, N, 2)
    sampling_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
        hm_views, grid_views, align_corners=True), 3)
    del hm_views, grid_views
    rows[1]["supervised_inference"] = {
        "shapes": {"hm": [B, V, H, W, J], "points": [B, V, N], "candidates": k, "out": "bf16"},
        "max_abs_err": err, "bound_ms": bms, "bound_by": by,
        "ms": cuda_ms(lambda: slicewarp.sample_views_mean(hm, px, py, bnd, out), 10),
        "plain_ms": cuda_ms(lambda: slicewarp.sample_views_mean_plain(hm, px, py, bnd, out), 2),
        "library_ms": None, "library_sampling_only_ms": sampling_ms}
    del hm, px, py, bnd
    torch.cuda.empty_cache()
    for row in rows[:3]:
        row["launches_per_path"] = {path: counts[row["name"]]
                                    for path, counts in path_launches.items()}


def phase_kernels(model, br, gc, launches, train_model, train_brs, train_launches):
    """Each kernel at the main path's shapes and on its sample points (the
    flagship scene's projected grids, rebuilt from the same seeded run),
    with seeded uniform heatmaps in place of the random-weight backbone's
    near-zero ones: against its plain version on the card, timed beside
    it, its bound and a library call."""
    cfg = flagship_cfg()
    B, V = br.trans.shape[:2]
    W, H = cfg.NETWORK.HEATMAP_SIZE
    J = cfg.NETWORK.NUM_JOINTS
    g = torch.Generator(device=br.trans.device).manual_seed(0)
    hm = torch.rand(B, V, H, W, J, generator=g, device=br.trans.device)
    rid = cfg.DATASET.ROOTIDX
    rows = []

    # sample_view: RootNet, one view's root channel over the 80x80x20 grid
    rn = model.root_net
    grid = compute_grid(rn.space_size, torch.tensor(rn.space_center, device=hm.device),
                        rn.cube_size)
    sg, _ = compute_sample_grid(grid[None, None], br.cam, br.trans, rn.image_wh, (W, H),
                                br.orig_wh)
    px, py = (t[:, 0].contiguous() for t in to_pixels(sg, (W, H)))
    hm1 = hm[:, 0, :, :, rid : rid + 1].contiguous()
    N = px.shape[1]
    err = float((slicewarp.sample_view(hm1, px, py)
                 - slicewarp.sample_view_plain(hm1, px, py)).abs().max())
    assert err <= 1e-5, ("sample_view", err)
    hm_nchw = hm1.permute(0, 3, 1, 2)
    lib_grid = sg[:, 0, None]  # (B, 1, N, 2) normalised, what grid_sample takes
    lib = torch.nn.functional.grid_sample(hm_nchw, lib_grid, align_corners=True)
    lib_err = float((lib[:, :, 0].permute(0, 2, 1) - slicewarp.sample_view(hm1, px, py))
                    .abs().max())
    # bytes: heatmap, px, py read once, output written once (f32); operations:
    # 8 per tap and channel (4 taps, multiply + add) and 12 for the weights
    bms, by = bound(4 * (B * H * W + 2 * B * N + B * N), B * N * (8 * 1 + 12))
    rows.append({
        "name": "sample_view", "route": "cuda", "source": SOURCE,
        "replaces": "selfpose3d_tpu/ops/slicewarp.py:323 (_slice_warp_kernel)",
        "launches": launches["sample_view"], "max_abs_err": err,
        "ms": cuda_ms(lambda: slicewarp.sample_view(hm1, px, py), 200),
        "plain_ms": cuda_ms(lambda: slicewarp.sample_view_plain(hm1, px, py), 20),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.grid_sample(
            hm_nchw, lib_grid, align_corners=True), 100),
        "library": "F.grid_sample(align_corners=True, padding_mode='zeros')",
        "library_max_abs_err": lib_err,
        "shapes": {"hm": list(hm1.shape), "points": [B, N]},
    })
    del sg, px, py, hm1, hm_nchw, lib_grid, lib

    # sample_views_mean: PoseNet, all views into the candidate bucket's 64^3 cubes
    pn = model.pose_net
    k = pn.bucket(gc)
    grids = compute_grid(pn.grid_size, gc[:, :k, :3], pn.cube_size).reshape(B, -1, 3)
    sg, bnd = compute_sample_grid(grids[:, None], br.cam, br.trans, pn.image_wh, (W, H),
                                  br.orig_wh)
    px, py = to_pixels(sg, (W, H))
    del sg, grids
    N = px.shape[-1]
    out = torch.bfloat16
    err = float((slicewarp.sample_views_mean(hm, px, py, bnd, out).float()
                 - slicewarp.sample_views_mean_plain(hm, px, py, bnd, out).float()).abs().max())
    assert err <= 4e-3, ("sample_views_mean", err)
    err32 = float((slicewarp.sample_views_mean(hm, px, py, bnd)
                   - slicewarp.sample_views_mean_plain(hm, px, py, bnd)).abs().max())
    assert err32 <= 1e-5, ("sample_views_mean f32", err32)
    bms, by = bound(4 * (B * V * H * W * J + 3 * B * V * N) + 2 * B * N * J,
                    B * N * (V * (8 * J + 12) + 3 * J))
    # no one library call takes the bounded view mean; F.grid_sample over
    # every view's heatmap takes the sampling part alone
    hm_views = hm.reshape(B * V, H, W, J).permute(0, 3, 1, 2)
    grid_views = torch.stack([px / (W - 1) * 2 - 1, py / (H - 1) * 2 - 1], -1).reshape(
        B * V, 1, N, 2)
    sampling_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
        hm_views, grid_views, align_corners=True), 5)
    del hm_views, grid_views
    rows.append({
        "name": "sample_views_mean", "route": "cuda", "source": SOURCE,
        "replaces": "selfpose3d_tpu/ops/slicewarp.py:664 (_slice_warp_agg_kernel)",
        "launches": launches["sample_views_mean"], "max_abs_err": err,
        "max_abs_err_f32_out": err32,
        "ms": cuda_ms(lambda: slicewarp.sample_views_mean(hm, px, py, bnd, out), 20),
        "plain_ms": cuda_ms(lambda: slicewarp.sample_views_mean_plain(hm, px, py, bnd, out), 3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": None,
        "library_sampling_only_ms": sampling_ms,
        "library_sampling_only": "F.grid_sample(align_corners=True, padding_mode='zeros') over "
                                 "the (B*V, J, H, W) heatmaps, grid (B*V, 1, N, 2): the "
                                 "sampling alone, not the bounded mean (f32 out)",
        "shapes": {"hm": list(hm.shape), "points": [B, V, N], "candidates": k, "out": "bf16"},
    })
    del px, py, bnd, hm
    rows[0]["launches_per_train_step"] = train_launches["sample_view"]
    rows[1]["launches_per_train_step"] = train_launches["sample_views_mean"]

    # sample_view_adjoint: the train step's PoseNet fold (2B), one view, all
    # K candidates' 64^3 cubes, J = 15, a seeded uniform cotangent
    pn = train_model.pose_net
    b12 = cat_branches(train_brs[0], train_brs[1])
    gc_t = train_model.do_inference(train_brs[2])[2]  # every candidate valid
    assert bool((gc_t[..., 3] >= 0).all())
    B2 = b12.batch_size
    grids = compute_grid(pn.grid_size, torch.cat([gc_t, gc_t])[..., :3], pn.cube_size)
    sg, inside = compute_sample_grid(grids.reshape(B2, 1, -1, 3), b12.cam, b12.trans,
                                     pn.image_wh, (W, H), b12.orig_wh)
    pxs, pys = to_pixels(sg, (W, H))  # (B2, V, N)
    px, py = pxs[:, 0].contiguous(), pys[:, 0].contiguous()
    lib_grid = sg[:, 0, None].contiguous()  # (B2, 1, N, 2)
    # (px, py, grid_sample grid) of every view: a train step's five launches
    per_view = [(pxs[:, v].contiguous(), pys[:, v].contiguous(), sg[:, v, None].contiguous())
                for v in range(sg.shape[1])]
    del sg, grids, pxs, pys
    N = px.shape[1]
    hm2 = torch.rand(B2, H, W, J, generator=g, device=px.device)
    cot = torch.rand(B2, N, J, generator=g, device=px.device)
    got = slicewarp.sample_view_adjoint(cot, px, py, (H, W))
    again = slicewarp.sample_view_adjoint(cot, px, py, (H, W))
    plain = slicewarp.sample_view_adjoint_plain(cot, px, py, (H, W))
    peak = float(plain.abs().max())
    err = float((got - plain).abs().max())
    # float32 sums of some thousand terms per texel, added in any order by
    # the kernel's atomics and by index_add_'s: 2e-5 of the largest gradient
    tol = 2e-5 * peak
    assert err <= tol, ("sample_view_adjoint", err, peak)
    plain64 = slicewarp.sample_view_adjoint_plain(cot.double(), px, py, (H, W))
    err64 = float((got.double() - plain64).abs().max())
    del plain64
    # <sample_view(h), g> == <h, adjoint(g)>, both sums in float64
    samp = slicewarp.sample_view(hm2, px, py)
    lhs = float((samp.double() * cot.double()).sum())
    rhs = float((hm2.double() * got.double()).sum())
    assert _rel(lhs, rhs) <= 1e-5, (lhs, rhs)
    fwd_err = float((samp - slicewarp.sample_view_plain(hm2, px, py)).abs().max())
    assert fwd_err <= 1e-5, ("sample_view J=15", fwd_err)
    del samp
    five_err = max(float((slicewarp.sample_view(hm2, pv, qv)
                          - slicewarp.sample_view_plain(hm2, pv, qv)).abs().max())
                   for pv, qv, _ in per_view)
    assert five_err <= 1e-5, ("sample_view J=15, five views", five_err)
    # the dense cotangent is the worst case: in a train step the rows of
    # points outside the view's image are exactly zero and the kernel skips
    # them (scripts/profile_torch_train.py times it on a step's own
    # cotangent); the step-like cotangent zeroes those rows here
    hm_nchw = hm2.permute(0, 3, 1, 2).contiguous().requires_grad_()
    lib_out = torch.nn.functional.grid_sample(hm_nchw, lib_grid, align_corners=True)

    def lib_call(c):
        c = c.permute(0, 2, 1)[:, :, None].contiguous()  # (B2, J, 1, N)
        return lambda: torch.autograd.grad(lib_out, hm_nchw, c, retain_graph=True)[0]

    lib_err = float((lib_call(cot)().permute(0, 2, 3, 1) - got).abs().max())
    # step-like: each view's launch on the same cotangent with the rows of
    # the points outside that view's image zeroed, as a train step's are
    steps = [(pv, qv, (cot * inside[:, v, :, None]).contiguous())
             for v, (pv, qv, _) in enumerate(per_view)]
    step_err, live = 0.0, int(inside.sum())
    for pv, qv, cv in steps:
        plain_v = slicewarp.sample_view_adjoint_plain(cv, pv, qv, (H, W))
        err_v = float((slicewarp.sample_view_adjoint(cv, pv, qv, (H, W)) - plain_v).abs().max())
        assert err_v <= 2e-5 * float(plain_v.abs().max()), ("adjoint step-like", err_v)
        step_err = max(step_err, err_v)
    del plain_v
    step_lib_outs = [torch.nn.functional.grid_sample(hm_nchw, gv, align_corners=True)
                     for _, _, gv in per_view]
    step_cots = [cv.permute(0, 2, 1)[:, :, None].contiguous() for _, _, cv in steps]

    def step_library():
        return [torch.autograd.grad(o, hm_nchw, c, retain_graph=True)[0]
                for o, c in zip(step_lib_outs, step_cots)]

    with torch.no_grad():
        hm_lib = hm2.permute(0, 3, 1, 2).contiguous()
        fwd_lib = torch.nn.functional.grid_sample(hm_lib, lib_grid, align_corners=True)
        fwd_lib_err = float((fwd_lib[:, :, 0].permute(0, 2, 1)
                             - slicewarp.sample_view(hm2, px, py)).abs().max())
        del fwd_lib
    # bytes: g, px, py read once, the heatmap gradient written once;
    # operations: 2 per tap and channel and 12 for the weights
    bms, by = bound(4 * (B2 * N * J + 2 * B2 * N + B2 * H * W * J), B2 * N * (8 * J + 12))
    fwd_bms, _ = bound(4 * (B2 * H * W * J + 2 * B2 * N + B2 * N * J), B2 * N * (8 * J + 12))
    # step-like, V launches: every row of g is read (to find the zeros), the
    # coordinates and operations only of the points inside each image
    nv = len(steps)
    step_bms, step_by = bound(4 * (nv * B2 * N * J + 2 * live + nv * B2 * H * W * J),
                              live * (8 * J + 12))
    rows.append({
        "name": "sample_view_adjoint", "route": "cuda", "source": SOURCE,
        "replaces": "selfpose3d_tpu/ops/slicewarp.py:1162 (_slice_warp_adjoint_kernel)",
        "launches": train_launches["sample_view_adjoint"], "max_abs_err": err,
        "max_abs_err_vs_float64_plain": err64, "max_abs_grad": peak,
        "tolerance": tol, "bit_equal_two_runs": bool(torch.equal(got, again)),
        "inner_product_rel_err": _rel(lhs, rhs),
        "ms": cuda_ms(lambda: slicewarp.sample_view_adjoint(cot, px, py, (H, W)), 20),
        "plain_ms": cuda_ms(lambda: slicewarp.sample_view_adjoint_plain(cot, px, py, (H, W)), 3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lib_call(cot), 10),
        "library": "torch.autograd.grad of F.grid_sample(align_corners=True, "
                   "padding_mode='zeros') w.r.t. its input",
        "library_max_abs_err": lib_err,
        "shapes": {"g": list(cot.shape), "hm": list(hm2.shape)},
        "step_like_cotangent": {
            "launches": nv, "rows_nonzero_share": live / (nv * B2 * N),
            "rows_nonzero_share_per_view": [float(inside[:, v].mean()) for v in range(nv)],
            "max_abs_err": step_err,
            "ms": cuda_ms(lambda: [slicewarp.sample_view_adjoint(cv, pv, qv, (H, W))
                                   for pv, qv, cv in steps], 10),
            "plain_ms": cuda_ms(lambda: [slicewarp.sample_view_adjoint_plain(cv, pv, qv, (H, W))
                                         for pv, qv, cv in steps], 2),
            "library_ms": cuda_ms(step_library, 5),
            "bound_ms": step_bms, "bound_by": step_by},
        "forward_at_these_shapes": {
            "name": "sample_view", "max_abs_err": fwd_err, "bound_ms": fwd_bms,
            "ms": cuda_ms(lambda: slicewarp.sample_view(hm2, px, py), 20),
            "plain_ms": cuda_ms(lambda: slicewarp.sample_view_plain(hm2, px, py), 3),
            "library_ms": cuda_ms(lambda: torch.nn.functional.grid_sample(
                hm_lib, lib_grid, align_corners=True), 20),
            "library": "F.grid_sample(align_corners=True, padding_mode='zeros')",
            "library_max_abs_err": fwd_lib_err,
            # a train step's five forward launches at these shapes, one a view
            "five_views": {
                "max_abs_err": five_err, "bound_ms": nv * fwd_bms,
                "inside_share_per_view": [float(inside[:, v].mean()) for v in range(nv)],
                "ms": cuda_ms(lambda: [slicewarp.sample_view(hm2, pv, qv)
                                       for pv, qv, _ in per_view], 10),
                "library_ms": cuda_ms(lambda: [torch.nn.functional.grid_sample(
                    hm_lib, gv, align_corners=True) for _, _, gv in per_view], 10)}},
    })
    return rows


def _headline(name, source, replaces, launches, variants, head, **extra):
    """A kernels-line row: the numbers of the variant ``head``, the largest
    error over all variants, every variant beside them."""
    h = variants[head]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for v in variants.values()),
            **{k: h[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "headline": head, **extra, "variants": variants}


def microbench_conv3():
    """conv3 at the probe's two shapes: the probe's measure() with the
    launch count set to 0 before and read after, then the kernel against
    its plain version on the same inputs (within one bf16 ulp, >= 99 %
    equal)."""
    variants, launches = {}, 0
    for i, name in enumerate(mb_conv3.SHAPES):
        x, w = mb_conv3.make_inputs(name, "cuda", seed=i)
        mb_conv3.reset_launches()
        res = mb_conv3.measure(name, x, w)
        torch.cuda.synchronize()
        n = mb_conv3.LAUNCHES["conv3"]
        launches += n
        got = mb_conv3.conv3(x, w).float()
        want = mb_conv3.conv3_plain(x, w).float()
        diff = (got - want).abs()
        ulps = float((diff / mb_conv3.bf16_ulp(torch.maximum(got.abs(), want.abs()))).max())
        equal = float((diff == 0).float().mean())
        err = float(diff.max())
        del got, want, diff, x, w
        torch.cuda.empty_cache()
        assert ulps <= 1.0 and equal >= 0.99, (name, ulps, equal)
        bk, ci, co = mb_conv3.SHAPES[name]
        vox = bk * mb_conv3.EDGE ** 3
        # bytes: input and output once (bf16), weights once; operations:
        # 2 * 27 * CI * CO a voxel at the bf16 tensor-core rate
        bms, by = bound(2 * (vox * (ci + co) + 27 * ci * co), 2 * 27 * ci * co * vox, BF16_FLOPS)
        variants[name] = {
            "shape": [bk, *(mb_conv3.EDGE,) * 3, ci, co], "launches": n, "max_abs_err": err,
            "max_err_in_bf16_ulps": ulps, "equal_share": equal,
            "relerr_vs_f32_conv3d_on_x[:1,:16]": res[f"{name}_relerr"],
            "ms": res[f"{name}_kernel_ms"], "plain_ms": res[f"{name}_plain_ms"],
            "library_ms": res[f"{name}_cudnn_ms"], "bound_ms": bms, "bound_by": by}
    return _headline(
        "conv3", "selfpose3d_tpu_torch/csrc/conv3.cu",
        "scripts/microbench_pallas_conv.py:29 (_kernel, called by pallas_conv3 :73)",
        launches, variants, "skip_res1_32to32",
        library="F.conv3d (cuDNN, bf16, channels-last-3d)")


def microbench_sw_variants():
    """The six slice-warp modes at the probe's shapes, each measured with
    the launch count set to 0 before and read after, then held against the
    plain version (1e-5; j1 on channel 0, the only one it writes)."""
    hm, xs, ys = mb_sw.make_inputs("cuda")
    variants, launches = {}, 0
    B, J, Wp, Hp = hm.shape
    xs_shape = list(xs.shape)
    for mode in mb_sw.MODES:
        mb_sw.reset_launches()
        res = mb_sw.measure(mode, hm, xs, ys)
        torch.cuda.synchronize()
        n = mb_sw.LAUNCHES["sw_variant"]
        launches += n
        ch = slice(0, 1) if mode == "j1" else slice(None)
        err = float((mb_sw.sw_variant(mode, hm, xs, ys)[:, :, :, ch]
                     - mb_sw.sw_variant_plain(mode, hm, xs, ys)[:, :, :, ch]).abs().max())
        torch.cuda.empty_cache()
        assert err <= 1e-5, (mode, err)
        w = mb_sw.work(mode, hm.shape, xs.shape)
        bms, by = bound(w["bytes"], w["flops"], smem_loads=w["smem_loads"])
        variants[mode] = {"launches": n, "max_abs_err": err, "ms": res[f"{mode}_ms"],
                          "plain_ms": res[f"{mode}_plain_ms"], "library_ms": None,
                          "bound_ms": bms, "bound_by": by,
                          "bound_share": bms / res[f"{mode}_ms"]}
    del hm, xs, ys
    torch.cuda.empty_cache()
    return _headline(
        "sw_variant", "selfpose3d_tpu_torch/csrc/sw_variants.cu",
        "scripts/microbench_sw_variants.py:21 (make_kernel)", launches, variants, "full",
        library="none: no one PyTorch call computes the column-hosted sampler",
        shapes={"hm": [B, J, Wp, Hp], "xs": xs_shape})


def microbench_primitives():
    """Parts A-C of the primitives probe (V2V bf16 and f32, the feats
    transpose, soft-argmax; no kernel of the port), then each body at
    REPS: measured with the launch count set to 0 before and read after,
    held exactly to its plain version, and timed at 200 and 400
    repetitions (the kernel must really repeat)."""
    parts = mb_prim.measure_posenet_parts("cuda", iters=3)
    torch.cuda.empty_cache()
    variants, launches = {}, 0
    reps = mb_prim.REPS
    for i, (body, (_, shape_out, key)) in enumerate(mb_prim.BODIES.items()):
        x = mb_prim.make_input(body, "cuda", seed=i)
        mb_prim.reset_launches()
        res = mb_prim.measure_body(body, x)
        torch.cuda.synchronize()
        n = mb_prim.LAUNCHES["primitive"]
        launches += n
        got = mb_prim.primitive(body, x, reps)
        want = mb_prim.primitive_plain(body, x, reps)
        assert torch.equal(got, want), body
        t200 = cuda_ms(lambda: mb_prim.primitive(body, x, 200), 20)
        t400 = cuda_ms(lambda: mb_prim.primitive(body, x, 400), 20)
        assert t400 >= 1.5 * t200, (body, t200, t400)
        w = mb_prim.work(body, reps)
        terms = bound_terms(w["bytes"], w["flops"], smem_loads=w["smem_loads"])
        bms, by = bound(w["bytes"], w["flops"], smem_loads=w["smem_loads"])
        lib = res[f"{key}_library_us_per_op"]
        variants[body] = {
            "launches": n, "max_abs_err": float((got - want).abs().max()),
            "us_per_op": res[f"{key}_us_per_op"],
            "ms": res[f"{key}_us_per_op"] * reps / 1e3,
            "plain_ms": res[f"{key}_plain_us_per_op"] * reps / 1e3,
            "library_ms": None if lib is None else lib * reps / 1e3,
            "bound_ms": bms, "bound_by": by, "bound_basis": max(terms, key=terms.get),
            "bound_terms_ms": terms,
            "bound_share": bms / (res[f"{key}_us_per_op"] * reps / 1e3),
            "band": mb_prim.BANDS[body],
            "blocks": shape_out[0] // mb_prim.BANDS[body],
            "ms_200_reps": t200, "ms_400_reps": t400}
    return _headline(
        "primitive", "selfpose3d_tpu_torch/csrc/microbench_primitives.cu",
        "scripts/microbench.py:99 (bench_kernel)", launches, variants, "transpose",
        reps=reps, sm_clock_max_mhz=SM_CLOCK_HZ / 1e6,
        library="per repetition: torch.add(a.t(), i, out=...) (transposes), "
        "torch.gather with its index built before (gather); none for cmp_add",
        posenet_parts_ms=parts)


def phase_microbench():
    """The three probes; returns their kernels-line rows."""
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "selfpose3d_tpu"))
    assert not loaded, loaded
    rows = [microbench_conv3(), microbench_sw_variants(), microbench_primitives()]
    emit({"phase": "microbench", "rows": [
        {k: r[k] for k in ("name", "launches", "max_abs_err", "ms", "plain_ms", "library_ms",
                           "bound_ms", "headline")} for r in rows]})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_card()
    model, launches_main, br, gc = phase_main()
    phase_geometry(model)
    phase_parity()
    train_model, train_brs, train_launches = phase_train()
    phase_train_parity()
    sup, paths = phase_supervised()
    stages = phase_stages()
    paths = {"do_inference": launches_main, "SSV train step": train_launches, **paths,
             "stage 1 step": stages["stage1"]["launches_per_step"],
             "stage 2 step": stages["stage2"]["launches_per_step"]}
    rows = phase_kernels(model, br, gc, launches_main, train_model, train_brs, train_launches)
    del model, br, gc, train_model, train_brs
    torch.cuda.empty_cache()
    phase_kernels_supervised(rows, sup, paths)
    del sup
    torch.cuda.empty_cache()
    rows += phase_microbench()
    for row in rows:
        assert row["launches"] > 0, row["name"]
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 3)})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
