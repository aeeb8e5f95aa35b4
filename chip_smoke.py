#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. card     nvidia-smi name and power limit, torch/CUDA versions, and the
              build of every CUDA kernel from csrc/ (one nvcc per source,
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
  7. kernels  each kernel at its main path's shapes and sample points (with
              seeded uniform heatmaps), held against its plain version,
              timed beside it, beside its bound, and beside one PyTorch
              library call where one computes the same function; the
              adjoint also on a step-like cotangent (each of the five
              views' launches with the rows of points outside that view's
              image zeroed), and sample_view also at the train shapes;
  8. microbench  the three measurement probes (selfpose3d_tpu_torch/
              microbench/: conv3, sw_variants, primitives) at their full
              shapes, each probe's measurement driven with its kernel's
              launch count set to 0 just before and read just after; then
              each kernel held against its plain version on the same
              inputs (conv3 within one bf16 ulp, the six slice-warp modes
              1e-5 on the entries each defines, the four primitive bodies
              exactly), the primitive kernel's time at 400 repetitions at
              least 1.5 times its time at 200, and no module of JAX or of
              the JAX package loaded.
Then the kernels line, and last {"ok": true, "device": {...}}. Any failed
check raises and the script exits non-zero. It needs a CUDA device and
exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
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
from selfpose3d_tpu_torch.train import create_train_state, make_ssv_train_step  # noqa: E402
from selfpose3d_tpu_torch.geometry.grid import compute_grid  # noqa: E402
from selfpose3d_tpu_torch.microbench import conv3 as mb_conv3  # noqa: E402
from selfpose3d_tpu_torch.microbench import primitives as mb_prim  # noqa: E402
from selfpose3d_tpu_torch.microbench import sw_variants as mb_sw  # noqa: E402
from selfpose3d_tpu_torch.microbench.common import card_line, cuda_ms  # noqa: E402
from selfpose3d_tpu_torch.ops import build, slicewarp  # noqa: E402
from selfpose3d_tpu_torch.ops.unproject import compute_sample_grid, to_pixels  # noqa: E402

# H100 SXM published peaks (HBM3 bandwidth, dense FP32 rate)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
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


def bound(bytes_moved, flops, peak=F32_FLOPS):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# the kernels redesigned for Hopper in the latest slice: the card phase
# prints their registers, static shared memory and spills
REDESIGNED = ("conv3_kernel", "sample_view_adjoint_kernel")


def ptxas_figures(log, names=REDESIGNED):
    """{kernel: {"registers", "smem_bytes" (static), "spill_stores",
    "spill_loads"}} from an ``nvcc -Xptxas -v`` log, for the kernels whose
    mangled name contains one of ``names`` (a template instance as
    ``name<N>``; the dynamic shared memory a launch asks for is not in the
    log: see the sources)."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = next((n for n in names if n in m.group(1)), None)
            t = fn and re.search(fn + r"I((?:Li\d+E)+)E", m.group(1))
            fn = f"{fn}<{','.join(re.findall(r'Li(\d+)E', t.group(1)))}>" if t else fn
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
    smi = card_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = build.build()
    for name in built:
        build.library(name)
    ptxas = [ln.strip() for info in built.values() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "card", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
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
    rows.append({
        "name": "sample_views_mean", "route": "cuda", "source": SOURCE,
        "replaces": "selfpose3d_tpu/ops/slicewarp.py:664 (_slice_warp_agg_kernel)",
        "launches": launches["sample_views_mean"], "max_abs_err": err,
        "max_abs_err_f32_out": err32,
        "ms": cuda_ms(lambda: slicewarp.sample_views_mean(hm, px, py, bnd, out), 20),
        "plain_ms": cuda_ms(lambda: slicewarp.sample_views_mean_plain(hm, px, py, bnd, out), 3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": None,
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
            "library_max_abs_err": fwd_lib_err},
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
    pts = xs.numel() // B
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
        nch = 1 if mode == "j1" else J
        # bytes: the planes read, xs and ys once, the written channels once
        # (f32); operations: about 8 a point and channel and 12 a point
        bms, by = bound(4 * (B * nch * Wp * Hp + 2 * B * pts + B * pts * nch),
                        B * pts * (8 * nch + 12))
        variants[mode] = {"launches": n, "max_abs_err": err, "ms": res[f"{mode}_ms"],
                          "plain_ms": res[f"{mode}_plain_ms"], "library_ms": None,
                          "bound_ms": bms, "bound_by": by}
    del hm, xs, ys
    torch.cuda.empty_cache()
    return _headline(
        "sw_variant", "selfpose3d_tpu_torch/csrc/sw_variants.cu",
        "scripts/microbench_sw_variants.py:21 (make_kernel)", launches, variants, "full",
        library="none: no one PyTorch call computes the column-hosted sampler",
        shapes={"hm": [B, J, Wp, Hp], "xs": xs_shape})


# operations a repetition does on one output element
PRIMITIVE_OPS = {"gather": 4, "transpose": 1, "cmp_add": 2, "transpose_64x256": 1}


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
    for i, (body, (shape_in, shape_out, key)) in enumerate(mb_prim.BODIES.items()):
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
        elems_in, elems_out = shape_in[0] * shape_in[1], shape_out[0] * shape_out[1]
        written = elems_out // 2 if body == "transpose_64x256" else elems_out
        bms, by = bound(4 * (elems_in + elems_out), reps * written * PRIMITIVE_OPS[body])
        lib = res[f"{key}_library_us_per_op"]
        variants[body] = {
            "launches": n, "max_abs_err": float((got - want).abs().max()),
            "us_per_op": res[f"{key}_us_per_op"],
            "ms": res[f"{key}_us_per_op"] * reps / 1e3,
            "plain_ms": res[f"{key}_plain_us_per_op"] * reps / 1e3,
            "library_ms": None if lib is None else lib * reps / 1e3,
            "bound_ms": bms, "bound_by": by, "ms_200_reps": t200, "ms_400_reps": t400}
    return _headline(
        "primitive", "selfpose3d_tpu_torch/csrc/microbench_primitives.cu",
        "scripts/microbench.py:99 (bench_kernel)", launches, variants, "transpose",
        reps=reps, library="per repetition: torch.add(a.t(), i, out=...) (transposes), "
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
    model, launches, br, gc = phase_main()
    phase_geometry(model)
    phase_parity()
    train_model, train_brs, train_launches = phase_train()
    phase_train_parity()
    rows = phase_kernels(model, br, gc, launches, train_model, train_brs, train_launches)
    del model, br, gc, train_model, train_brs
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
