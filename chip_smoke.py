#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. card     nvidia-smi name and power limit, torch/CUDA versions, and the
              build of every CUDA kernel from csrc/ (one nvcc per source,
              all started together);
  2. main     flagship do_inference (ResNet-50, 5 x 960x512 views, 80x80x20
              root grid, 64^3 pose cubes, bf16, batch 8, random weights from
              a seed) on the synthetic scene: shapes, finite outputs, and
              every kernel's launch count during that one call;
  3. geometry the RootNet unprojection of rendered heatmaps lights the voxel
              nearest every person's root (> 0.5) and equals the CPU's plain
              version;
  4. parity   a small float32 model gives the same proposals and poses on
              the card as on the CPU;
  5. kernels  each kernel at the main path's shapes and sample points (with
              seeded uniform heatmaps), held against its plain version,
              timed beside it, beside its bound, and beside one PyTorch
              library call where one computes the same function.
Then the kernels line, and last {"ok": true, "device": {...}}. Any failed
check raises and the script exits non-zero. It needs a CUDA device and
exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from selfpose3d_tpu_torch.config import flagship_cfg, load_config  # noqa: E402
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch  # noqa: E402
from selfpose3d_tpu_torch.models import get_model  # noqa: E402
from selfpose3d_tpu_torch.geometry.grid import compute_grid  # noqa: E402
from selfpose3d_tpu_torch.ops import build, slicewarp  # noqa: E402
from selfpose3d_tpu_torch.ops.unproject import compute_sample_grid, to_pixels  # noqa: E402

# H100 SXM published peaks (HBM3 bandwidth, dense FP32 rate)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
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


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of one call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved, flops):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
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
          "ptxas": ptxas})


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


def phase_kernels(model, br, gc, launches):
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
    rows = phase_kernels(model, br, gc, launches)
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 3)})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
