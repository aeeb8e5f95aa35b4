#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. card     nvidia-smi name and power limit, the highest SM clock (the
              shared-memory load rate of the bounds), torch/CUDA versions,
              and the build of every CUDA kernel from csrc/ (one nvcc per source)
              and of the host JPEG codec (csrc/image_codec.cpp, the host C++
              compiler), all started together, with the registers, static
              shared memory and spills of the redesigned kernels
              (REDESIGNED) and the codec's build seconds;
  1b. codec   the port's JPEG codec on a machine without OpenCV: the
              committed fixtures (tests/torch_fixtures/jpeg/: each chroma
              sampling, grey, a restart interval, optimised tables) decode
              to OpenCV's decodes beside them, and encode_jpeg of the
              committed source writes cv2.imencode's bytes; the host ms
              (median of 20) of a decode of one 1920x1080 4:2:0 q95 JPEG of
              a rendered mini_panoptic view and of a noise frame, the ms of
              one encode of a debug grid (the views_pred dump's 2880x1024),
              and 12 decodes on 6 threads against one (the GIL is released
              in the codec);
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
  9. engine   the training engine on synthetic scenes: (a) cam5_posenet.yaml
              at its full width (ResNet-50, 5 x 960x512, bf16, train batch
              1, test batch 4, WORKERS 6) on the synthetic datasets with
              THRESHOLD -100 (as phase train) and PRINT_FREQ 1 (every
              step timed): one train_epoch_ssv of 6 frames, validate_3d on
              8 frames, save_checkpoint, load_checkpoint into a fresh model
              and train state (parameters, BatchNorm statistics and Adam
              moments bit-equal to the saved ones), one more epoch from
              the resumed state; steps/s, the loop's data and batch times,
              peak memory, the validation metrics and each sampler's
              launches per train step and per validation batch, held as
              derived from the config's flags; (b) run_convergence of
              configs/synthetic/magnitude_ssv.yaml as it loads (ResNet-18,
              3 x 256x128, rendered images, batch 4), 2 epochs of 16
              frames, an evaluation after each: 8 steps, every loss series
              finite, the launches of the whole run as derived;
 10. realdata the host side for real data, through
              selfpose3d_tpu_torch/mini_panoptic.py: a mini CMU Panoptic
              tree in the panoptic-toolbox layout under build/ (the 13 sequences of
              the train and validation lists, one frame each of 2-3
              people, calibration and hdPose3d_stage1_coco19 JSON, 5 HD
              views rendered at 1920x1080 and stored as JPEG at quality 95
              by the port's encoder), the pseudo labels of stages s1-s8 with a fake
              detector and pose model (projected GT plus seeded noise),
              one epoch of cli/train_3d on cam5_posenet.yaml as it loads
              through panoptic_ssv (9 frames: decode, warp, RandAugment
              and Cutout of 15 images a frame), THRESHOLD -100, DEBUG.DEBUG
              with PRINT_FREQ 1 (the 3D plots stay off: no matplotlib),
              the stage files of the YAML replaced by one reference-layout
              file of the seeded model, validation on panoptic (4 frames),
              cli/evaluate --vis-attn on the epoch's checkpoint saved as a
              reference .pth.tar, track_sequence over its dump: launches a
              train step, a debug dump and a validation batch (as the loops
              record them, with every count set to 0 before the train CLI)
              and of evaluate held as derived, every debug JPEG non-blank, the metrics
              finite; steps/s, data-wait share, the host ms of one SSV
              frame from disk and peak memory beside the card's line;
 11. ddp      data parallelism (parallel/mesh.py): (a) cam5_posenet.yaml as
              phase engine loads it (THRESHOLD -100, batch 1, bf16), over
              nccl at world size 1 (the group formed by init_distributed
              from torchrun's variables): two steps each of a plain path,
              a second plain path and a DDP path, the first step's loss
              terms within 1e-2 rel (bf16), the first step's gradients
              and Adam update (relative L2 per net) within three times
              the two plain paths' spread and at least 1e-2, the second
              step's terms reported beside that spread; then 20 timed
              steps a path, plain and DDP alternating (median, least,
              most: the wrapper's cost), each step's peak memory above
              what stays resident, each step's sampler launches as
              derived; (a') cli.train_3d --distributed as
              torch.distributed.run starts a process at world size 1 on
              the same YAML with random weights, an epoch of 4 synthetic
              frames, its validation and checkpoint (which a fresh train
              state loads), its launches read from the CLI's report; (b) two gloo ranks spawned on the one
              card (nccl takes one rank a GPU) at one example each of
              small_train_cfg (float32, L1 and PoseNet stages) against one
              process at two, with batch statistics and with BatchNorm on
              its running statistics: loss terms, gradients, running
              statistics and parameters after Adam within
              parallel/check.py:BARS, both ranks bit-equal, each rank's
              launches as derived. Its numbers are a correctness check and
              the wrapper's cost, not scaling: there is one card;
 12. kernels  each kernel at its main path's shapes and sample points (with
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
              sample_views_mean on the supervised forward's cubes), then
              at the magnitude run's (sample_view with J = 1 over RootNet's
              whole 32x32x16 space for the 3-branch fold, with J = 15 and
              its adjoint on a step-like cotangent over PoseNet's 16^3
              cubes for the 2-branch fold, each a launch a view;
              sample_views_mean on a validation batch's cubes), and
              every sampler's launches on each path;
 13. microbench  the three measurement probes (selfpose3d_tpu_torch/
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

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from selfpose3d_tpu_torch.config import flagship_cfg, get_model_name, load_config  # noqa: E402
from selfpose3d_tpu_torch.data.loader import collate_branch  # noqa: E402
from selfpose3d_tpu_torch.data.registry import get_dataset  # noqa: E402
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch  # noqa: E402
from selfpose3d_tpu_torch.models import get_model  # noqa: E402
from selfpose3d_tpu_torch.models.multi_person import cat_branches  # noqa: E402
from selfpose3d_tpu_torch.models.norm import BatchNorm2d, BatchNorm3d  # noqa: E402
from selfpose3d_tpu_torch.train import (  # noqa: E402
    create_train_state, make_ssv_train_step, make_supervised_train_step)
from selfpose3d_tpu_torch.geometry.grid import compute_grid  # noqa: E402
from selfpose3d_tpu_torch.microbench import conv3 as mb_conv3  # noqa: E402
from selfpose3d_tpu_torch.microbench import primitives as mb_prim  # noqa: E402
from selfpose3d_tpu_torch.microbench import sw_variants as mb_sw  # noqa: E402
from selfpose3d_tpu_torch.microbench.common import (  # noqa: E402
    card_line, cuda_ms, sm_clock_max_mhz)
from selfpose3d_tpu_torch.mini_panoptic import image_inked, render_view, run_realdata  # noqa: E402
from selfpose3d_tpu_torch.ops import build, slicewarp  # noqa: E402
from selfpose3d_tpu_torch.ops.unproject import compute_sample_grid, to_pixels  # noqa: E402
from selfpose3d_tpu_torch.parallel import check as ddp_check  # noqa: E402
from selfpose3d_tpu_torch.parallel import mesh  # noqa: E402
from selfpose3d_tpu_torch.train import distribute  # noqa: E402
from selfpose3d_tpu_torch.train import checkpoint  # noqa: E402
from selfpose3d_tpu_torch.train.convergence import report, run_convergence  # noqa: E402
from selfpose3d_tpu_torch.train.loop import train_epoch_ssv, validate_3d  # noqa: E402
from selfpose3d_tpu_torch.utils import image_io, jpeg  # noqa: E402

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
    built = build.build(build.SOURCES + build.HOST_SOURCES)
    for name in built:
        build.library(name)
    ptxas = [ln.strip() for info in built.values() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    host = {k: round(built[k]["seconds"], 3) for k in build.HOST_SOURCES}
    print(f"card: host codec built in {host} s by {build.cxx()} ({smi})", flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "sm_clock_max_mhz": SM_CLOCK_HZ / 1e6,
          "build_s": round(time.perf_counter() - t0, 3),
          "nvcc_s": {k: round(v["seconds"], 3) for k, v in built.items() if k in build.SOURCES},
          "host_cxx_s": host, "host_cxx": build.cxx(),
          "ptxas": ptxas,
          "ptxas_redesigned": {fn: fig for info in built.values()
                               for fn, fig in ptxas_figures(info["log"]).items()}})


JPEG_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")


def _median_ms(fn, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_codec():
    """The port's JPEG codec, held to OpenCV's committed output and timed on
    the host (no OpenCV here)."""
    from concurrent.futures import ThreadPoolExecutor

    smi = card_line()
    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)

    def read(name):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            return f.read()

    for case in manifest["decode"]:
        got = jpeg.decode_jpeg(read(case["jpeg"]), case["mode"])
        want = image_io.decode(read(case["want"]), color=case["mode"] == "color")
        assert got is not None and got.shape == want.shape and (got == want).all(), case
    for case in manifest["encode"]:
        src = image_io.decode(read(case["source"]))
        assert jpeg.encode_jpeg(src, case["quality"]) == read(case["want"]), case
    view = render_view((1920, 1080), seed=0)
    noise = np.random.RandomState(0).randint(0, 256, (1080, 1920, 3), np.uint8)
    grid = np.concatenate([np.concatenate([view[:512, :960]] * 3, 1)] * 2, 0)  # 2880x1024
    files = {"rendered view": jpeg.encode_jpeg(view), "noise frame": jpeg.encode_jpeg(noise)}
    for data in files.values():
        assert jpeg.decode_jpeg(data).shape == (1080, 1920, 3)
    # the round trip of the (noisy) render: cv2.imwrite and imread give 4.31
    # levels mean on this view, and the codec writes cv2's bytes
    assert np.abs(jpeg.decode_jpeg(files["rendered view"]).astype(int) - view).mean() < 6
    rep = {"fixtures": len(manifest["decode"]) + len(manifest["encode"]),
           "opencv_of_fixtures": manifest["opencv"], "card": smi,
           "jpeg_bytes": {k: len(v) for k, v in files.items()}}
    for name, data in files.items():
        rep[f"decode ms, 1920x1080 4:2:0 q95 {name} (median of 20)"] = _median_ms(
            lambda: jpeg.decode_jpeg(data), 20)
    rep["encode ms, 2880x1024 debug grid q95 (median of 5)"] = _median_ms(
        lambda: jpeg.encode_jpeg(grid), 5)
    data = files["rendered view"]
    one = _median_ms(lambda: [jpeg.decode_jpeg(data) for _ in range(12)], 3)
    with ThreadPoolExecutor(6) as pool:
        six = _median_ms(lambda: list(pool.map(jpeg.decode_jpeg, [data] * 12)), 3)
    rep["12 decodes of the rendered view, ms: one thread, six threads"] = [one, six]
    for k, v in rep.items():
        if "ms" in k:
            print(f"codec: {k} {v} ({smi})", flush=True)
    emit(json_finite({"phase": "codec", **rep}))


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


FLAGSHIP_YAML = "configs/panoptic_ssl/resnet50/cam5_posenet.yaml"
MAGNITUDE_YAML = "configs/synthetic/magnitude_ssv.yaml"


def ssv_step_launches(cfg):
    """Sampler launches of one SSV train step in the PoseNet stage, from the
    flags: RootNet once a view over branch 3 when frozen, else over the
    3-branch fold and again for the synthetic roots; PoseNet once a view
    over the 2-branch fold; the adjoint behind PoseNet's when the backbone
    trains (RootNet's heatmaps are detached under ROOTNET_ROOTHM)."""
    V, n = cfg.DATASET.CAMERA_NUM, cfg.NETWORK
    root = V if n.FREEZE_ROOTNET else V * (2 if n.ROOTNET_TRAIN_SYNTH else 1)
    return sampler_counts(root + V, 0, V if n.TRAIN_BACKBONE else 0)


def times(counts, n):
    return {k: v * n for k, v in counts.items()}


def finite_meters(meters):
    vals = {k: m.avg for k, m in meters.items() if hasattr(m, "avg")}
    assert all(math.isfinite(v) for v in vals.values()), vals


def epoch_report(meters):
    """steps/s, the loop's mean data and batch times (ms), data share and
    host syncs of one epoch's ``meters_out``."""
    return {"steps": meters["steps"], "seconds": meters["seconds"],
            "steps_per_s": meters["steps"] / meters["seconds"],
            "data_ms_mean": meters["data_time"].avg * 1e3,
            "batch_ms_mean": meters["batch_time"].avg * 1e3,
            "data_share": meters["data_time"].sum / meters["seconds"],
            "host_syncs": meters["host_syncs"],
            "losses": {k: m.avg for k, m in meters.items()
                       if k.startswith("loss") and hasattr(m, "avg")}}


def engine_flagship():
    """(a): cam5_posenet.yaml at full width on the synthetic datasets."""
    cfg = load_config(os.path.join(ROOT, FLAGSHIP_YAML), overrides={
        "DATASET": {"TRAIN_DATASET": "synthetic", "TEST_DATASET": "synthetic"},
        "MULTI_PERSON": {"THRESHOLD": -100.0}, "PRINT_FREQ": 1})
    train_ds = get_dataset(cfg, cfg.DATASET.TRAIN_DATASET, cfg.DATASET.TRAIN_SUBSET, True)
    test_ds = get_dataset(cfg, cfg.DATASET.TEST_DATASET, cfg.DATASET.TEST_SUBSET, False)
    train_ds.num_frames, test_ds.num_frames = 6, 8
    steps = len(train_ds) // cfg.TRAIN.BATCH_SIZE
    batches = -(-len(test_ds) // cfg.TEST.BATCH_SIZE)
    per_step, per_batch = ssv_step_launches(cfg), sampler_counts(cfg.DATASET.CAMERA_NUM, 1, 0)
    model = get_model(cfg, device="cuda", seed=0)
    state = create_train_state(cfg, model, steps)
    torch.cuda.reset_peak_memory_stats()

    slicewarp.reset_launches()
    m0 = {}
    train_epoch_ssv(cfg, model, state, train_ds, epoch=0, meters_out=m0)
    got = dict(slicewarp.LAUNCHES)
    assert m0["steps"] == steps and state.step == steps, (m0["steps"], state.step)
    assert got == times(per_step, steps), (got, per_step)
    finite_meters(m0)

    slicewarp.reset_launches()
    metrics = {}
    t0 = time.perf_counter()
    precision = validate_3d(cfg, model, test_ds, metrics_out=metrics)
    val_s = time.perf_counter() - t0
    got = dict(slicewarp.LAUNCHES)
    assert got == times(per_batch, batches), (got, per_batch)
    assert precision is not None and all(math.isfinite(a) for a in metrics["aps"])

    out_dir = os.path.join(ROOT, "build", "chip_smoke_engine")
    path = checkpoint.save_checkpoint(out_dir, state, 1, precision, is_best=True)
    fresh = get_model(cfg, device="cuda", seed=1)
    resumed, epoch, _ = checkpoint.load_checkpoint(out_dir, create_train_state(cfg, fresh, steps))
    assert epoch == 1 and resumed.step == state.step
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert b.device == a.device and torch.equal(a, b), k
    saved, loaded = state.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert saved and set(saved) == set(loaded)
    moments = 0
    for i in saved:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            a, b = saved[i][name], loaded[i][name]
            assert a.device == b.device and torch.equal(a, b), (i, name)
            moments += 1
    ckpt_bytes = os.path.getsize(path)
    shutil.rmtree(out_dir)
    n_tensors = len(model.state_dict())
    n_stats = sum(1 for k in model.state_dict() if "running_" in k)
    del model, state
    torch.cuda.empty_cache()

    slicewarp.reset_launches()
    m1 = {}
    train_epoch_ssv(cfg, fresh, resumed, train_ds, epoch=1, meters_out=m1)
    got = dict(slicewarp.LAUNCHES)
    assert got == times(per_step, steps) and resumed.step == 2 * steps, (got, resumed.step)
    finite_meters(m1)
    return per_step, per_batch, {
        "config": FLAGSHIP_YAML, "changed": {
            "DATASET.TRAIN_DATASET": "synthetic", "DATASET.TEST_DATASET": "synthetic",
            "MULTI_PERSON.THRESHOLD": -100.0, "PRINT_FREQ": 1},
        "dtype": cfg.DTYPE, "train_batch": cfg.TRAIN.BATCH_SIZE,
        "test_batch": cfg.TEST.BATCH_SIZE, "workers": cfg.WORKERS,
        "train_frames": len(train_ds), "test_frames": len(test_ds),
        "epoch0": epoch_report(m0), "epoch1_resumed": epoch_report(m1),
        "validation": {"batches": batches, "seconds": val_s, "precision": precision,
                       "host_syncs": metrics["host_syncs"],
                       **{k: metrics[k] for k in ("aps", "mpjpe", "recall500", "aps_root",
                                                  "mpjpe_root", "recall500_root")}},
        "checkpoint": {"path": os.path.relpath(path, ROOT), "bytes": ckpt_bytes,
                       "state_dict_tensors_bit_equal": n_tensors, "of_them_bn_statistics": n_stats,
                       "adam_entries_bit_equal": moments},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches_per_train_step": per_step, "launches_per_validation_batch": per_batch}


def engine_magnitude():
    """(b): the magnitude curriculum's config at its YAML width, two epochs."""
    path = os.path.join(ROOT, MAGNITUDE_YAML)
    cfg = load_config(path)
    slicewarp.reset_launches()
    res = run_convergence(path, epochs=2, num_frames=16, device="cuda", eval_every=1)
    got = dict(slicewarp.LAUNCHES)
    report(res)
    steps = 2 * 16 // cfg.TRAIN.BATCH_SIZE
    assert res["steps"] == steps, res["steps"]
    for k, v in res["series"].items():
        assert len(v) == steps and all(math.isfinite(x) for x in v), k
    assert [m["epoch"] for m in res["eval_curve"]] == [1, 2]
    # evaluations: before, after each epoch, after the run; 64 test frames
    batches = 4 * -(-64 // cfg.TEST.BATCH_SIZE)
    per_step = ssv_step_launches(cfg)
    per_batch = sampler_counts(cfg.DATASET.CAMERA_NUM, 1, 0)
    expect = {k: per_step[k] * steps + per_batch[k] * batches for k in SAMPLERS}
    assert got == expect, (got, expect)
    return got, {
        "config": MAGNITUDE_YAML, "epochs": 2, "frames": 16, "steps": res["steps"],
        "seconds": res["seconds"], "train_seconds": res["train_seconds"],
        "steps_per_s": res["steps"] / res["train_seconds"],
        "data_share": res["data_seconds"] / res["train_seconds"],
        "eval_init": res["eval_init"], "eval_curve": res["eval_curve"],
        "eval_final": res["eval_final"], "launches_per_train_step": per_step,
        "launches_per_validation_batch": per_batch, "validation_batches": batches,
        "launches_whole_run": got}


def json_finite(x):
    """``x`` with every non-finite float as None (an empty match gives an
    infinite MPJPE), so that the phase's line is strict JSON."""
    if isinstance(x, dict):
        return {k: json_finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_finite(v) for v in x]
    return None if isinstance(x, float) and not math.isfinite(x) else x


def phase_engine():
    """Phase 9; returns the engine's paths' launch counts."""
    step_f, batch_f, flagship = engine_flagship()
    torch.cuda.empty_cache()
    whole, magnitude = engine_magnitude()
    emit(json_finite({"phase": "engine", "flagship": flagship, "magnitude": magnitude}))
    return {"engine train step (cam5_posenet.yaml)": step_f,
            "engine validation batch (cam5_posenet.yaml)": batch_f,
            "engine magnitude run, 2 epochs (magnitude_ssv.yaml)": whole}


# ------------------------------------------------------------------ realdata

REALDATA_DIR = os.path.join(ROOT, "build", "chip_smoke_realdata")
def phase_realdata():
    """Phase realdata; returns its paths' launch counts."""
    smi = card_line()
    rep = run_realdata(REALDATA_DIR, os.path.join(ROOT, FLAGSHIP_YAML))
    cfg = rep.pop("cfg")
    rep["config"] = FLAGSHIP_YAML
    rep["changed"]["DATA_DIR"] = os.path.relpath(rep["changed"]["DATA_DIR"], ROOT)
    V = cfg.DATASET.CAMERA_NUM
    steps = rep["train_frames"] // cfg.TRAIN.BATCH_SIZE
    batches = -(-rep["dump_frames"] // cfg.TEST.BATCH_SIZE)
    per_step = ssv_step_launches(cfg)
    # the debug forward (no gradient, train=False): RootNet on branch 3 and
    # PoseNet's cubes through the view mean, as inference
    per_dump = sampler_counts(V, 1, 0)
    per_batch = sampler_counts(V, 1, 0)
    got = rep["launches"]
    meters = rep["epoch"]
    assert meters["steps"] == steps and rep["dumps"] == -(-steps // cfg.PRINT_FREQ), (
        meters["steps"], rep["dumps"])
    assert got["train"] == times(per_step, steps), (got["train"], per_step)
    assert got["debug"] == times(per_dump, rep["dumps"]), (got["debug"], per_dump)
    assert got["validate"] == times(per_batch, batches), (got["validate"], per_batch)
    # --vis-attn: one do_inference over the first (up to 4) frames, then validation
    assert got["evaluate"] == times(per_batch, batches + 1), (got["evaluate"], per_batch)
    finite_meters(meters)
    val = rep["validation"]
    assert all(math.isfinite(a) for a in val["aps"] + [val["recall500"]]), val
    assert rep["evaluate"]["precision"] is not None and math.isfinite(rep["evaluate"]["precision"])
    assert rep["dump_frames"] == len(rep["tracks"]) > 0
    stems = [f"train_0_{i}" for i in range(0, steps, cfg.PRINT_FREQ)]
    want = [f"{s}_{k}.jpg" for s in stems for k in ("gt", "hm_pred", "views_pred")]
    assert rep["debug_files"] == sorted(want), (rep["debug_files"], want)
    blank = [f for f in want if not image_inked(os.path.join(rep["debug_dir"], f))]
    assert not blank, blank
    print("realdata: DEBUG.SAVE_3D_POSES and SAVE_3D_ROOTS stay off: the 3D plots need "
          "matplotlib, which this machine may lack; the 2D dumps are JPEG", flush=True)
    for name, value in (("steps/s", meters["steps"] / meters["seconds"]),
                        ("data-wait share", meters["data_time"].sum / meters["seconds"]),
                        ("host ms to build one SSV frame from disk (15 images)",
                         sorted(rep["ssv_frame_from_disk_ms"])[1]),
                        ("debug dumps' share of the epoch (forward and JPEG writing)",
                         rep["debug_dump_seconds"] / meters["seconds"]),
                        ("peak memory GiB", rep["peak_mem_gib"])):
        print(f"realdata: {name} {value} ({smi})", flush=True)
    rep["epoch"] = epoch_report(meters)
    rep["launches_per_train_step"], rep["launches_per_debug_dump"] = per_step, per_dump
    rep["launches_per_validation_batch"], rep["validation_batches"] = per_batch, batches
    rep["card"] = smi
    emit(json_finite({"phase": "realdata", **rep}))
    shutil.rmtree(REALDATA_DIR)
    return {"realdata train step (cam5_posenet.yaml, panoptic_ssv)": per_step,
            "realdata debug dump (cam5_posenet.yaml, panoptic_ssv)": per_dump,
            "realdata validation batch (cam5_posenet.yaml, panoptic)": per_batch}


# ----------------------------------------------------------------------- ddp

DDP_DIR = os.path.join(ROOT, "build", "chip_smoke_ddp")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


DDP_TIMED = 20  # timed steps a path of (a), the paths alternating
DDP_CLI_FRAMES = 4  # synthetic frames a split of (a)'s CLI epoch
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _torchrun_env():
    """torch.distributed.run's variables for one process on this card."""
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(_free_port()))


def _ddp_path(cfg, wrap):
    """The model of seed 0, its train state and its SSV step (PoseNet and
    L1 stages), through ``distribute`` when ``wrap``."""
    model = get_model(cfg, device="cuda", seed=0)
    state = create_train_state(cfg, model)
    step = make_ssv_train_step(distribute(model, cfg) if wrap else model,
                               train_posenet_stage=True, use_l1_stage=True)
    return {"model": model, "state": state, "step": step,
            "gen": torch.Generator().manual_seed(0)}


def _host_params(model):
    return {k: p.detach().float().cpu() for k, p in model.named_parameters() if p.requires_grad}


def _first_steps(path, branches):
    """A path's first two steps -> each step's loss terms and sampler
    launches, the first step's gradients as the optimizer saw them and
    its update of each trainable parameter (float32, on the host)."""
    grads, before = {}, _host_params(path["model"])
    apply = path["state"].apply_gradients

    def record_and_apply():
        if not grads:
            grads.update({k: p.grad.detach().float().cpu()
                          for k, p in path["model"].named_parameters() if p.grad is not None})
        apply()

    path["state"].apply_gradients = record_and_apply
    losses, launches = [], []
    for i in range(2):
        slicewarp.reset_launches()
        metrics = path["step"](path["state"], *branches, generator=path["gen"])
        losses.append({k: float(v) for k, v in metrics.items()})
        launches.append(dict(slicewarp.LAUNCHES))
        if i == 0:
            update = {k: v - before[k] for k, v in _host_params(path["model"]).items()}
    del path["state"].apply_gradients  # the class's method again, no reference cycle
    return losses, grads, launches, update


def _terms_rel(a, b):
    return {k: abs(a[k] - v) / max(abs(v), 1e-6) for k, v in b.items()}


def _grads_l2(a, b):
    """Per net, the relative L2 distance of gradients ``a`` from ``b``."""
    out = {}
    for net in ddp_check.NETS:
        keys = [k for k in b if k.startswith(net)]
        if keys:
            diff = sum(float((a[k] - b[k]).pow(2).sum()) for k in keys)
            norm = sum(float(b[k].pow(2).sum()) for k in keys)
            out[net.rstrip(".")] = (diff / max(norm, 1e-30)) ** 0.5
    return out


def _spread(ms):
    ms = sorted(ms)
    return {"median": ms[len(ms) // 2], "min": ms[0], "max": ms[-1], "each": ms}


def ddp_world_1():
    """(a): cam5_posenet.yaml at full width, DDP over nccl at world size 1
    against the plain step, same seed and frames. Two plain paths and the
    DDP path take two steps each. The second plain path gives the plain
    step's own run to run spread (cuDNN's backward algorithms and the
    adjoint kernel's atomic adds sum in any order, and batch-statistics
    BatchNorm's backward amplifies that to ~1.4e-2 of the backbone's
    gradient), which bounds, per net, how far the DDP path's first
    gradients and first Adam update may stray from the first plain
    path's. The second step's loss terms are reported, not bounded: two
    plain runs already differ there by percents (Adam's first step takes
    the sign of gradients that noise decides). Then DDP_TIMED steps a
    path, the paths alternating."""
    cfg = load_config(os.path.join(ROOT, FLAGSHIP_YAML),
                      overrides={"MULTI_PERSON": {"THRESHOLD": -100.0}})
    branches = train_branches(cfg, cfg.TRAIN.BATCH_SIZE, seed=0, device="cuda")
    per_step = ssv_step_launches(cfg)
    _torchrun_env()
    try:
        dev = mesh.init_distributed()
        assert dev == torch.device("cuda", 0) and torch.distributed.get_backend() == "nccl"
        paths, first, resident = {}, {}, {}
        for name, wrap in (("plain", False), ("plain again", False), ("ddp", True)):
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            paths[name] = _ddp_path(cfg, wrap)
            first[name] = _first_steps(paths[name], branches)
            resident[name] = (torch.cuda.memory_allocated() - before) / 2 ** 30
            if name == "plain again":
                del paths[name]
                torch.cuda.empty_cache()
        ms, peak = {"plain": [], "ddp": []}, {"plain": 0.0, "ddp": 0.0}
        launches = {"plain": [], "ddp": []}
        for i in range(DDP_TIMED):
            for name in ("plain", "ddp") if i % 2 == 0 else ("ddp", "plain"):
                p = paths[name]
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                slicewarp.reset_launches()
                t0 = time.perf_counter()
                p["step"](p["state"], *branches, generator=p["gen"])
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
                launches[name].append(dict(slicewarp.LAUNCHES))
                peak[name] = max(peak[name],
                                 (torch.cuda.max_memory_allocated() - before) / 2 ** 30)
        del paths, p
        torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
        for k in TORCHRUN_VARS:
            os.environ.pop(k, None)
    for name in first:
        runs = first[name][2] + launches.get(name, [])
        assert all(c == per_step for c in runs), (name, runs, per_step)
        for terms in first[name][0]:
            assert all(math.isfinite(v) for v in terms.values()), (name, terms)
    plain, again, ddp = (first[k] for k in ("plain", "plain again", "ddp"))
    rel = [_terms_rel(ddp[0][i], plain[0][i]) for i in range(2)]
    noise = [_terms_rel(again[0][i], plain[0][i]) for i in range(2)]
    # the first step: the same work on the same weights, within bf16's
    # rounding; the first gradients and Adam's first update: per net
    # within three times the plain path's own run to run spread, and at
    # least 1e-2
    assert set(rel[0]) == set(ddp[0][0]) and max(rel[0].values()) <= 1e-2, rel[0]
    assert set(ddp[1]) == set(plain[1]), "the DDP step's gradients cover other parameters"
    g, g_noise = _grads_l2(ddp[1], plain[1]), _grads_l2(again[1], plain[1])
    u, u_noise = _grads_l2(ddp[3], plain[3]), _grads_l2(again[3], plain[3])
    for what, got, spread in (("gradients", g, g_noise), ("Adam's update", u, u_noise)):
        bad = {k: (v, spread[k]) for k, v in got.items() if v > max(1e-2, 3 * spread[k])}
        assert not bad, (f"first step's {what}, relative L2 per net", bad)
    return per_step, {
        "config": FLAGSHIP_YAML, "changed": {"MULTI_PERSON.THRESHOLD": -100.0},
        "dtype": cfg.DTYPE, "batch": cfg.TRAIN.BATCH_SIZE, "backend": "nccl", "world": 1,
        "first_two_steps_losses": {k: v[0] for k, v in first.items()},
        "loss_terms_max_rel_diff": {"step 1": max(rel[0].values()), "step 2": max(rel[1].values()),
                                    "step 2, plain run to run": max(noise[1].values())},
        "first_step_grads_rel_l2": {"ddp": g, "plain run to run": g_noise},
        "first_update_rel_l2": {"ddp": u, "plain run to run": u_noise},
        "timed_steps": DDP_TIMED, "ms_per_step": {k: _spread(v) for k, v in ms.items()},
        "ddp_minus_plain_median_ms": _spread(ms["ddp"])["median"] - _spread(ms["plain"])["median"],
        "resident_gib": resident, "step_peak_above_resident_gib": peak,
        "launches_per_step": {k: v[2][0] for k, v in first.items()}}


def ddp_cli():
    """(a'): ``cli.train_3d --distributed`` as torch.distributed.run starts
    a process (its variables, nccl at world size 1) on cam5_posenet.yaml
    with random weights: an epoch of DDP_CLI_FRAMES synthetic frames, its
    validation on as many, its checkpoint, which a fresh train state
    loads. The sampler launches are read from the CLI's report."""
    from selfpose3d_tpu_torch.cli import train_3d

    path = os.path.join(ROOT, FLAGSHIP_YAML)
    out = os.path.join(DDP_DIR, "cli")
    sets = {"DATASET.TRAIN_DATASET": "synthetic", "DATASET.TEST_DATASET": "synthetic",
            "MULTI_PERSON.THRESHOLD": -100.0, "PRINT_FREQ": 1, "DEBUG.DEBUG": False,
            "NETWORK.PRETRAINED_BACKBONE": "", "NETWORK.INIT_ROOTNET": "",
            "TRAIN.END_EPOCH": 1, "OUTPUT_DIR": out, "LOG_DIR": out}
    values = [f"{k}={json.dumps(v)}" for k, v in sets.items()]
    argv = ["--cfg", path, "--distributed"] + [a for v in values for a in ("--set", v)]
    cfg = train_3d.load_cli_config(argparse.Namespace(cfg=path, set=values))
    datasets = train_3d.datasets

    def cut(c):
        splits = datasets(c)
        for ds in splits:
            ds.num_frames = DDP_CLI_FRAMES
        return splits

    train_3d.datasets = cut
    _torchrun_env()
    rep = {}
    slicewarp.reset_launches()
    t0 = time.perf_counter()
    try:
        precision = train_3d.main(argv, report=rep)
    finally:
        train_3d.datasets = datasets
        for k in TORCHRUN_VARS:
            os.environ.pop(k, None)
    seconds = time.perf_counter() - t0
    launched = dict(slicewarp.LAUNCHES)
    assert not torch.distributed.is_initialized(), "the CLI left its group formed"
    meters, val = rep["epoch"], rep["validation"]
    steps = DDP_CLI_FRAMES // cfg.TRAIN.BATCH_SIZE
    batches = -(-DDP_CLI_FRAMES // cfg.TEST.BATCH_SIZE)
    per_step, per_batch = ssv_step_launches(cfg), sampler_counts(cfg.DATASET.CAMERA_NUM, 1, 0)
    assert meters["steps"] == steps, meters["steps"]
    assert meters["launches"] == times(per_step, steps), (meters["launches"], per_step)
    assert val["launches"] == times(per_batch, batches), (val["launches"], per_batch)
    assert launched == {k: meters["launches"][k] + val["launches"][k] for k in launched}, launched
    finite_meters(meters)
    assert precision is not None and all(math.isfinite(a) for a in val["aps"])
    run_dir = os.path.join(out, cfg.DATASET.TRAIN_DATASET, get_model_name(cfg)[0],
                           os.path.basename(path).split(".")[0])
    fresh = get_model(cfg, device="cuda", seed=1)
    state, epoch, _ = checkpoint.load_checkpoint(run_dir, create_train_state(cfg, fresh))
    assert epoch == 1 and state.step == steps, (epoch, state.step)
    del fresh, state
    torch.cuda.empty_cache()
    return per_step, {
        "argv": [os.path.relpath(a, ROOT) if a.startswith(ROOT) else a for a in argv],
        "frames": DDP_CLI_FRAMES, "seconds": seconds, "epoch": epoch_report(meters),
        "validation_batches": batches, "precision": precision,
        "launches": {"train": meters["launches"], "validation": val["launches"]},
        "checkpoint_loads_at_step": steps}


PAIR_CASES = ("ssv", "ssv_bn_eval")
PAIR_EPOCH = small_train_cfg().TRAIN.L1_EPOCH  # the PoseNet and L1 stages


def _pair_branches():
    return train_branches(small_train_cfg(), 2, seed=0, device="cpu")


# BatchNorm layers of the flagship's kinds in bfloat16: a backbone layer
# (unmasked) and a PoseNet V2V layer (masked, the mask's examples on both
# ranks): (global input shape, mask)
BN_CASES = {"2d": ((4, 64, 64, 120), None), "3d masked": ((4, 32, 16, 16, 16), [1, 0, 1, 1])}


def bn_bf16_case():
    """The port's train-mode BatchNorm on this rank's rows of each BN_CASES
    input, bfloat16 on the card (across ranks the fused kernels of
    models/norm.py:_GlobalBatchNorm; in one process torch's batch norm and
    the masked branch) -> per case the output and input gradient of
    sum(y * cot) (this rank's rows), this rank's share of the weight's and
    bias's gradients, the running statistics, and the bytes autograd keeps
    for the backward beside the input's."""
    out = {}
    for name, (shape, mask) in BN_CASES.items():
        gen = torch.Generator().manual_seed(7)
        x = torch.randn(shape, generator=gen) * 2.0 + 0.5
        cot = torch.randn(shape, generator=gen)
        b, r = shape[0] // mesh.world(), mesh.rank()
        rows = slice(r * b, (r + 1) * b)
        bn = (BatchNorm2d if len(shape) == 4 else BatchNorm3d)(shape[1]).cuda().train()
        xr = x[rows].cuda().bfloat16().requires_grad_()
        m = None if mask is None else torch.tensor(mask[rows], dtype=torch.bool).cuda()
        kept = [0]

        def keep(t):
            kept[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
            y = bn(xr, m)
        (y.float() * cot[rows].cuda()).sum().backward()
        host = {"y": y.detach().float(), "dx": xr.grad.float(), "dw": bn.weight.grad,
                "db": bn.bias.grad, "mean": bn.running_mean, "var": bn.running_var}
        out[name] = {k: v.cpu().numpy() for k, v in host.items()}  # pickled by value
        out[name].update(saved=kept[0], x_bytes=xr.numel() * xr.element_size())
    return out


def compare_bn(ranks, one):
    """The ranks' bn_bf16_case against one process's: output and input
    gradient as relative L2, the weight and bias gradients (the ranks'
    sum) as the largest error over the largest entry, the running
    statistics' excess over rel 1e-4; each case's bytes kept."""
    out = {}
    for name, want in one.items():
        got = [r[name] for r in ranks]
        res = {}
        for k in ("y", "dx"):
            d = np.concatenate([g[k] for g in got]) - want[k]
            res[k] = float(np.linalg.norm(d) / np.linalg.norm(want[k]))
        for k in ("dw", "db"):
            res[k] = float(np.abs(got[0][k] + got[1][k] - want[k]).max() / np.abs(want[k]).max())
        res["stats_excess"] = max(float((np.abs(g[k] - want[k]) - 1e-4 * np.abs(want[k])).max())
                                  for g in got for k in ("mean", "var"))
        res["kept_over_input_bytes"] = [g["saved"] - g["x_bytes"] for g in got]
        out[name] = res
    return out


def _ddp_rank(rank, workdir, queues):
    """A rank of the gloo pair on the one card: the small config's SSV
    step on this rank's example of the pair's batch of 2, in both BatchNorm
    modes, and the bfloat16 BatchNorm cases; rank 0 sends its records to
    the main process, both ranks their BatchNorm results."""
    torch.cuda.set_device(0)
    store = torch.distributed.FileStore(os.path.join(workdir, "store"), 2)
    torch.distributed.init_process_group("gloo", store=store, rank=rank, world_size=2)
    recs = {}
    try:
        for name in PAIR_CASES:
            recs[name] = ddp_check.train_step_record(
                small_train_cfg(), _pair_branches(), device="cuda", epoch=PAIR_EPOCH,
                bn_eval=name.endswith("_bn_eval"))
        queues["bn"].put((rank, bn_bf16_case()))
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        for name in PAIR_CASES:
            queues[name].put(ddp_check.pack(recs[name]))
        for _ in PAIR_CASES:
            queues["ack"].get()


def _receive(q, ctx):
    """The next item of ``q``, raising the ranks' error if one fails first."""
    import queue
    while True:
        try:
            return q.get(timeout=5)
        except queue.Empty:
            if ctx.join(timeout=0):
                raise RuntimeError("the ranks ended without sending their records")


def ddp_gloo_pair():
    """(b): two gloo ranks on the one card (nccl takes one rank a GPU) at
    one example each against one process at 2 on the card."""
    import torch.multiprocessing as tmp
    shutil.rmtree(DDP_DIR, ignore_errors=True)  # a failed run's store would hang the rendezvous
    os.makedirs(DDP_DIR)
    smp = tmp.get_context("spawn")
    queues = {name: smp.Queue() for name in PAIR_CASES + ("ack", "bn")}
    ctx = tmp.spawn(_ddp_rank, args=(DDP_DIR, queues), nprocs=2, join=False)
    cfg = small_train_cfg()
    out, per_step = {}, ssv_step_launches(cfg)
    for name in PAIR_CASES:
        one = ddp_check.train_step_record(cfg, _pair_branches(), device="cuda", epoch=PAIR_EPOCH,
                                          bn_eval=name.endswith("_bn_eval"))
        got = ddp_check.unpack(_receive(queues[name], ctx))
        c = ddp_check.compare(got, one)
        queues["ack"].put(name)
        bad = {k: v for k, v in ddp_check.failures(c, name.endswith("_bn_eval")).items() if v}
        assert not bad, (name, bad)
        assert got["launches"] == one["launches"] == per_step, (got["launches"], per_step)
        out[name] = {
            "loss_terms_max_rel": max(c["terms"].values()),
            "running_stats_excess_over_rel_bar": c["stats_excess"],
            "grad_tensor_share_max": max(c["grad_share"].values()),
            "grad_net": c["nets"],
            "params_after_adam_max_abs_decided": max(v[0] for v in c["params"].values()),
            "params_after_adam_max_abs": max(v[1] for v in c["params"].values()),
            "ranks_bit_equal": c["ranks_equal"], "launches_per_rank_step": got["launches"],
            "losses_mean_over_ranks": got["metrics"], "losses_one_process": one["metrics"]}
    ranks = dict(_receive(queues["bn"], ctx) for _ in range(2))
    bn = compare_bn([ranks[0], ranks[1]], bn_bf16_case())
    # bfloat16 rounds the output and the input gradient once on either
    # path: relative L2 1e-2; the float32 sums of the weight and bias
    # gradients 1e-2 of their largest entry; running statistics as BARS;
    # no float32 copy of the input kept (its bytes and 4 KiB of vectors)
    for name, r in bn.items():
        assert max(r["y"], r["dx"], r["dw"], r["db"]) <= 1e-2, (name, r)
        assert r["stats_excess"] <= ddp_check.BARS["stats_abs"], (name, r)
        assert all(0 <= k <= 4096 for k in r["kept_over_input_bytes"]), (name, r)
    out["batchnorm_bf16"] = bn
    while not ctx.join():
        pass
    shutil.rmtree(DDP_DIR)
    return per_step, out


def phase_ddp():
    """Phase ddp; returns its paths' launch counts."""
    smi = card_line()
    t0 = time.perf_counter()
    per_step, one = ddp_world_1()
    ms = one["ms_per_step"]
    print(f"ddp: world size 1 over nccl, cam5_posenet.yaml batch 1 bf16, {DDP_TIMED} steps a "
          f"path alternating: ms per step median (min, max) plain {ms['plain']['median']} "
          f"({ms['plain']['min']}, {ms['plain']['max']}) ddp {ms['ddp']['median']} "
          f"({ms['ddp']['min']}, {ms['ddp']['max']}); step peak above resident GiB plain "
          f"{one['step_peak_above_resident_gib']['plain']} ddp "
          f"{one['step_peak_above_resident_gib']['ddp']}, resident GiB plain "
          f"{one['resident_gib']['plain']} ddp {one['resident_gib']['ddp']}; loss terms max rel "
          f"diff {one['loss_terms_max_rel_diff']}; first step's gradients rel L2 "
          f"{one['first_step_grads_rel_l2']}; first Adam update rel L2 "
          f"{one['first_update_rel_l2']} ({smi})", flush=True)
    cli_step, cli = ddp_cli()
    print(f"ddp: cli.train_3d --distributed, world size 1 over nccl, cam5_posenet.yaml, "
          f"{cli['frames']} synthetic frames: {cli['seconds']} s with validation and checkpoint, "
          f"steps/s {cli['epoch']['steps_per_s']} ({smi})", flush=True)
    pair_step, pair = ddp_gloo_pair()
    for name in PAIR_CASES:
        r = pair[name]
        print(f"ddp: gloo pair on one card vs one process, small f32 {name}: loss terms max rel "
              f"{r['loss_terms_max_rel']}, gradient tensor share max "
              f"{r['grad_tensor_share_max']}, parameters after Adam max abs (decided) "
              f"{r['params_after_adam_max_abs_decided']}, running statistics excess "
              f"{r['running_stats_excess_over_rel_bar']}, launches a rank step "
              f"{r['launches_per_rank_step']} ({smi}; a correctness check, not a scaling "
              f"number: one card)", flush=True)
    print(f"ddp: gloo pair on one card vs one process, bfloat16 BatchNorm (y, dx relative L2; "
          f"dw, db over their largest; bytes kept beyond the input's): "
          f"{pair['batchnorm_bf16']} ({smi})", flush=True)
    emit({"phase": "ddp", "world_1_nccl": one, "cli_world_1_nccl": cli, "gloo_pair": pair,
          "bars": ddp_check.BARS, "seconds": time.perf_counter() - t0, "card": smi})
    return {"ddp step, world size 1 over nccl (cam5_posenet.yaml)": per_step,
            "ddp cli train step, world size 1 over nccl (cam5_posenet.yaml)": cli_step,
            "ddp gloo pair, rank step (small f32)": pair_step}


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


def views_row(hm, views, reps):
    """sample_view of ``hm`` (B, H, W, J) at every view's points (the
    (px, py, grid, inside) tuples of whole_space_points), one launch a
    view as the path makes them: the largest error against the plain
    version over the views (bar 1e-5), the launches' time beside the plain
    versions', F.grid_sample's on the same grids and their bound (bytes,
    priced as the rows above, times the views)."""
    B, H, W, J = hm.shape
    N = views[0][0].shape[1]
    err = max(float((slicewarp.sample_view(hm, px, py)
                     - slicewarp.sample_view_plain(hm, px, py)).abs().max())
              for px, py, _, _ in views)
    assert err <= 1e-5, ("sample_view", list(hm.shape), err)
    hm_nchw = hm.permute(0, 3, 1, 2).contiguous()
    lib_err = max(float((torch.nn.functional.grid_sample(hm_nchw, grid, align_corners=True)
                         [:, :, 0].permute(0, 2, 1) - slicewarp.sample_view(hm, px, py))
                        .abs().max()) for px, py, grid, _ in views)
    n = len(views)
    bms, by = bound(n * 4 * (B * H * W * J + 2 * B * N + B * N * J), n * B * N * (8 * J + 12))
    return {
        "shapes": {"hm": [B, H, W, J], "points": [B, N], "launches": n},
        "inside_share_per_view": [float(v[3].float().mean()) for v in views],
        "max_abs_err": err, "bound_ms": bms, "bound_by": by,
        "ms": cuda_ms(lambda: [slicewarp.sample_view(hm, px, py) for px, py, _, _ in views],
                      reps),
        "plain_ms": cuda_ms(lambda: [slicewarp.sample_view_plain(hm, px, py)
                                     for px, py, _, _ in views], 3),
        "library_ms": cuda_ms(lambda: [torch.nn.functional.grid_sample(
            hm_nchw, grid, align_corners=True) for _, _, grid, _ in views], reps),
        "library": "F.grid_sample(align_corners=True, padding_mode='zeros'), one call a view",
        "library_max_abs_err": lib_err}


def phase_kernels_magnitude(rows):
    """The three samplers at the magnitude run's shapes (magnitude_ssv.yaml
    as it loads: V = 3 views of 64x32 heatmaps, train and test batch 4,
    float32; the model at random weights from seed 0 on the datasets'
    first frames, THRESHOLD -100 keeping all K = 5 candidates, as the step
    runs them without bucket dispatch), each on seeded uniform heatmaps:
    sample_view with J = 1 over RootNet's whole 32x32x16 space for the
    train step's 3-branch fold (3B = 12); sample_view with J = 15 and its
    adjoint over PoseNet's 16^3 cubes for the 2-branch fold (2B = 8), the
    adjoint on a step-like cotangent (the rows of the points outside each
    view's image zeroed; 2e-5 of its largest entry against the plain
    version and 1e-5 against the float64 one, and the identity bar);
    sample_views_mean on a validation batch's cubes (B = 4, float32 out,
    1e-5). Every view's launch, as the path makes them, timed beside the
    plain versions, the bound (bytes) and a library call. Adds them to
    ``rows`` (sample_view, sample_views_mean, sample_view_adjoint)."""
    cfg = load_config(os.path.join(ROOT, MAGNITUDE_YAML))
    W, H = cfg.NETWORK.HEATMAP_SIZE
    J, V = cfg.NETWORK.NUM_JOINTS, cfg.DATASET.CAMERA_NUM
    dev = torch.device("cuda")
    model = get_model(cfg, device=dev, seed=0)
    train_ds = get_dataset(cfg, cfg.DATASET.TRAIN_DATASET, cfg.DATASET.TRAIN_SUBSET, True)
    test_ds = get_dataset(cfg, cfg.DATASET.TEST_DATASET, cfg.DATASET.TEST_SUBSET, False)
    frames = [train_ds.get_ssv_frame(i) for i in range(cfg.TRAIN.BATCH_SIZE)]
    b1, b2, b3 = (collate_branch([f[k] for f in frames]).to(dev) for k in range(3))
    test_br = collate_branch([test_ds.get_frame(i)["views"]
                              for i in range(cfg.TEST.BATCH_SIZE)]).to(dev)
    g = torch.Generator(device=dev).manual_seed(2)

    # RootNet: the root channel over the whole space, 3-branch fold
    fold = cat_branches(b1, b2, b3)
    views = [whole_space_points(model.root_net, fold, (W, H), v) for v in range(V)]
    hm1 = torch.rand(fold.batch_size, H, W, 1, generator=g, device=dev)
    rows[0]["magnitude_rootnet_j1"] = views_row(hm1, views, 100)
    del views, hm1

    # PoseNet: every candidate's cube, 2-branch fold, forward and adjoint
    pn = model.pose_net
    with torch.no_grad():
        gc = model.do_inference(b3)[2]
    assert bool((gc[..., 3] >= 0).all()) and gc.shape[1] == cfg.MULTI_PERSON.MAX_PEOPLE_NUM
    fold = cat_branches(b1, b2)
    B2 = fold.batch_size
    grids = compute_grid(pn.grid_size, torch.cat([gc, gc])[..., :3], pn.cube_size)
    sg, inside = compute_sample_grid(grids.reshape(B2, 1, -1, 3), fold.cam, fold.trans,
                                     pn.image_wh, (W, H), fold.orig_wh)
    pxs, pys = to_pixels(sg, (W, H))
    views = [(pxs[:, v].contiguous(), pys[:, v].contiguous(), sg[:, v, None].contiguous(),
              inside[:, v].contiguous()) for v in range(V)]
    del sg, grids, pxs, pys
    N = views[0][0].shape[1]
    hm2 = torch.rand(B2, H, W, J, generator=g, device=dev)
    rows[0]["magnitude_posenet_j15"] = views_row(hm2, views, 50)

    cot = torch.rand(B2, N, J, generator=g, device=dev)
    steps = [(px, py, (cot * ins[..., None]).contiguous()) for px, py, _, ins in views]
    err = err64 = peak = bar = ident = 0.0
    for px, py, c in steps:
        got = slicewarp.sample_view_adjoint(c, px, py, (H, W))
        plain = slicewarp.sample_view_adjoint_plain(c, px, py, (H, W))
        plain64 = slicewarp.sample_view_adjoint_plain(c.double(), px, py, (H, W))
        p = float(plain64.abs().max())
        e, e64 = float((got - plain).abs().max()), float((got.double() - plain64).abs().max())
        assert e <= 2e-5 * float(plain.abs().max()) and e64 <= 1e-5 * p, ("adjoint", e, e64, p)
        lhs = float((slicewarp.sample_view(hm2, px, py).double() * c.double()).sum())
        rhs = float((hm2.double() * got.double()).sum())
        b = identity_bar(hm2, px, py, c)
        assert abs(lhs - rhs) <= b, ("adjoint identity", lhs, rhs, b)
        err, err64, peak = max(err, e), max(err64, e64), max(peak, p)
        ident, bar = max(ident, abs(lhs - rhs)), max(bar, b)
    del got, plain, plain64
    hm_req = hm2.permute(0, 3, 1, 2).contiguous().requires_grad_()
    lib_outs = [torch.nn.functional.grid_sample(hm_req, grid, align_corners=True)
                for _, _, grid, _ in views]
    lib_cots = [c.permute(0, 2, 1)[:, :, None].contiguous() for _, _, c in steps]
    lib_err = max(float((torch.autograd.grad(o, hm_req, c, retain_graph=True)[0]
                         .permute(0, 2, 3, 1)
                         - slicewarp.sample_view_adjoint(s[2], s[0], s[1], (H, W))).abs().max())
                  for o, c, s in zip(lib_outs, lib_cots, steps))
    # every row of g is read (to find the zeros), the coordinates and the
    # operations only of the points inside each image
    live = int(inside.sum())
    bms, by = bound(4 * (V * B2 * N * J + 2 * live + V * B2 * H * W * J), live * (8 * J + 12))
    rows[2]["magnitude_posenet_step_like"] = {
        "shapes": {"g": [B2, N, J], "hm": [B2, H, W, J], "launches": V},
        "rows_nonzero_share": live / (V * B2 * N), "max_abs_err": err,
        "max_abs_err_vs_float64_plain": err64, "max_abs_grad": peak,
        "identity_abs_err": ident, "identity_bar": bar, "bound_ms": bms, "bound_by": by,
        "ms": cuda_ms(lambda: [slicewarp.sample_view_adjoint(c, px, py, (H, W))
                               for px, py, c in steps], 50),
        "plain_ms": cuda_ms(lambda: [slicewarp.sample_view_adjoint_plain(c, px, py, (H, W))
                                     for px, py, c in steps], 3),
        "library_ms": cuda_ms(lambda: [torch.autograd.grad(o, hm_req, c, retain_graph=True)[0]
                                       for o, c in zip(lib_outs, lib_cots)], 20),
        "library": "torch.autograd.grad of F.grid_sample(align_corners=True) w.r.t. its "
                   "input, one call a view",
        "library_max_abs_err": lib_err}
    del views, steps, cot, hm2, hm_req, lib_outs, lib_cots, inside

    # sample_views_mean: a validation batch's cubes of every candidate
    with torch.no_grad():
        gc = model.do_inference(test_br)[2]
    B, k = test_br.batch_size, pn.bucket(gc)
    grids = compute_grid(pn.grid_size, gc[:, :k, :3], pn.cube_size).reshape(B, -1, 3)
    sg, bnd = compute_sample_grid(grids[:, None], test_br.cam, test_br.trans, pn.image_wh,
                                  (W, H), test_br.orig_wh)
    px, py = to_pixels(sg, (W, H))
    del sg, grids
    N = px.shape[-1]
    hm = torch.rand(B, V, H, W, J, generator=g, device=dev)
    err = float((slicewarp.sample_views_mean(hm, px, py, bnd)
                 - slicewarp.sample_views_mean_plain(hm, px, py, bnd)).abs().max())
    assert err <= 1e-5, ("sample_views_mean, magnitude", err)
    bms, by = bound(4 * (B * V * H * W * J + 3 * B * V * N + B * N * J),
                    B * N * (V * (8 * J + 12) + 3 * J))
    hm_views = hm.reshape(B * V, H, W, J).permute(0, 3, 1, 2)
    grid_views = torch.stack([px / (W - 1) * 2 - 1, py / (H - 1) * 2 - 1], -1).reshape(
        B * V, 1, N, 2)
    rows[1]["magnitude_validation"] = {
        "shapes": {"hm": [B, V, H, W, J], "points": [B, V, N], "candidates": k, "out": "f32"},
        "max_abs_err": err, "bound_ms": bms, "bound_by": by,
        "ms": cuda_ms(lambda: slicewarp.sample_views_mean(hm, px, py, bnd), 50),
        "plain_ms": cuda_ms(lambda: slicewarp.sample_views_mean_plain(hm, px, py, bnd), 3),
        "library_ms": None,
        "library_sampling_only_ms": cuda_ms(lambda: torch.nn.functional.grid_sample(
            hm_views, grid_views, align_corners=True), 50)}
    del model, hm, hm_views, grid_views, px, py, bnd
    torch.cuda.empty_cache()


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
    phase_codec()
    model, launches_main, br, gc = phase_main()
    phase_geometry(model)
    phase_parity()
    train_model, train_brs, train_launches = phase_train()
    phase_train_parity()
    sup, paths = phase_supervised()
    stages = phase_stages()
    engine = phase_engine()
    engine.update(phase_realdata())
    torch.cuda.empty_cache()
    engine.update(phase_ddp())
    torch.cuda.empty_cache()
    paths = {"do_inference": launches_main, "SSV train step": train_launches, **paths,
             "stage 1 step": stages["stage1"]["launches_per_step"],
             "stage 2 step": stages["stage2"]["launches_per_step"], **engine}
    rows = phase_kernels(model, br, gc, launches_main, train_model, train_brs, train_launches)
    del model, br, gc, train_model, train_brs
    torch.cuda.empty_cache()
    phase_kernels_supervised(rows, sup, paths)
    del sup
    torch.cuda.empty_cache()
    phase_kernels_magnitude(rows)
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
