"""s4's top-down HRNet in the port (``models/pose_hrnet.py``) and its batched
path (``pseudo_labels/inference.py:topdown_keypoints``) on the CPU.

Bars: the network's heatmaps, with and without the flip test, within 1e-4
(relative L2) of the benchmark's plain float32 reference
(``portbench/reference/hrnet.py``, which imports nothing of the port) on
seeded weights, at the published structure with widths 8/16/32/64 on
128x96 crops (the smallest 4:3 crop whose 1/32 branch is whole, so that the
nearest upsampling meets its finer branch); the state dict in the
published layout, with HRNet-W48's 63.6 M parameters; the device crop
within ``utils/image_io.warp_affine``'s bar (1 level, mean under 0.01);
the benchmark's FLOP count against ``torch.utils.flop_counter``; the decode
against a hand-placed peak; the grouping of images into calls and the
padding of their boxes; ``run_topdown_keypoints`` with the default model
writing s5's contract; a checkpoint round trip.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from selfpose3d_tpu_torch.geometry.transforms import get_affine_transform_3x3
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.models.pose_hrnet import W48_EXTRA, PoseHighResolutionNet
from selfpose3d_tpu_torch.pseudo_labels import inference, pipeline
from selfpose3d_tpu_torch.train.checkpoint import CheckpointKeyError, load_pose_hrnet
from selfpose3d_tpu_torch.utils import image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench.reference import hrnet as ref_hrnet  # noqa: E402

SMALL_EXTRA = {"FINAL_CONV_KERNEL": 1, **{
    f"STAGE{s}": dict(W48_EXTRA[f"STAGE{s}"],
                      NUM_CHANNELS=tuple(c // 6 for c in W48_EXTRA[f"STAGE{s}"]["NUM_CHANNELS"]))
    for s in (2, 3, 4)}}
# one module of one block a branch: the s4 function's test, not the network's
TINY_EXTRA = {"FINAL_CONV_KERNEL": 1, **{
    f"STAGE{s}": dict(SMALL_EXTRA[f"STAGE{s}"], NUM_MODULES=1,
                      NUM_BLOCKS=(1,) * len(SMALL_EXTRA[f"STAGE{s}"]["NUM_BLOCKS"]))
    for s in (2, 3, 4)}}
IN_HW = (128, 96)


def _small_cfg(extra=SMALL_EXTRA):
    return inference.s4_config({"DTYPE": "float32", "MODEL_EXTRA": extra,
                                "NETWORK": {"IMAGE_SIZE": [IN_HW[1], IN_HW[0]],
                                            "HEATMAP_SIZE": [IN_HW[1] // 4, IN_HW[0] // 4]}})


def _seeded(spec, seed=0):
    """Weights with spread, as the benchmark draws them: fan-in-scaled
    kernels, BatchNorm near identity, each residual branch's last scale at 0.1."""
    g = torch.Generator().manual_seed(seed)
    P = {}
    for k, (shape, kind) in spec.items():
        if kind == "count":
            P[k] = torch.zeros(shape, dtype=torch.int64)
        elif kind in ("bn_weight", "bn_var", "bn_last"):
            P[k] = (0.75 + 0.5 * torch.rand(shape, generator=g)) * (0.1 if kind == "bn_last" else 1.0)
        elif kind == "conv":
            P[k] = torch.randn(shape, generator=g) / float(np.prod(shape[1:])) ** 0.5
        else:
            P[k] = 0.05 * torch.randn(shape, generator=g)
    return P


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The networks here are small: one intra-op thread runs them faster than
    several, and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    """The port's small HRNet with seeded weights and its reference."""
    model = get_model(_small_cfg(), device="cpu")
    P = _seeded(ref_hrnet.param_spec(SMALL_EXTRA, 17))
    model.load_state_dict(P)
    return model, ref_hrnet.HRNetReference(P, SMALL_EXTRA, (IN_HW[1], IN_HW[0])), P


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("flip", [False, True])
def test_heatmaps_match_the_reference(small, flip):
    model, ref, _ = small
    crops = torch.randn(1, *IN_HW, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = inference._flip_test_heatmaps(model, crops, flip, True)
        want = ref.heatmaps(crops.permute(0, 3, 1, 2), flip=flip, shift=True)
    assert got.shape == (1, IN_HW[0] // 4, IN_HW[1] // 4, 17)
    assert _rel(got.permute(0, 3, 1, 2), want) < 1e-4


def test_state_dict_has_the_published_layout():
    with torch.device("meta"):
        net = PoseHighResolutionNet(17, W48_EXTRA)
    sd = net.state_dict()
    spec = ref_hrnet.param_spec(W48_EXTRA, 17)
    assert list(sd) == list(spec)  # names and their order, as the published model registers them
    assert all(tuple(sd[k].shape) == tuple(spec[k][0]) for k in sd)
    for k in ("conv1.weight", "bn2.running_var", "layer1.0.downsample.0.weight",
              "transition1.0.0.weight", "transition1.1.0.0.weight", "transition2.2.0.0.weight",
              "transition3.3.0.0.weight", "stage2.0.branches.0.0.conv1.weight",
              "stage2.0.fuse_layers.0.1.0.weight", "stage2.0.fuse_layers.1.0.0.0.weight",
              "stage3.3.fuse_layers.2.0.1.1.running_mean", "stage4.2.fuse_layers.0.3.0.weight",
              "final_layer.weight", "final_layer.bias"):
        assert k in sd, k
    assert "stage4.2.fuse_layers.1.0.0.0.weight" not in sd  # the last module fuses into branch 0 only
    n = sum(v.numel() for k, v in net.named_parameters())
    assert round(n / 1e6, 1) == 63.6  # the paper's Table 1


def test_benchmark_flops_count_the_convolutions(small):
    """``portbench/core/flops_hrnet.py``'s count, which ``mfu.infer`` reads,
    against ``torch.utils.flop_counter`` on the port's network."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.core import flops_hrnet

    model, _, _ = small
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(1, *IN_HW, 3))
    assert counter.get_total_flops() == flops_hrnet.topdown_flops(SMALL_EXTRA, 17, IN_HW, 1, False)


def test_device_crop_within_the_warp_bar():
    rs = np.random.RandomState(3)
    frames = rs.randint(0, 256, (2, 90, 120, 3)).astype(np.uint8)
    boxes = np.array([[10.0, 5.0, 40.0, 70.0], [80.0, 30.0, 50.0, 30.0], [-5.0, 60.0, 30.0, 45.0]])
    frame_of = np.array([0, 1, 1])
    w, h = 48, 64
    center, scale = inference.box_center_scale(torch.from_numpy(boxes), w / h)
    got = inference.crop_levels(torch.from_numpy(frames), torch.from_numpy(frame_of), center,
                                scale, (w, h)).numpy()
    for n, (b, f) in enumerate(zip(boxes, frame_of)):
        c, s = inference.bbox_center_scale(b, w / h)
        want = image_io.warp_affine(frames[f], get_affine_transform_3x3(c, s, 0, (w, h))[:2], (w, h))
        d = np.abs(got[n] - want.astype(np.float32))
        assert d.max() <= 1.0 and d.mean() < 0.01, (n, d.max(), d.mean())
    norm = inference.normalize_crops(torch.from_numpy(got))
    mean, std = np.array(inference.IMAGENET_MEAN), np.array(inference.IMAGENET_STD)
    np.testing.assert_allclose(norm.numpy(), (got / 255.0 - mean) / std, atol=1e-5)


def test_decode_a_hand_placed_peak():
    H, W = 24, 18
    hm = torch.full((2, H, W, 17), -1.0)
    hm[0, 10, 7, 3] = 5.0  # the peak; its right and lower neighbours the larger ones
    hm[0, 10, 8, 3], hm[0, 10, 6, 3] = 2.0, 1.0
    hm[0, 11, 7, 3], hm[0, 9, 7, 3] = 2.0, 1.0
    hm[0, 1, 4, 5] = 3.0  # on the border: no quarter step
    boxes = torch.tensor([[100.0, 50.0, 60.0, 90.0], [0.0, 0.0, 30.0, 40.0]])
    center, scale = inference.box_center_scale(boxes, W / H)
    kp = inference.decode_heatmaps(hm, center, scale, post=True)
    inv = get_affine_transform_3x3(center[0].numpy(), scale[0].numpy(), 0, (W, H), inv=1)
    for j, (x, y), v in ((3, (7.25, 10.25), 5.0), (5, (4.0, 1.0), 3.0)):
        want = inv[:2] @ np.array([x, y, 1.0])
        np.testing.assert_allclose(kp[0, j, :2].numpy(), want, atol=1e-3)
        assert float(kp[0, j, 2]) == v
    # no positive maximum: the origin of the heatmap, mapped
    origin = get_affine_transform_3x3(center[1].numpy(), scale[1].numpy(), 0, (W, H), inv=1)
    np.testing.assert_allclose(kp[1, 0, :2].numpy(), origin[:2, 2], atol=1e-3)
    assert float(kp[1, 0, 2]) == -1.0


def _tree(root):
    """Two 160x120 images of the same size (PPM: decoded in numpy) and the
    pseudo-box json of s3."""
    rs = np.random.RandomState(0)
    images, anns = [], []
    for i in range(2):
        img = rs.randint(0, 256, (120, 160, 3)).astype(np.uint8)
        with open(os.path.join(root, f"im{i}.ppm"), "wb") as f:
            f.write(b"P6\n160 120\n255\n" + img.tobytes())
        images.append({"id": i, "file_name": f"im{i}.ppm", "width": 160, "height": 120})
        for k in range(2 + i):
            anns.append({"id": 10 * i + k, "image_id": i, "category_id": 1,
                         "bbox": [10.0 + 30 * k, 8.0 + 5 * k, 40.0, 90.0 - 10 * k],
                         "score": 0.9, "area": 3600.0, "iscrowd": 0,
                         "keypoints": [0.0] * 51, "keypoints_krcnn": [0.0] * 51,
                         "num_keypoints": 17})
    with open(os.path.join(root, "bboxes.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return anns


def test_s4_with_the_default_model(tmp_path, monkeypatch):
    cfg = _small_cfg(TINY_EXTRA)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(_seeded(ref_hrnet.param_spec(TINY_EXTRA, 17)))
    anns = _tree(str(tmp_path))
    built = []

    def default(cfg, device, weights):
        built.append((cfg.MODEL, device, weights))
        return model

    monkeypatch.setattr(inference, "default_pose_model", default)
    out = str(tmp_path / "kps.json")
    res = inference.run_topdown_keypoints(str(tmp_path / "bboxes.json"), str(tmp_path), out,
                                          cfg=cfg, device="cpu")
    assert built == [("pose_hrnet", "cpu", "")]
    with open(out) as f:
        assert json.load(f) == res
    assert [r["original_id"] for r in res] == [a["id"] for a in anns]
    for r, a in zip(res, anns):
        c, s = inference.bbox_center_scale(a["bbox"], IN_HW[1] / IN_HW[0])
        np.testing.assert_allclose(r["center"], c, rtol=1e-6)
        np.testing.assert_allclose(r["scale"], s, rtol=1e-6)
        assert len(r["keypoints"]) == 51 and np.isfinite(r["keypoints"]).all()
    # one call: both images, their 5 boxes and 3 unit boxes of padding
    imgs = [image_io.decode(open(tmp_path / f"im{i}.ppm", "rb").read())[..., ::-1].copy()
            for i in range(2)]
    boxes = torch.tensor([[0.0, 0.0, 1.0, 1.0]] * 8)
    boxes[:5] = torch.tensor([a["bbox"] for a in anns])
    frame_of = torch.tensor([a["image_id"] for a in anns] + [0] * 3)
    kp = inference.topdown_keypoints(model, torch.from_numpy(np.stack(imgs)), boxes, frame_of)
    got = np.array([r["keypoints"] for r in res]).reshape(-1, 17, 3)
    np.testing.assert_allclose(got, kp[:5].numpy(), rtol=1e-6)
    merged = pipeline.merge_keypoints(str(tmp_path / "bboxes.json"), out,
                                      str(tmp_path / "merged.json"))  # s5 reads it
    assert len(merged["annotations"]) == len(anns)


@pytest.mark.parametrize("sizes, boxes, calls", [
    # images (height), boxes an image -> (images, crops after padding, real boxes) a call
    ([8] * 3, [2, 3, 0], [(3, 8, 5)]),
    ([8] * 41, [1] * 41, [(40, 40, 40), (1, 8, 1)]),
    ([8, 8, 6, 8], [4, 5, 1, 8], [(2, 16, 9), (1, 8, 1), (1, 8, 8)]),
])
def test_calls_group_images_and_pad_boxes(sizes, boxes, calls):
    """``topdown_calls``: ``IMAGES_PER_CALL`` images of one size a call, a new
    call where the size changes, the boxes padded to ``CROP_STEP`` with unit
    boxes on frame 0, and the keys of the real boxes in order."""
    assert (inference.IMAGES_PER_CALL, inference.CROP_STEP) == (40, 8)
    items, key = [], 0
    for i, (h, k) in enumerate(zip(sizes, boxes)):
        b = [[float(i), float(j), 3.0, 4.0] for j in range(k)]
        items.append((np.full((h, 6, 3), i, np.uint8), b, list(range(key, key + k))))
        key += k
    got = list(inference.topdown_calls(items))
    assert [(f.shape[0], b.shape[0], len(k)) for f, b, _, k in got] == calls
    first = 0
    for frames, b, frame_of, keys in got:
        n = len(keys)
        assert keys == list(range(first, first + n))
        first += n
        assert frames.dtype == torch.uint8 and b.dtype == torch.float32
        assert frame_of.dtype == torch.int64
        # each real box sits on its own image, whose pixels hold the image's index
        assert torch.equal(frames[frame_of[:n], 0, 0, 0].float(), b[:n, 0])
        assert torch.equal(b[n:], torch.tensor([0.0, 0.0, 1.0, 1.0]).expand(len(b) - n, 4))
        assert not frame_of[n:].any()


def test_checkpoint_round_trip(tmp_path):
    model = get_model(_small_cfg(TINY_EXTRA), device="cpu")
    P = _seeded(ref_hrnet.param_spec(TINY_EXTRA, 17))
    model.load_state_dict(P)
    path = str(tmp_path / "pose_hrnet_small.pth")
    torch.save({k: v.clone() for k, v in P.items()}, path)
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for v in fresh.state_dict().values():
            v.zero_()
    load_pose_hrnet(fresh, path)
    got = fresh.state_dict()
    assert all(torch.equal(got[k], v) for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    torch.save({"state_dict": {f"module.{k}": v for k, v in P.items()}}, path)  # DataParallel's
    load_pose_hrnet(fresh, path)
    for broken in ({k: v for k, v in P.items() if k != "final_layer.bias"},
                   {**P, "extra_layer.weight": torch.zeros(1)}):
        torch.save(broken, path)
        with pytest.raises(CheckpointKeyError):
            load_pose_hrnet(fresh, path)
