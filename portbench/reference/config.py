"""The configuration as the reference reads it: the YAML keys of a
configuration file under ``portbench/configs/`` (``yaml`` member), with
the published defaults (SelfPose3d lib/core/config.py) for keys the YAML
leaves out."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


def _get(d: dict, path: str, default):
    cur = d
    for k in path.split("."):
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


@dataclass(frozen=True)
class RefConfig:
    ssv: bool
    joints: int
    image_wh: Tuple[int, int]
    heatmap_wh: Tuple[int, int]
    orig_wh: Tuple[int, int]
    sigma: float
    layers: int
    deconv_filters: Tuple[int, ...]
    final_k: int
    with_attn: bool
    attn_layers: int
    attn_weight: float
    use_l1: bool
    l1_weight: float
    l1_attn: bool
    root_idx: int
    root_in: int
    views: int
    space_size: Tuple[float, float, float]
    space_center: Tuple[float, float, float]
    root_cube: Tuple[int, int, int]
    max_people: int
    threshold: float
    grid_size: Tuple[float, float, float]
    pose_cube: Tuple[int, int, int]
    beta: float
    train_backbone: bool
    freeze_rootnet: bool
    lr: float


def ref_config(yaml: dict) -> RefConfig:
    """``yaml``: the configuration's keys (nested dicts), overrides applied."""
    g = lambda p, d: _get(yaml, p, d)  # noqa: E731
    J = int(g("NETWORK.NUM_JOINTS", 15))
    ssv = g("MODEL", "multi_person_posenet") == "multi_person_posenet_ssv"
    roothm = bool(g("NETWORK.ROOTNET_ROOTHM", False))
    return RefConfig(
        ssv=ssv,
        joints=J,
        image_wh=tuple(g("NETWORK.IMAGE_SIZE", (960, 512))),
        heatmap_wh=tuple(g("NETWORK.HEATMAP_SIZE", (240, 128))),
        orig_wh=tuple(g("NETWORK.IMAGE_SIZE_ORIG", (1920, 1080))),
        sigma=float(g("NETWORK.SIGMA", 3)),
        layers=int(g("POSE_RESNET.NUM_LAYERS", 50)),
        deconv_filters=tuple(g("POSE_RESNET.NUM_DECONV_FILTERS", (256, 256, 256))),
        final_k=int(g("POSE_RESNET.FINAL_CONV_KERNEL", 1)),
        with_attn=bool(g("WITH_ATTN", False)),
        attn_layers=int(g("ATTN_NUM_LAYERS", 18)),
        attn_weight=float(g("ATTN_WEIGHT", 0.1)),
        use_l1=bool(g("USE_L1", False)),
        l1_weight=float(g("L1_WEIGHT", 0.1)),
        l1_attn=bool(g("L1_ATTN", False)),
        root_idx=int(g("DATASET.ROOTIDX", 2)),
        root_in=1 if roothm else J,
        views=int(g("DATASET.CAMERA_NUM", 5)),
        space_size=tuple(float(v) for v in g("MULTI_PERSON.SPACE_SIZE", (4000.0, 5200.0, 2400.0))),
        space_center=tuple(float(v) for v in g("MULTI_PERSON.SPACE_CENTER", (300.0, 300.0, 300.0))),
        root_cube=tuple(int(v) for v in g("MULTI_PERSON.INITIAL_CUBE_SIZE", (24, 32, 16))),
        max_people=int(g("MULTI_PERSON.MAX_PEOPLE_NUM", 10)),
        threshold=float(g("MULTI_PERSON.THRESHOLD", 0.1)),
        grid_size=tuple(float(v) for v in g("PICT_STRUCT.GRID_SIZE", (2000.0, 2000.0, 2000.0))),
        pose_cube=tuple(int(v) for v in g("PICT_STRUCT.CUBE_SIZE", (64, 64, 64))),
        beta=float(g("NETWORK.BETA", 100.0)),
        train_backbone=bool(g("NETWORK.TRAIN_BACKBONE", False)),
        freeze_rootnet=bool(g("NETWORK.FREEZE_ROOTNET", False)),
        lr=float(g("TRAIN.LR", 0.001)),
    )
