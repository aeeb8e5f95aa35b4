"""Typed configuration system, YAML-compatible with the reference schema.

The port's own copy of ``selfpose3d_tpu/config.py``: the same dataclasses,
defaults and strict unknown-key rejection (ref: lib/core/config.py:17,
233-274), so one YAML file or override dict configures both packages. Keys
that only steer the JAX package (``NETWORK.SAMPLING``, ``MESH_DATA_AXIS``)
are accepted and unused here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


def _tup(x) -> Tuple:
    if isinstance(x, (list, tuple)):
        return tuple(_tup(v) for v in x)
    return x


def _nested(x):
    """A free-form section (``MODEL_EXTRA``): dicts kept, lists as tuples."""
    if isinstance(x, dict):
        return {k: _nested(v) for k, v in x.items()}
    return _tup(x)


@dataclass
class NetworkConfig:
    PRETRAINED: str = "models/pytorch/imagenet/resnet50-19c8e357.pth"
    PRETRAINED_BACKBONE: str = ""
    PRETRAINED_BACKBONE_PSEUDOGT: bool = False
    TRAIN_BACKBONE: bool = False
    TRAIN_ONLY_2D: bool = False
    NUM_JOINTS: int = 15
    INPUT_SIZE: int = 512
    HEATMAP_SIZE: Tuple[int, int] = (240, 128)  # (W, H)
    IMAGE_SIZE: Tuple[int, int] = (960, 512)  # (W, H)
    IMAGE_SIZE_ORIG: Tuple[int, int] = (1920, 1080)
    SIGMA: int = 3
    TARGET_TYPE: str = "gaussian"
    AGGRE: bool = True
    USE_GT: bool = False
    BETA: float = 100.0
    ROOTNET_ROOTHM: bool = False
    ROOTNET_TRAIN_SYNTH: bool = False
    INIT_TRAIN_EPOCHS_ROOTNET: int = 0
    INIT_ROOTNET: str = ""
    TRAIN_ONLY_ROOTNET: bool = False
    ROOTNET_BUFFER_SIZE: int = 5000
    FREEZE_ROOTNET: bool = False
    INIT_ALL: str = ""
    SINGLE_AUG_TRAINING_POSENET: bool = False
    ROOT_CONSISTENCY_LOSS: bool = True
    WEIGHT_ROOT_SYN: float = 100.0
    WEIGHT_ROOT_REG: float = 1.0
    ROOTNET_SYN_RANGE: Tuple = (
        (2500.0, -2000.0),
        (1500.0, -1500.0),
        (250.0, -300.0),
    )
    # voxel sampling implementation: 'slicewarp' (default) = Pallas warp
    # kernel, exact bilinear within its tap band with exact-gather fallback
    # slots (see ops/slicewarp.py) and far faster than XLA's gather on TPU;
    # 'gather' = plain XLA bilinear gather. slicewarp falls back to gather
    # automatically off-TPU or when shapes are unsupported.
    SAMPLING: str = "slicewarp"


@dataclass
class PoseResnetConfig:
    NUM_LAYERS: int = 50
    DECONV_WITH_BIAS: bool = False
    NUM_DECONV_LAYERS: int = 3
    NUM_DECONV_FILTERS: Tuple[int, ...] = (256, 256, 256)
    NUM_DECONV_KERNELS: Tuple[int, ...] = (4, 4, 4)
    FINAL_CONV_KERNEL: int = 1


@dataclass
class LossConfig:
    USE_TARGET_WEIGHT: bool = True
    USE_DIFFERENT_JOINTS_WEIGHT: bool = False


@dataclass
class DatasetConfig:
    ROOT: str = "data/panoptic-toolbox/data/"
    TRAIN_DATASET: str = "panoptic_ssv"
    TEST_DATASET: str = "panoptic"
    TRAIN_SUBSET: str = "train"
    TEST_SUBSET: str = "validation"
    ROOTIDX: int = 2
    DATA_FORMAT: str = "jpg"
    BBOX: int = 2000
    CROP: bool = True
    COLOR_RGB: bool = False
    FLIP: bool = True
    DATA_AUGMENTATION: bool = True
    CAMERA_NUM: int = 5
    CAMERAS: Tuple[int, ...] = (0, 1, 2, 3, 4)
    CAMERA_NUM_TOTAL: int = 5
    SCALE_FACTOR: float = 0
    SCALE_FACTOR1: float = 0
    SCALE_FACTOR2: float = 0
    ROT_FACTOR: float = 0
    ROT_FACTOR1: float = 0
    ROT_FACTOR2: float = 0
    APPLY_CUTOUT: bool = False
    APPLY_RANDAUG: bool = False
    SUFFIX: str = "sub"
    GT_3D_FILE: str = "panoptic_training_pose.pkl"
    TRAIN_PSEUDO_GT3D: bool = False
    ROOTIDX_PSEUDO: int = 2
    MEAN: Tuple[float, ...] = ()
    STD: Tuple[float, ...] = ()
    # synthetic-scene dataset only: "noise" serves per-epoch random images
    # (pipeline smoke; the backbone cannot generalize), "render" draws
    # deterministic stick figures at the augmented projected joints so the
    # full SSV pipeline has learnable image signal (the convergence-to-
    # magnitude curriculum, r5)
    SYNTH_IMAGE_MODE: str = "noise"


@dataclass
class TrainConfig:
    LR_FACTOR: float = 0.1
    LR_STEP: Tuple[int, ...] = (90, 110)
    LR: float = 0.001
    L1_EPOCH: int = 5
    OPTIMIZER: str = "adam"
    MOMENTUM: float = 0.9
    WD: float = 0.0001
    NESTEROV: bool = False
    GAMMA1: float = 0.99
    GAMMA2: float = 0.0
    BEGIN_EPOCH: int = 0
    END_EPOCH: int = 140
    RESUME: bool = False
    BATCH_SIZE: int = 8
    SHUFFLE: bool = True
    # PoseNet candidate-bucket dispatch during TRAINING.
    #   'none' (default): one compiled step at full MAX_PEOPLE_NUM
    #     candidates — reference-equivalent worst case. The in-graph
    #     nn.switch used at inference is NOT taken under grad: the
    #     multi-branch TRAIN graph OOMs the remote compiler
    #     (ARCHITECTURE.md "Training path").
    #   'meta': pick a CANDIDATE_BUCKETS bucket per step on the HOST from
    #     the batch's GT person count (max num_person + 1 slack; all hosts
    #     agree via a process allgather so SPMD programs never diverge) and
    #     run a per-bucket compiled single-branch graph — PoseNet train cost
    #     then scales with the scene like the reference's valid-candidate
    #     loop. Documented deviation vs the reference, which dispatches on
    #     the PROPOSAL count (threshold-only,
    #     ref: cuboid_proposal_net_soft.py:64-66): dispatching on GT count
    #     means above-threshold proposals beyond the bucket (an untrained
    #     RootNet's false positives past people-count+1) are DROPPED from
    #     the SSV losses — the k_cap slice keeps the highest-score
    #     proposals, exactly as if the dropped ones had been invalidated
    #     (pinned by tests/test_candidate_buckets.py::TestHostBucketDispatch
    #     ::test_kcap_truncation_drops_lowest_score). The reference
    #     processes all of them. With a trained RootNet the counts agree
    #     and the modes are equivalent; 'none' is exact always.
    BUCKET_DISPATCH: str = "none"


@dataclass
class TestConfig:
    BATCH_SIZE: int = 8
    STATE: str = "best"
    FLIP_TEST: bool = False
    POST_PROCESS: bool = False
    SHIFT_HEATMAP: bool = False
    USE_GT_BBOX: bool = False
    IMAGE_THRE: float = 0.1
    NMS_THRE: float = 0.6
    OKS_THRE: float = 0.5
    IN_VIS_THRE: float = 0.0
    BBOX_FILE: str = ""
    BBOX_THRE: float = 1.0
    MATCH_IOU_THRE: float = 0.3
    DETECTOR: str = "fpn_dcn"
    DETECTOR_DIR: str = ""
    MODEL_FILE: str = ""
    HEATMAP_LOCATION_FILE: str = "predicted_heatmaps.h5"


@dataclass
class DebugConfig:
    DEBUG: bool = True
    SAVE_BATCH_IMAGES_GT: bool = True
    SAVE_BATCH_IMAGES_PRED: bool = True
    SAVE_HEATMAPS_GT: bool = True
    SAVE_HEATMAPS_PRED: bool = True
    SAVE_3D_POSES: bool = False
    SAVE_3D_ROOTS: bool = False


@dataclass
class PictStructConfig:
    FIRST_NBINS: int = 16
    PAIRWISE_FILE: str = ""
    RECUR_NBINS: int = 2
    RECUR_DEPTH: int = 10
    LIMB_LENGTH_TOLERANCE: int = 150
    GRID_SIZE: Tuple[float, float, float] = (2000.0, 2000.0, 2000.0)
    CUBE_SIZE: Tuple[int, int, int] = (64, 64, 64)
    DEBUG: bool = False
    TEST_PAIRWISE: bool = False
    SHOW_ORIIMG: bool = False
    SHOW_CROPIMG: bool = False
    SHOW_HEATIMG: bool = False


@dataclass
class MultiPersonConfig:
    SPACE_SIZE: Tuple[float, float, float] = (4000.0, 5200.0, 2400.0)
    SPACE_CENTER: Tuple[float, float, float] = (300.0, 300.0, 300.0)
    ESTIMATED_SPACE_CENTER: Tuple[float, float, float] = (300.0, 300.0, 300.0)
    INITIAL_CUBE_SIZE: Tuple[int, int, int] = (24, 32, 16)
    MAX_PEOPLE_NUM: int = 10
    THRESHOLD: float = 0.1
    # PoseNet candidate-count buckets (ascending; implicitly capped by
    # MAX_PEOPLE_NUM). Empty = always process all MAX_PEOPLE_NUM candidates.
    # With e.g. (4,), scenes whose valid proposals fit the first 4 slots pay
    # 4/10 of the PoseNet sampling + V2V cost (ref behavior: python loop over
    # valid candidates only, multi_person_posenet_ssv.py:365-383).
    CANDIDATE_BUCKETS: Tuple[int, ...] = ()


@dataclass
class CudnnConfig:  # accepted for YAML compat; no-op on TPU
    BENCHMARK: bool = True
    DETERMINISTIC: bool = False
    ENABLED: bool = True


@dataclass
class Config:
    OUTPUT_DIR: str = "output"
    LOG_DIR: str = "log"
    DATA_DIR: str = ""
    BACKBONE_MODEL: str = "pose_resnet"
    MODEL: str = "multi_person_posenet"
    GPUS: str = "0,1"  # accepted for compat; TPU build uses jax.devices()
    WORKERS: int = 8
    PRINT_FREQ: int = 100
    WITH_SSV: bool = False
    WITH_ATTN: bool = False
    ATTN_WEIGHT: float = 0.1
    ATTN_NUM_LAYERS: int = 18
    USE_L1: bool = False
    L1_WEIGHT: float = 0.1
    L1_ATTN: bool = False
    MIN_VIEWS_CHECK: int = 1
    EVAL_ROOTNET_ONLY: bool = False
    # COCO keypoint index feeding each Panoptic joint (ref: lib/core/config.py:36)
    COCO_TO_PANOPTIC_MAPPING: Tuple[int, ...] = (
        5, 0, 11, 5, 7, 9, 11, 13, 15, 6, 8, 10, 12, 14, 16,
    )
    NETWORK: NetworkConfig = field(default_factory=NetworkConfig)
    POSE_RESNET: PoseResnetConfig = field(default_factory=PoseResnetConfig)
    LOSS: LossConfig = field(default_factory=LossConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    DEBUG: DebugConfig = field(default_factory=DebugConfig)
    PICT_STRUCT: PictStructConfig = field(default_factory=PictStructConfig)
    MULTI_PERSON: MultiPersonConfig = field(default_factory=MultiPersonConfig)
    CUDNN: CudnnConfig = field(default_factory=CudnnConfig)
    # device / parallelism (TPU-native additions; absent keys in reference YAMLs)
    MESH_DATA_AXIS: str = "data"
    DTYPE: str = "bfloat16"  # compute dtype for conv stacks
    # MODEL.EXTRA of a top-down pose network (``models/pose_hrnet.py``: the
    # stage dicts STAGE2-4 and FINAL_CONV_KERNEL), read as it is given
    MODEL_EXTRA: dict = field(default_factory=dict)

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_IGNORED_SECTIONS = {"CUDNN"}


def _apply_section(obj: Any, name: str, updates: dict) -> Any:
    valid = {f.name for f in dataclasses.fields(obj)}
    kw = {}
    for k, v in updates.items():
        if k not in valid:
            raise ValueError(f"{name}.{k} not exist in config schema")
        kw[k] = _tup(v)
    return dataclasses.replace(obj, **kw)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Build a Config from defaults + YAML overlay (+ programmatic overrides).

    Mirrors the strict unknown-key rejection of the reference's
    ``update_config`` (ref: lib/core/config.py:260-274).
    """
    cfg = Config()
    raw = {}
    if path is not None:
        import yaml  # only YAML files need it

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    if overrides:
        for k, v in overrides.items():
            if isinstance(v, dict):
                raw.setdefault(k, {}).update(v)
            else:
                raw[k] = v

    top_fields = {f.name: f for f in dataclasses.fields(Config)}
    kw = {}
    for k, v in raw.items():
        if k not in top_fields:
            raise ValueError(f"{k} not exist in config schema")
        if k in _IGNORED_SECTIONS:
            continue
        cur = getattr(cfg, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kw[k] = _apply_section(cur, k, v)
        elif isinstance(cur, dict):
            kw[k] = _nested(v)
        else:
            kw[k] = _tup(v)
    return dataclasses.replace(cfg, **kw)


def flagship_cfg() -> Config:
    """The cam5 SSV PoseNet configuration at full width (ref:
    configs/panoptic_ssl/resnet50/cam5_posenet.yaml): ResNet-50 on 5 views
    at 960x512, an 80x80x20 root grid, 64^3 pose cubes, candidate buckets
    (4, 5), bf16 model dtype (the Config default)."""
    return load_config(overrides={
        "MODEL": "multi_person_posenet_ssv",
        "WITH_SSV": True,
        "WITH_ATTN": True,
        "USE_L1": True,
        "L1_WEIGHT": 0.01,
        "L1_ATTN": True,
        "NETWORK": {
            "NUM_JOINTS": 15,
            "IMAGE_SIZE": [960, 512],
            "HEATMAP_SIZE": [240, 128],
            "SIGMA": 3,
            "ROOTNET_ROOTHM": True,
            "ROOTNET_TRAIN_SYNTH": True,
            "TRAIN_BACKBONE": True,
            "FREEZE_ROOTNET": False,
        },
        "POSE_RESNET": {"NUM_LAYERS": 50},
        "MULTI_PERSON": {
            "SPACE_SIZE": [8000.0, 8000.0, 2000.0],
            "SPACE_CENTER": [0.0, -500.0, 800.0],
            "INITIAL_CUBE_SIZE": [80, 80, 20],
            "MAX_PEOPLE_NUM": 10,
            "THRESHOLD": 0.3,
            "CANDIDATE_BUCKETS": [4, 5],
        },
        "PICT_STRUCT": {"CUBE_SIZE": [64, 64, 64]},
        "DATASET": {"ROOTIDX": 2, "CAMERA_NUM": 5},
        "TRAIN": {"BATCH_SIZE": 1},
    })


def get_model_name(cfg: Config) -> Tuple[str, str]:
    """ref: lib/core/config.py:305-317."""
    name = f"{cfg.MODEL}_{cfg.POSE_RESNET.NUM_LAYERS}"
    deconv_suffix = "".join(f"d{n}" for n in cfg.POSE_RESNET.NUM_DECONV_FILTERS)
    full = (
        f"{cfg.NETWORK.IMAGE_SIZE[1]}x{cfg.NETWORK.IMAGE_SIZE[0]}_{name}_{deconv_suffix}"
    )
    return name, full
