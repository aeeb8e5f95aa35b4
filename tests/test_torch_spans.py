"""The port's spans and host-sync counters (``selfpose3d_tpu_torch/utils/spans.py``)
on the CPU, at small float32 sizes: nesting, parents, calls and self time;
nothing recorded while no profiler records; under a profiler, the span tree
of each entry (``do_inference``, the supervised ``forward(train=False)``,
the SSV train step, with and without the masked BatchNorm statistics) and
each ``host_syncs.<site>`` count its path reaches.

Imports nothing of JAX: ``tests/test_torch_cuda.py`` runs the same paths on
the card (``path_call``), where PyTorch's sync debug mode counts the syncs.
"""

import dataclasses
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from selfpose3d_tpu_torch.config import flagship_cfg, load_config
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.models.norm import BatchNorm3d
from selfpose3d_tpu_torch.ops import slicewarp
from selfpose3d_tpu_torch.train import create_train_state, make_ssv_train_step
from selfpose3d_tpu_torch.utils import spans

REPO = Path(__file__).resolve().parents[1]
SMALL = {
    "DTYPE": "float32",
    "NETWORK": {"NUM_JOINTS": 15, "IMAGE_SIZE": [128, 64], "HEATMAP_SIZE": [32, 16],
                "IMAGE_SIZE_ORIG": [1920, 1080], "SIGMA": 3, "TRAIN_BACKBONE": True},
    "POSE_RESNET": {"NUM_LAYERS": 18},
    "ATTN_NUM_LAYERS": 18,
    "MULTI_PERSON": {"SPACE_SIZE": [8000.0, 8000.0, 2000.0], "SPACE_CENTER": [0.0, -500.0, 800.0],
                     "INITIAL_CUBE_SIZE": [16, 16, 8], "MAX_PEOPLE_NUM": 4, "THRESHOLD": -100.0,
                     "CANDIDATE_BUCKETS": [2]},
    "PICT_STRUCT": {"CUBE_SIZE": [8, 8, 8]},
    "DATASET": {"CAMERA_NUM": 2},
}
SSV = {"MODEL": "multi_person_posenet_ssv", "WITH_SSV": True, "WITH_ATTN": True, "USE_L1": True,
       "L1_ATTN": True}
SSV_NET = {"ROOTNET_ROOTHM": True, "ROOTNET_TRAIN_SYNTH": True, "FREEZE_ROOTNET": False}
PATHS = ("ssv_infer", "supervised_infer", "ssv_train", "ssv_train_masked")
SUPERVISED_FULL = REPO / "configs/panoptic/resnet50/prn32_cpn48x48x12_960x512_cam5.yaml"


def _merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def path_cfg(path: str, full: bool = False):
    """The configuration of a path: small and float32, or (``full``) at the
    benchmark's full widths, the flagship (``flagship_cfg``) or VoxelPose's
    prn32 YAML; ``ssv_train_masked`` is small only (USE_GT: three of the
    four candidates valid, so PoseNet's BatchNorm statistics take a mask)."""
    if full:
        if path == "supervised_infer":
            return load_config(str(SUPERVISED_FULL))
        cfg = flagship_cfg()
        if path == "ssv_train":  # every candidate valid, so that PoseNet's losses run
            cfg = dataclasses.replace(
                cfg, MULTI_PERSON=dataclasses.replace(cfg.MULTI_PERSON, THRESHOLD=-100.0))
        return cfg
    if path == "supervised_infer":
        return load_config(overrides=_merged(SMALL, {"MODEL": "multi_person_posenet"}))
    net = {**SSV_NET, "USE_GT": path == "ssv_train_masked"}
    return load_config(overrides=_merged(SMALL, {**SSV, "NETWORK": net}))


def path_call(path: str, device: str, full: bool = False):
    """-> (model, call): ``call()`` runs the path once on ``device`` (one
    synthetic 3-person scene at batch 1; a train path steps Adam)."""
    cfg = path_cfg(path, full)
    model = get_model(cfg, device=device, seed=0)

    def branch(rot=0.0):
        return make_synthetic_branch(cfg, batch_size=1, num_person=3, seed=0, with_images=True,
                                     rot_deg=rot, device=device)[0]

    if path == "ssv_infer":
        b = branch()
        return model, lambda: model.do_inference(b)
    if path == "supervised_infer":
        b = branch()

        def infer():
            with torch.no_grad():
                return model(b, train=False)

        return model, infer
    state = create_train_state(cfg, model)
    step = make_ssv_train_step(model, train_posenet_stage=True, use_l1_stage=True)
    branches = [branch(r) for r in (15.0, -10.0, 0.0)]
    gen = torch.Generator().manual_seed(0)
    return model, lambda: step(state, *branches, generator=gen)


def expected_syncs(path: str, model) -> dict:
    """The ``host_syncs`` sites a small path reaches, with their counts:
    at inference PoseNet's bucket read alone (the host constants of the
    sample grids, RootNet's centre and the proposals live on the device,
    ``device.device_constant``); in training PoseNet's two reads of the
    valid candidates, the synthetic pass's six copies, each of the two L1
    terms' norm (1), Hungarian (2) and worst-term drop (3); under USE_GT no
    RootNet, and each of V2V's BatchNorm layers indexes by the mask forward
    and backward."""
    if path in ("ssv_infer", "supervised_infer"):
        return {"posenet_bucket": 1}
    l1 = {"posenet_bn_mask": 2, "l1_norm": 2, "hungarian": 4, "l1_attn": 6}
    if path == "ssv_train":
        return {"rootnet_synth": 6, **l1}
    bns = sum(isinstance(m, BatchNorm3d) for m in model.pose_net.v2v_net.modules())
    return {"bn_mask": 2 * bns, **l1}


TREES = {
    "ssv_infer": ("sp3d.infer", [("sp3d.backbone", []), ("sp3d.rootnet", ["sp3d.proposals"]),
                                 ("sp3d.posenet", [])]),
    "supervised_infer": ("sp3d.infer", [("sp3d.backbone", []),
                                        ("sp3d.rootnet", ["sp3d.proposals"]),
                                        ("sp3d.posenet", [])]),
    "ssv_train": ("sp3d.train_step", [
        ("sp3d.backbone", []), ("sp3d.attn", []), ("sp3d.rootnet", ["sp3d.proposals"]),
        ("sp3d.rootnet", []), ("sp3d.posenet", []), ("sp3d.losses", ["sp3d.matching"] * 2),
        ("sp3d.backward", []), ("sp3d.optimizer", [])]),
    "ssv_train_masked": ("sp3d.train_step", [
        ("sp3d.backbone", []), ("sp3d.attn", []), ("sp3d.posenet", []),
        ("sp3d.losses", ["sp3d.matching"] * 2), ("sp3d.backward", []), ("sp3d.optimizer", [])]),
}


def tree(recs: list, root: dict) -> list:
    """The children of ``root`` in order, each with its children's names."""
    def kids(rid):
        return sorted((r for r in recs if r["parent"] == rid), key=lambda r: r["t0_ns"])
    return [(r["name"], [g["name"] for g in kids(r["id"])]) for r in kids(root["id"])]


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.reset()
    yield
    spans.reset()


def test_nesting_parents_calls_and_self_time():
    outer, inner = spans.span("t.outer"), spans.span("t.inner")

    @spans.span("t.leaf")
    def leaf(x):
        return x + 1

    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with outer:
                spans.count("t.counter", 3)
                with inner:
                    leaf(1)
                    leaf(2)
                with inner:
                    pass
    recs = spans.records()
    assert [r["name"] for r in recs] == ["t.leaf", "t.leaf", "t.inner", "t.inner", "t.outer"] * 2
    roots = [r for r in recs if r["parent"] == 0]
    assert [r["name"] for r in roots] == ["t.outer"] * 2 and roots[0]["id"] != roots[1]["id"]
    for r in recs:
        assert r["root"] in {q["id"] for q in roots}
        if r["parent"]:
            parent = next(q for q in recs if q["id"] == r["parent"])
            assert parent["root"] == r["root"]
            assert parent["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= parent["t1_ns"]
    s = spans.summary()
    assert s["device_clock"] == "host" and s["dropped"] == 0
    assert {k: v["count"] for k, v in s["spans"].items()} == {"t.leaf": 4, "t.inner": 4,
                                                               "t.outer": 2}
    for name in s["spans"]:
        kids = [r for r in recs for p in recs if r["parent"] == p["id"] and p["name"] == name]
        total = s["spans"][name]
        assert total["host_self_ms"] == pytest.approx(
            total["host_ms"] - sum(k["host_ms"] for k in kids), abs=1e-9)
        assert total["device_ms"] == total["host_ms"]  # no CUDA: the host's clock
    assert [r["counts"] for r in s["roots"]] == [{"t.counter": 3}] * 2


def test_nothing_recorded_without_a_profiler(monkeypatch):
    made = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: made.append("range"))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append("event"))
    s = spans.span("t.off")
    assert spans.span("t.off") is s  # one object for the name: nothing made a use

    @spans.span("t.off_fn")
    def fn():
        with s:
            return 7

    wait = spans.meter("t.off_meter")
    with wait:
        assert fn() == 7
    assert made == [] and spans.records() == [] and spans.summary()["roots"] == []
    assert wait.seconds > 0


def test_launches_are_counters_and_a_full_buffer_drops(monkeypatch):
    assert spans.counters()["launches.sample_view"] == slicewarp.LAUNCHES["sample_view"]
    monkeypatch.setattr(spans, "CAPACITY", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("t.root"):
            monkeypatch.setitem(slicewarp.LAUNCHES, "sample_view",
                                slicewarp.LAUNCHES["sample_view"] + 2)
            with spans.span("t.a"):
                pass
            with spans.span("t.b"):
                pass
    s = spans.summary()
    assert s["dropped"] == 1 and list(s["spans"]) == ["t.a", "t.b"] and s["roots"] == []
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("t.root"):
            monkeypatch.setitem(slicewarp.LAUNCHES, "sample_view",
                                slicewarp.LAUNCHES["sample_view"] + 2)
    assert spans.summary()["roots"][0]["counts"] == {"launches.sample_view": 2}


@pytest.mark.parametrize("path", PATHS)
def test_each_path_records_its_span_tree_and_counts_its_syncs(path):
    torch.manual_seed(0)
    model, call = path_call(path, "cpu")
    call()  # the first call outside the profiler
    before = spans.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    after = spans.counters()
    recs = spans.records()
    (root,) = [r for r in recs if r["parent"] == 0]
    name, children = TREES[path]
    assert root["name"] == name and tree(recs, root) == children
    for r in recs:
        assert r["root"] == root["id"]
        parent = next((q for q in recs if q["id"] == r["parent"]), None)
        if parent is not None:
            assert r["host_ms"] <= parent["host_ms"]
    traced = {e.name for e in prof.events()}
    assert {r["name"] for r in recs} <= traced
    (summary_root,) = spans.summary()["roots"]
    syncs = {k.split(".", 1)[1]: v for k, v in summary_root["counts"].items()
             if k.startswith("host_syncs.")}
    assert syncs == expected_syncs(path, model)
    delta = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    assert delta == summary_root["counts"]  # the root saw every change of the call
    assert not any(k.startswith("graphs.") for k in delta)  # no CUDA graph on the CPU
