"""The inference call without host syncs, and its CUDA graphs
(``selfpose3d_tpu_torch/utils/graphs.py``), on the CPU: the host constants
made once on the device give what the ``torch.tensor`` copies of every call
gave, bit for bit; ``graphs.run`` stays eager on the CPU and under grad;
the stage arguments' round trip; a muted span records nothing and a
replay's counter changes reach registered counters. The graphs themselves
run on the card only (``tests/test_torch_cuda.py``).

Imports nothing of JAX.
"""

import dataclasses

import pytest
import torch

from selfpose3d_tpu_torch import device as device_mod
from selfpose3d_tpu_torch.geometry.cameras import CameraParams
from selfpose3d_tpu_torch.models import root_net
from selfpose3d_tpu_torch.models.root_net import RootNet
from selfpose3d_tpu_torch.ops import proposal, unproject
from selfpose3d_tpu_torch.utils import graphs, spans

SPACE = ((8000.0, 8000.0, 2000.0), (0.0, -500.0, 800.0), (16, 16, 8))


def _copy_each_call(values, dtype, device):
    """The form every call used before: a new blocking copy of a host list."""
    return torch.tensor([float(v) for v in values], dtype=dtype, device=device)


def _cams(B: int, V: int) -> CameraParams:
    g = torch.Generator().manual_seed(0)
    R = torch.linalg.qr(torch.randn(B, V, 3, 3, generator=g))[0]
    return CameraParams(R=R, T=torch.randn(B, V, 3, 1, generator=g) * 3000.0,
                        f=torch.full((B, V, 2), 1500.0),
                        c=torch.tensor([960.0, 540.0]).expand(B, V, 2),
                        k=torch.randn(B, V, 3, generator=g) * 1e-3,
                        p=torch.randn(B, V, 2, generator=g) * 1e-4)


def _sample_grid():
    B, V = 2, 3
    g = torch.Generator().manual_seed(1)
    grid = torch.randn(B, 1, 500, 3, generator=g) * 2000.0
    trans = torch.eye(3).expand(B, V, 3, 3) * torch.tensor([0.5, 0.47, 1.0])[:, None]
    orig_wh = torch.tensor([1920.0, 1080.0]).expand(B, V, 2)
    hflip = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 1.0]])
    return unproject.compute_sample_grid(grid, _cams(B, V), trans, (960, 512), (240, 128),
                                         orig_wh, hflip=hflip)


def _voxel_to_world():
    index = torch.stack(torch.meshgrid(*(torch.arange(n) for n in SPACE[2]), indexing="ij"), -1)
    return proposal.voxel_index_to_world(index.reshape(1, -1, 3), *SPACE)


def _rootnet_grid():
    """RootNet's whole-space grid (``unproject_heatmaps`` stubbed to return it)."""
    return RootNet(*SPACE, (128, 64)).unproject(torch.rand(1, 2, 16, 32, 1), None, None, None)


@pytest.mark.parametrize("family, module, compute", [
    ("sample_grid", unproject, _sample_grid),
    ("voxel_to_world", proposal, _voxel_to_world),
    ("rootnet_center", root_net, _rootnet_grid),
])
def test_device_constants_give_the_old_copies_bit_for_bit(monkeypatch, family, module, compute):
    monkeypatch.setattr(root_net, "unproject_heatmaps", lambda hm, grid, *a, **k: grid)
    cached = [compute(), compute()]
    with monkeypatch.context() as m:
        m.setattr(module, "device_constant", _copy_each_call)
        old = compute()
    for got in cached:
        got, want = (got, old) if isinstance(got, tuple) else ((got,), (old,))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), family
    # one tensor a value list, dtype and device, made at the first call
    one = device_mod.device_constant([0.1, -0.0], torch.float32, "cpu")
    assert device_mod.device_constant((0.1, -0.0), torch.float32, "cpu") is one
    assert torch.equal(one, torch.tensor([0.1, -0.0])) and not one.is_inference()
    assert device_mod.device_constant([0.1, 0.0], torch.float32, "cpu") is not one  # -0.0 kept


def test_run_stays_eager_on_the_cpu_and_under_grad():
    net = torch.nn.Linear(3, 2).eval()
    calls = []

    def body(module, x, cam, flag):
        calls.append(flag)
        return module(x) + cam.f.sum(), x

    x, cam = torch.rand(4, 3), _cams(1, 2)
    before = spans.counters()
    for grad in (False, True):
        with torch.set_grad_enabled(grad), graphs.entry(net):
            outs = [graphs.run("backbone", net, body, x, cam, grad) for _ in range(3)]
        assert all(torch.equal(o[0], outs[0][0]) for o in outs)
    assert calls == [False] * 3 + [True] * 3
    assert not any(k.startswith("graphs.") for k in spans.changes(before))
    # outside an inference entry nothing is looked up at all
    assert graphs.run("backbone", net, body, x, cam, None)[1] is x


def test_stage_arguments_round_trip():
    cam = _cams(1, 2)
    args = (torch.rand(2), cam, None, False, (torch.rand(1), True))
    leaves = []
    spec = graphs._flatten(args, leaves)
    assert len(leaves) == 2 + len(dataclasses.fields(cam)) and hash(spec) is not None
    back = graphs._unflatten(spec, iter(leaves))
    assert back[2:4] == (None, False) and isinstance(back[1], CameraParams)
    assert back[1].R is cam.R and back[4][1] is True and back[0] is args[0]
    assert back[4][0] is args[4][0]
    for other in (3, [True], object()):  # what no stage takes
        with pytest.raises(TypeError):
            graphs._flatten((other,), [])


def test_muted_spans_record_nothing_and_added_changes_reach_their_counters(monkeypatch):
    spans.reset()
    monkeypatch.setattr(spans, "_recording", lambda: True)  # as under a profiler
    with spans.span("t.root"):
        with spans.muted(), spans.span("t.captured"):
            pass
    monkeypatch.undo()
    assert [r["name"] for r in spans.records()] == ["t.root"]
    before = spans.counters()
    spans.add({"launches.sample_view": 2, "graphs.replays.rootnet": 1, "t.plain": 3})
    assert spans.changes(before) == {"launches.sample_view": 2, "graphs.replays.rootnet": 1,
                                     "t.plain": 3}
    spans.add({"launches.sample_view": -2, "graphs.replays.rootnet": -1, "t.plain": -3})
    spans.reset()


def test_set_training_is_train_and_submodules_are_modules():
    net = torch.nn.Sequential(torch.nn.Conv2d(1, 2, 1), torch.nn.Sequential(
        torch.nn.BatchNorm2d(2), torch.nn.ReLU()), torch.nn.Identity())
    net[1].add_module("none", None)
    assert {id(m) for m in graphs.submodules(net)} == {id(m) for m in net.modules()}
    for mode in (False, True, False):
        net[1][0].train(not mode)  # a submodule in the other mode
        graphs.set_training(net, mode)
        assert all(m.training is mode for m in net.modules())
    with pytest.raises(ValueError):
        graphs.set_training(net, 1)
