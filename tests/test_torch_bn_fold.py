"""Eval BatchNorm applied in its convolution's epilogue
(``models/norm.py:conv_bn``) on the CPU, where the epilogue is its plain
version.

Each block kind of the three networks, in eval mode, against its code
before the epilogue (the convolution module, the BatchNorm module as
``x * s + b``, then ReLU and sums as separate ops): outputs equal bit for
bit in float32 and bf16; in float32 the gradients to the input, the conv
weights and the BatchNorm weights and biases within 1e-5 of the largest
entry (the epilogue's backward sums the vectors' gradients in its own
order). Train
mode applies no epilogue and equals the code before bit for bit, running
statistics too. A changed state dict reaches the next call; ``bn_folds``
counts every BatchNorm a call runs.
"""

import copy

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from selfpose3d_tpu_torch.models.norm import BatchNorm2d, BatchNorm3d
from selfpose3d_tpu_torch.models.pose_hrnet import HighResolutionModule, PoseHighResolutionNet
from selfpose3d_tpu_torch.models.pose_resnet import BasicBlock, Bottleneck, PoseResNet
from selfpose3d_tpu_torch.models.v2v_net import (
    Basic3DBlock,
    Res3DBlock,
    Upsample3DBlock,
    V2VNet,
)
from selfpose3d_tpu_torch.utils import spans

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------- the code before the epilogue

def _seq(seq, x):  # a conv, its BatchNorm and an optional ReLU
    y = seq[1](seq[0](x))
    return F.relu(y) if len(seq) > 2 else y


def _basic(m, x):
    r = x if m.downsample is None else m.downsample(x)
    y = F.relu(m.bn1(m.conv1(x)))
    return F.relu(m.bn2(m.conv2(y)) + r)


def _bottleneck(m, x):
    r = x if m.downsample is None else m.downsample(x)
    y = F.relu(m.bn1(m.conv1(x)))
    y = F.relu(m.bn2(m.conv2(y)))
    return F.relu(m.bn3(m.conv3(y)) + r)


def _res3d(m, x):
    conv1, bn1, _, conv2, bn2 = m.res_branch
    res = bn2(conv2(F.relu(bn1(conv1(x)))))
    return F.relu(res + (m.skip_con(x) if len(m.skip_con) else x))


def _transition(m, x):
    return [_seq(t, x) if i == 0 else _seq(t[0], x) for i, t in enumerate(m)]


def _hr_module(m, *xs):
    xs = [_basic(b[0], x) for b, x in zip(m.branches, xs)]
    out = []
    for i, fuse in enumerate(m.fuse_layers):
        y = xs[i]
        for j, f in enumerate(fuse):
            if j > i:
                y = y + f(xs[j])
            elif j < i:
                t = xs[j]
                for step in f:
                    t = _seq(step, t)
                y = y + t
        out.append(F.relu(y))
    return out


# kind -> (module, its inputs, its unfolded forward, BatchNorms a call runs)
def _cases():
    return {
        "basic": (lambda: BasicBlock(8, 8), [(2, 8, 6, 5)], _basic, 2),
        "basic_downsample": (lambda: BasicBlock(8, 16, 2), [(2, 8, 6, 5)], _basic, 3),
        "bottleneck": (lambda: Bottleneck(16, 4), [(2, 16, 5, 6)], _bottleneck, 3),
        "bottleneck_downsample": (lambda: Bottleneck(8, 4, 2), [(2, 8, 6, 6)], _bottleneck, 4),
        "basic3d": (lambda: Basic3DBlock(8, 8, 3), [(2, 8, 4, 4, 3)],
                    lambda m, x: _seq(m.block, x), 1),
        "res3d": (lambda: Res3DBlock(8, 8), [(2, 8, 4, 3, 4)], _res3d, 2),
        "res3d_skip": (lambda: Res3DBlock(8, 16), [(2, 8, 4, 3, 4)], _res3d, 3),
        "upsample3d_skip": (lambda: Upsample3DBlock(16, 8), [(2, 16, 2, 3, 2), (2, 8, 4, 6, 4)],
                            lambda m, x, s: _seq(m.block, x) + s, 1),
        "hrnet_transition": (lambda: PoseHighResolutionNet._transition([16], [8, 16]),
                             [(2, 16, 8, 6)], _transition, 2),
        "hrnet_fuse": (lambda: HighResolutionModule(BasicBlock, (1, 1, 1), (8, 16, 8)),
                       [(2, 8, 8, 8), (2, 16, 4, 4), (2, 8, 2, 2)], _hr_module, 6 + 7),
    }


CASES = _cases()


def _call(kind, m, xs, folded=True):
    """The block's own forward (``folded``) or its code before the epilogue."""
    if not folded:
        return CASES[kind][2](m, *xs)
    if kind == "upsample3d_skip":
        return m(xs[0], None, xs[1])
    if kind == "hrnet_transition":
        return [t(xs[0]) for t in m]
    return m(xs if kind == "hrnet_fuse" else xs[0])


def _spread(m: nn.Module, seed: int) -> nn.Module:
    """Running statistics, affine and conv biases away from the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for sub in m.modules():
            if isinstance(sub, (BatchNorm2d, BatchNorm3d)):
                c = sub.num_features
                sub.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
                sub.bias.copy_(0.2 * torch.randn(c, generator=g))
                sub.running_mean.copy_(0.3 * torch.randn(c, generator=g))
                sub.running_var.copy_(0.5 + torch.rand(c, generator=g))
            elif isinstance(sub, nn.modules.conv._ConvNd) and sub.bias is not None:
                sub.bias.copy_(0.1 * torch.randn(sub.bias.shape, generator=g))
    return m


def _block(kind, seed=0):
    torch.manual_seed(seed)
    return _spread(CASES[kind][0](), seed)


def _inputs(kind, seed=1, grad=False):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).requires_grad_(grad) for s in CASES[kind][1]]


def _flat(out):
    return torch.cat([o.reshape(-1) for o in out]) if isinstance(out, list) else out.reshape(-1)


def _close(got, want, tol=TOL):
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


def _folds(call):
    before = spans.counters().get("bn_folds", 0)
    out = call()
    return out, spans.counters().get("bn_folds", 0) - before


def _grads(m, xs, out):
    """Gradients of a fixed weighting of ``out`` to the inputs, every conv
    weight and every BatchNorm weight and bias."""
    y = _flat(out)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
    params = [p for sub in m.modules() for name, p in sub.named_parameters(recurse=False)
              if isinstance(sub, (BatchNorm2d, BatchNorm3d)) or name == "weight"]
    return torch.autograd.grad((y * w).sum(), xs + params)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(CASES))
def test_folded_eval_equals_the_unfolded_code(kind, dtype):
    """Equal bits in float32 and in bf16: the epilogue rounds each step as
    the separate modules do."""
    m = _block(kind).eval()
    xs = [x.to(dtype) for x in _inputs(kind)]
    with torch.no_grad():
        got, folds = _folds(lambda: _call(kind, m, xs))
        want = _call(kind, m, xs, folded=False)
    assert folds == CASES[kind][3]
    assert torch.equal(_flat(got), _flat(want)), kind


@pytest.mark.parametrize("kind", list(CASES))
def test_folded_gradients_equal_the_unfolded_ones(kind):
    m = _block(kind).eval()
    xs = _inputs(kind, grad=True)
    got = _grads(m, xs, _call(kind, m, xs))
    want = _grads(m, xs, _call(kind, m, xs, folded=False))
    for i, (a, b) in enumerate(zip(got, want)):
        assert _close(a, b), (kind, i)


@pytest.mark.parametrize("kind", ["bottleneck_downsample", "res3d_skip", "upsample3d_skip",
                                  "hrnet_fuse"])
def test_train_mode_does_not_fold_and_is_the_unfolded_code(kind):
    m = _block(kind).train()
    ref = copy.deepcopy(m)
    xs = _inputs(kind, grad=True)
    out, folds = _folds(lambda: _call(kind, m, xs))
    assert folds == 0
    got = _grads(m, xs, out)
    want_out = _call(kind, ref, xs, folded=False)
    want = _grads(ref, xs, want_out)
    assert torch.equal(_flat(out), _flat(want_out))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                  ref.state_dict().values()))


def test_a_loaded_state_dict_reaches_the_next_call():
    kind = "res3d_skip"
    m = _block(kind).eval()
    xs = _inputs(kind)
    with torch.no_grad():
        first = _call(kind, m, xs)
        m.load_state_dict(_block(kind, seed=3).state_dict())
        got = _call(kind, m, xs)
        want = _call(kind, m, xs, folded=False)
    assert torch.equal(got, want) and not _close(got, first, 1e-2)


@pytest.mark.parametrize("net", ["resnet18", "v2v", "hrnet"])
def test_bn_folds_a_call_equals_its_batchnorm_modules(net):
    if net == "resnet18":
        m, x = PoseResNet(18, 4, (16, 16, 16)), torch.randn(1, 32, 32, 3)
    elif net == "v2v":
        m, x = V2VNet(4, 4), torch.randn(1, 8, 8, 8, 4)
    else:
        stage = {"NUM_MODULES": 1, "BLOCK": "BASIC", "FUSE_METHOD": "SUM"}
        extra = {"FINAL_CONV_KERNEL": 1, **{
            f"STAGE{s}": dict(stage, NUM_BRANCHES=s, NUM_BLOCKS=(1,) * s,
                              NUM_CHANNELS=(8, 16, 32, 64)[:s]) for s in (2, 3, 4)}}
        m, x = PoseHighResolutionNet(4, extra, (64, 64)), torch.randn(1, 64, 64, 3)
    bns = sum(isinstance(s, (BatchNorm2d, BatchNorm3d)) for s in m.modules())
    with torch.no_grad():
        _, folds = _folds(lambda: m.eval()(x))
        _, train_folds = _folds(lambda: m.train()(x))
    assert (folds, train_folds) == (bns, 0)


def _ops(x, affine, residual, res_affine, relu, after):
    """The separate ops the epilogue replaces: the conv's bias, the
    BatchNorm's affine, the residual (through its own), the ReLU."""
    def a(t, aff):
        s, b, c = (v if v is None else v.view(1, -1, 1, 1) for v in aff)
        return (t if c is None else t + c) * s + b

    y = a(x, affine)
    if residual is not None and not after:
        y = y + (residual if res_affine is None else a(residual, res_affine))
    y = F.relu(y) if relu else y
    return y + residual if residual is not None and after else y


@pytest.mark.parametrize("mode", ["bias_relu", "residual", "bias_skip_relu", "relu_then_residual"])
def test_the_epilogue_is_the_separate_ops(mode):
    """``ops/conv_epilogue.epilogue`` (the form with a conv bias that the
    card takes) against the separate ops: equal bits forward; gradients to
    every input and vector within 1e-5 of the largest entry."""
    from selfpose3d_tpu_torch.ops.conv_epilogue import epilogue

    g = torch.Generator().manual_seed(5)

    def vec():
        return torch.randn(8, generator=g).requires_grad_(True)

    x = torch.randn(2, 8, 5, 6, generator=g).requires_grad_(True)
    r = torch.randn(2, 8, 5, 6, generator=g).requires_grad_(True) if mode != "bias_relu" else None
    affine = (vec(), vec(), vec() if "bias" in mode else None)
    res_affine = (vec(), vec(), vec()) if mode == "bias_skip_relu" else None
    relu, after = mode != "residual", mode == "relu_then_residual"
    inputs = [t for t in (x, r, *affine, *(res_affine or ())) if t is not None]
    w = torch.randn(2, 8, 5, 6, generator=g)
    got = epilogue(x, affine, r, res_affine, relu, after)
    want = _ops(x, affine, r, res_affine, relu, after)
    assert torch.equal(got, want)
    for a, b in zip(torch.autograd.grad((got * w).sum(), inputs),
                    torch.autograd.grad((want * w).sum(), inputs)):
        assert _close(a, b), mode
