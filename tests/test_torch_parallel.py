"""Data parallelism of the port (``selfpose3d_tpu_torch/parallel/mesh.py``)
on the CPU: two gloo ranks at one example each against one process at the
global batch of two, and the port's BatchNorm over two ranks against the
JAX package's under ``jax.jit`` on a 2-device mesh.

The processes start once (``tests/torch_parallel_worker.py``: nine,
FileStore rendezvous under a temporary directory, one thread a process)
at the widths of tests/test_torch_stages.py with fewer pixels and smaller
cubes (the worker's SSV): the SSV step with the attention net, L1_ATTN,
synthetic roots and a trainable backbone, so that both BatchNorm branches
run (the masked one in PoseNet), its worst L1 term on rank 1; the
supervised step under USE_GT with 1 and 3 people, for ``loss_cord``'s
count, its backbone frozen as its YAML has it; and ``cli.train_3d
--distributed`` (an epoch, then one resumed from its checkpoint) against
the same CLI runs in one process at the global batch. Each aspect is a
test of its own.

Bars (``selfpose3d_tpu_torch/parallel/check.py:BARS``), those of
tests/test_torch_train_step.py: loss terms rel 1e-4 (abs 1e-7); running
statistics rel 1e-4, abs 1e-5; parameters after Adam abs 1e-5 where the
gradient decides Adam's step. Gradients per tensor 1e-3 of its largest
entry (the CPU gives 1e-7 to 6e-5; the card's float32 summation orders,
2.5e-4), with BatchNorm on its running statistics (``_bn_eval``); with
batch statistics two float32 summation orders of one process agree only
to 0.076 of a tensor's largest entry (the module docstring of check.py),
so there each tensor is held to 0.25, and per net the median share to
0.03 and the relative L2 to 1.5e-2; the gradients zero in exact
arithmetic (``check.zero_by_structure``) to 1e-4 of their net's largest
entry in both modes; every parameter after Adam to 2 lr. Both ranks hold
bit-equal gradients, buffers and parameters. World size 1 through the distributed path is bit-equal
to the plain path. The validation metric atol 1e-6, as
tests/test_sharded_eval.py holds the JAX package's sharded validation.

The whole slice is held to the JAX package through the one-process port,
which tests/test_torch_train_step.py holds to it; here the changed module
itself, the BatchNorm moments across ranks, meets JAX directly.
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import jax
import jax.numpy as jnp

from selfpose3d_tpu.models.norm import FastBatchNorm
from selfpose3d_tpu.parallel.mesh import make_mesh, shard_batch

from selfpose3d_tpu_torch.parallel.check import BARS, failures
from tests.torch_parallel_worker import BN_MASKS, BN_SHAPE, PROCS, STEPS, main as worker_main


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each process's results, the JAX BatchNorm's)."""
    workdir = str(tmp_path_factory.mktemp("gloo"))
    # a fork server that has imported torch and the worker once forks the
    # processes, so that each does not import torch again
    smp = mp.get_context("forkserver")
    smp.set_forkserver_preload(["tests.torch_parallel_worker"])
    queues = {name + ack: smp.SimpleQueue() for name in STEPS for ack in ("", "_ack")}
    ctx = mp.start_processes(worker_main, args=(workdir, queues), nprocs=len(PROCS),
                             join=False, start_method="forkserver")
    jax_bn = _jax_batchnorm()  # while the processes run
    while not ctx.join():
        pass
    return [torch.load(f"{workdir}/proc{i}.pt", weights_only=False) for i in PROCS], jax_bn


def _ranks(procs, case):
    """The two ranks' results of ``case``."""
    return [p[case] for i, p in enumerate(procs) if PROCS[i][0] == "rank" and case in p]


def _one(procs, case):
    """The one-process result of ``case``."""
    return next(p[case] for i, p in enumerate(procs) if PROCS[i][0] != "rank" and case in p)


def _jax_batchnorm():
    """FastBatchNorm (momentum 0.9, flax's fast variance) in train mode
    under jit on a 2-device mesh, the batch sharded: outputs, the
    gradients of sum(y * cot) in the input, scale and bias, running
    statistics, per mask."""
    rs = np.random.RandomState(5)
    x = rs.randn(*BN_SHAPE).astype(np.float32) * 2.0 + 0.5
    cot = rs.randn(*BN_SHAPE).astype(np.float32)
    scale = (0.5 + rs.rand(BN_SHAPE[-1])).astype(np.float32)
    bias = rs.randn(BN_SHAPE[-1]).astype(np.float32)
    C = BN_SHAPE[-1]
    bn = FastBatchNorm(use_running_average=False, momentum=0.9)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}
    mesh = make_mesh(2)

    def run(x, m=None):
        def loss(x, params):
            y, mut = bn.apply({**variables, "params": params}, x, mask=m,
                              mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, mut["batch_stats"])

        (_, (y, stats)), (dx, dp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            x, variables["params"])
        return y, dx, dp["scale"], dp["bias"], stats["mean"], stats["var"]

    out = {}
    for name, mask in BN_MASKS.items():
        args = (x,) if mask is None else (x, np.asarray(mask).reshape(-1, 1, 1, 1, 1))
        args = shard_batch(args, mesh)
        assert len(args[0].sharding.device_set) == 2
        y, dx, dw, db, mean, var = (np.asarray(a) for a in jax.jit(run)(*args))
        out[name] = {"y": y, "dx": dx, "dw": dw, "db": db, "mean": mean, "var": var}
    return out


STEP_ASPECTS = [(case, aspect) for case in ("ssv", "ssv_bn_eval", "supervised_bn_eval")
                for aspect in ("ranks", "loss terms", "running statistics", "gradients",
                               "parameters")]


@pytest.mark.parametrize("case, aspect", STEP_ASPECTS)
def test_train_step_over_ranks_equals_one_process(runs, case, aspect):
    """``case`` on 2 ranks x 1 example against 1 process at 2 examples
    (check.compare, in the process that ran the one-process step)."""
    c = _one(runs[0], case)
    bn_eval = case.endswith("_bn_eval")
    assert c["ranks_equal"] and c["same_keys"]
    assert not failures(c, bn_eval)[aspect], failures(c, bn_eval)[aspect]
    if aspect == "gradients":
        assert len(c["grad_share"]) >= 30  # enough tensors held to the share bar
        if case == "ssv":  # the V2V biases in front of batch-statistics BatchNorm
            assert len(c["grad_zero"]) >= 40
    if aspect == "loss terms" and case.startswith("supervised"):
        assert "loss_cord" in c["terms"]


def test_supervised_loss_cord_is_a_ratio_over_the_global_count(runs):
    """1 and 3 valid candidates: each rank's own mean would weigh rank 0's
    one candidate as much as rank 1's three."""
    ranks = [r["metrics"]["loss_cord"] for r in _ranks(runs[0], "supervised_bn_eval_record")]
    assert ranks[0] == ranks[1] > 0  # the reported metric: the mean over ranks


def test_launches_per_rank(runs):
    """On the CPU no kernel launches; every rank runs the plain samplers."""
    got = [r["launches"] for r in _ranks(runs[0], "ssv_record")]
    got.append(_one(runs[0], "ssv_one_process")["launches"])
    assert got[0] == got[1] == got[2] and set(got[0].values()) == {0}


@pytest.mark.parametrize("case", ["any_valid", "ssv_record"])
def test_batch_level_reductions_equal_one_process(runs, case):
    """No valid candidate on rank 0 (USE_GT, rank 0's scene empty): the
    ``any_valid`` gate is the global batch's. The SSV step's worst L1 term
    lies on rank 1 (its pseudo labels 40 px off): rank 0 keeps all of its
    terms. The reported terms are the means over ranks."""
    procs = runs[0]
    r0, r1 = _ranks(procs, case)
    one = _one(procs, case if case == "any_valid" else "ssv_one_process")
    if case == "ssv_record":
        r0, r1, one = r0["metrics"], r1["metrics"], one["metrics"]
    assert r0 == r1 and set(r0) == set(one)
    for k, w in one.items():
        np.testing.assert_allclose(r0[k], w, rtol=BARS["loss_rel"], atol=BARS["loss_abs"], err_msg=k)
    key = "loss_pose3d_ssv" if case == "any_valid" else "loss_pose3d_l1_ssv"
    assert one[key] > 0


def test_bucket_dispatch_agrees_across_ranks(runs):
    """Person counts 1 and 2 on the two ranks, buckets (2, 3, 4): both pick
    the cap of 2 + 1, as one process does (rank 0 alone would pick 2)."""
    (r0, r1), one = _ranks(runs[0], "k_cap"), _one(runs[0], "k_cap")
    assert r0 == r1 == one == 3


@pytest.mark.parametrize("frames", [5, 1])
def test_validate_3d_over_ranks_equals_one_process(runs, frames):
    """Stripes of 3 and 2 frames (5 frames); an empty one on rank 1 (1)."""
    case = f"validate_{frames}"
    (r0, r1), one = _ranks(runs[0], case), _one(runs[0], case)
    assert len(one["preds"]) == frames
    for r in (r0, r1):
        np.testing.assert_array_equal(r["preds"], one["preds"])
        np.testing.assert_array_equal(r["roots"], one["roots"])
        np.testing.assert_allclose(r["precision"], one["precision"], atol=1e-6)


def test_world_size_1_is_bit_equal_to_the_plain_path(runs):
    """The SSV step through DDP in a group of one against the plain step:
    the same loss terms, and the same checksum of every gradient, buffer
    and parameter."""
    ddp, plain = _ranks(runs[0], "ssv_world_1")[0], _one(runs[0], "ssv_one_process")
    assert ddp["metrics"] == plain["metrics"]
    assert ddp["digest"] == plain["digest"]


@pytest.mark.parametrize("mask", list(BN_MASKS))
def test_batchnorm_over_ranks_matches_jax_on_a_mesh(runs, mask):
    """Outputs and input gradients 1e-5; the scale and bias gradients (the
    sum of the ranks' shares, as DDP's mean of the ranks' sums), each a
    sum over every example, rel 1e-5 and abs 1e-6 of their largest entry;
    running statistics 1e-5 / 1e-6, equal on both ranks."""
    procs, jax_bn = runs
    got = [r[mask] for r in _ranks(procs, "batchnorm")]
    want = jax_bn[mask]
    for key in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([g[key] for g in got]), want[key],
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ("dw", "db"):
        np.testing.assert_allclose(got[0][key] + got[1][key], want[key], rtol=1e-5,
                                   atol=1e-6 * np.abs(want[key]).max(), err_msg=key)
    for key in ("mean", "var"):
        np.testing.assert_array_equal(got[0][key], got[1][key])
        np.testing.assert_allclose(got[0][key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)


def _cli(procs):
    """The CLI pair's ranks' results and the one process's."""
    return _ranks(procs, "cli"), _one(procs, "cli")


def test_cli_distributed_epochs_equal_one_process(runs):
    """``cli.train_3d --distributed`` on 2 ranks x 1 frame (the loaders'
    stripes, the bucket dispatch agreeing on the global batch, the metrics
    averaged over ranks at PRINT_FREQ), then resumed from rank 0's
    checkpoint and wrapped again, against one process's runs at 2 frames:
    the first epoch's loss terms rel 1e-4; the resumed epoch's rel 1e-3,
    as its step follows an Adam step whose sign rounding sets on some
    entries (one process at 1 and at 4 threads: up to 1.2e-4); each
    validation metric atol 1e-6."""
    (r0, r1), one = _cli(runs[0])
    for got in (r0, r1):
        for run, want, rtol in zip(got["runs"], one["runs"], (BARS["loss_rel"], 1e-3)):
            assert run["epoch"]["steps"] == want["epoch"]["steps"] == 1
            losses = {k: v for k, v in want["epoch"].items() if k.startswith("loss")}
            assert len(losses) >= 4
            for k, w in losses.items():
                np.testing.assert_allclose(run["epoch"][k], w, rtol=rtol,
                                           atol=BARS["loss_abs"], err_msg=k)
            np.testing.assert_allclose(run["aps"], want["aps"], atol=1e-6)
            np.testing.assert_allclose(run["precision"], want["precision"], atol=1e-6)


def test_cli_distributed_logs_and_dumps_on_rank_0(runs):
    """TensorBoard writers and debug dumps on rank 0 only, one a run."""
    (r0, r1), one = _cli(runs[0])
    assert r0["writers"] == one["writers"] == 2 and r1["writers"] == 0
    for run, want in zip(r0["runs"], one["runs"]):
        assert run["epoch"]["debug_dumps"] == want["epoch"]["debug_dumps"] == 1
    assert all("debug_dumps" not in run["epoch"] for run in r1["runs"])


@pytest.mark.parametrize("epoch", [1, 2])
def test_cli_distributed_checkpoint_equals_one_process(runs, epoch):
    """Rank 0's checkpoints hold the model's own keys (not DDP's), the
    epoch's step count and parameters within ``epoch`` x 2 lr of one
    process's (each Adam step moves an entry at most lr, of any sign where
    rounding decides it). After the first step the running statistics are
    held to rel 1e-4, abs 1e-5; after the second they follow those
    parameters, and are not held."""
    c = _one(runs[0], "cli_checkpoints")[epoch - 1]
    assert c["same_keys"]
    got, want = c["meta"]
    assert got["epoch"] == want["epoch"] == epoch and got["step"] == want["step"] == epoch
    assert c["params"] <= epoch * 2 * 1e-4, c["params"]
    if epoch == 1:
        assert c["stats_excess"] <= BARS["stats_abs"], c["stats_excess"]


@pytest.mark.parametrize("mask", list(BN_MASKS))
def test_batchnorm_over_ranks_keeps_no_float32_copy(runs, mask):
    """Across ranks the backward keeps a bfloat16 input as it is, with
    (C,) vectors and the mask beside it: no float32 copy of it."""
    for r in _ranks(runs[0], "batchnorm"):
        got = r[mask]
        assert got["x_bytes"] <= got["saved"] <= got["x_bytes"] + 1024, got["saved"]


def test_all_reduce_sum_sums_values_and_cotangents(runs):
    """Over 2 ranks: 2 (1 + 2) forward, and each rank's input gets 2 (1 +
    2), every rank's cotangent; in one process 2 and 2."""
    (r0, r1), one = _ranks(runs[0], "all_reduce"), _one(runs[0], "all_reduce")
    assert r0 == r1 == {"y": 6.0, "dx": 6.0} and one == {"y": 2.0, "dx": 2.0}
