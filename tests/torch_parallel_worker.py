"""The processes of tests/test_torch_parallel.py (imports no JAX).

``main(i, workdir, queues)`` runs in six spawned processes, one thread
each (PROCS). Two pairs of processes each form a gloo group of two ranks
(a FileStore under ``workdir``) and run their cases on their halves of
each global batch; two processes run the same cases in one process at
the global batch and hold rank 0's train-step records, which reach them
through shared memory, against their own (``parallel.check.compare``: a
record holds every gradient and parameter, so only the comparison comes
back). Pair a's rank 1 then runs the SSV step through the distributed
path in a group of its own (world size 1), whose checksum the test holds
to the one-process step's. A third pair runs ``cli.train_3d --distributed``
twice (an epoch, then one resumed from its checkpoint) and a ninth process
the same two runs at the global batch, which then holds the pair's last
checkpoint against its own. The work is spread so that no process runs
long. Each process saves its small results to ``workdir/proc<i>.pt``.
"""

import os
import time

import numpy as np
import torch
import torch._dynamo  # noqa: F401 (the first optimizer step imports it: the fork server, once)
import torch.distributed as dist

from selfpose3d_tpu_torch.cli import train_3d
from selfpose3d_tpu_torch.config import load_config
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
from selfpose3d_tpu_torch.data.synthetic_dataset import SyntheticSceneDataset
from selfpose3d_tpu_torch.models import get_model
from selfpose3d_tpu_torch.models.multi_person import cat_branches
from selfpose3d_tpu_torch.models.norm import BatchNorm3d
from selfpose3d_tpu_torch.parallel import mesh
from selfpose3d_tpu_torch.parallel.check import (
    compare, local_rows, pack, train_step_record, unpack)
from selfpose3d_tpu_torch.train import checkpoint
from selfpose3d_tpu_torch.train.loop import pick_k_cap, validate_3d

TINY = "configs/synthetic/tiny_ssv.yaml"
ROTS = (15.0, -12.0, 0.0)
# tiny_ssv.yaml with the attention net and L1_ATTN: the widths of
# tests/test_torch_stages.py (ResNet-18 backbone and attention net, 15
# joints, 2 views, K = 4) at a quarter of its pixels (64x32 images) and
# cubes cut to 8x8x4 (root) and 8^3 (PoseNet), the least the V2V's two
# poolings take, so that the file keeps to its time
SSV = {"DEBUG": {"DEBUG": False}, "WITH_ATTN": True, "L1_ATTN": True,
       "MULTI_PERSON": {"MAX_PEOPLE_NUM": 4, "INITIAL_CUBE_SIZE": [8, 8, 4]},
       "PICT_STRUCT": {"CUBE_SIZE": [8, 8, 8]}, "TEST": {"BATCH_SIZE": 2}, "WORKERS": 1}
NETWORK = {"IMAGE_SIZE": [64, 32], "HEATMAP_SIZE": [16, 8]}
BN_SHAPE = (4, 3, 4, 5, 6)  # (B, D, H, W, C), channel-last as the JAX package
BN_MASKS = {"unmasked": None, "masked": [True, False, True, True],
            "masked, none on rank 0": [False, False, True, True]}
STEPS = ("ssv", "ssv_bn_eval", "supervised_bn_eval")
# process -> (role, group, rank, train steps, runs the small cases)
PROCS = {0: ("rank", "a", 0, ("ssv",), False), 1: ("rank", "a", 1, ("ssv",), False),
         2: ("rank", "b", 0, STEPS[1:], True), 3: ("rank", "b", 1, STEPS[1:], True),
         4: ("one process", None, 0, ("ssv",), True), 5: ("one process", None, 0, STEPS[1:], False),
         6: ("rank", "cli", 0, (), False), 7: ("rank", "cli", 1, (), False),
         8: ("one process", "cli", 0, (), False)}
# the CLI runs: the worker's SSV config without the attention net (the
# step's cases hold it), with the host bucket dispatch and the debug dumps
# on, 2 synthetic frames a split; PoseNet's candidates are
# the GT roots (USE_GT), since an untrained RootNet's proposal scores
# nearly tie, and the rounding that sets the sign of some of Adam's first
# steps (parallel/check.py) would reorder them in the second epoch
CLI_SETS = {"WITH_ATTN": False, "L1_ATTN": False, "WORKERS": 1, "DEBUG.DEBUG": True,
            "NETWORK.USE_GT": True,
            "MULTI_PERSON.MAX_PEOPLE_NUM": 4, "MULTI_PERSON.INITIAL_CUBE_SIZE": [8, 8, 4],
            "MULTI_PERSON.CANDIDATE_BUCKETS": [2, 3], "TRAIN.BUCKET_DISPATCH": "meta",
            "PICT_STRUCT.CUBE_SIZE": [8, 8, 8], "TEST.BATCH_SIZE": 2,
            **{f"NETWORK.{k}": v for k, v in NETWORK.items()}}


def ssv_cfg(**network):
    return load_config(TINY, overrides={**SSV, "NETWORK": {**NETWORK, **network}})


def supervised_cfg():
    """The supervised baseline under USE_GT, its backbone frozen as its
    YAML has it (configs/panoptic/resnet50/prn64_cpn80x80x20_960x512_cam5.yaml)."""
    return load_config(TINY, overrides={
        **SSV, "MODEL": "multi_person_posenet", "WITH_SSV": False, "WITH_ATTN": False,
        "NETWORK": {**NETWORK, "USE_GT": True, "TRAIN_BACKBONE": False}})


def branches(cfg, num_person=(3, 3), n=3):
    """``n`` augmentation branches of a global batch of 2 scenes, row i
    with ``num_person[i]`` people."""
    out = []
    for rot in ROTS[3 - n:]:
        rows = [make_synthetic_branch(cfg, batch_size=1, num_person=p, seed=3 + i,
                                      rot_deg=rot, device="cpu")[0]
                for i, p in enumerate(num_person)]
        out.append(cat_branches(*rows))
    return out


def ssv_branches(cfg):
    """The SSV cases' batch: rank 1's pseudo labels 40 px off, so the
    worst L1 terms are rank 1's (L1_ATTN drops the global batch's worst)."""
    brs = branches(cfg)
    for b in brs[:2]:
        b.joints[1] += 40.0
    return brs


def step(name):
    """The record of a train-step case: the SSV step with attention,
    L1_ATTN (its worst term on rank 1), synthetic roots and a trainable
    backbone; the supervised step under USE_GT with 1 and 3 people
    (``loss_cord``'s count); ``_bn_eval`` with BatchNorm on its running
    statistics."""
    kind, bn_eval = name.split("_bn_eval")[0], name.endswith("_bn_eval")
    if kind == "ssv":
        cfg = ssv_cfg()
        brs = ssv_branches(cfg)
    else:
        cfg = supervised_cfg()
        brs = branches(cfg, (1, 3), n=1)
    return train_step_record(cfg, brs, bn_eval=bn_eval)


@torch.no_grad()
def any_valid_losses():
    """The loss terms' means over ranks of a training forward of the SSV
    model (seed 0) on this rank's rows, with no candidate on rank 0's
    scene (USE_GT, its person count 0)."""
    cfg = ssv_cfg(USE_GT=True)
    brs = ssv_branches(cfg)
    brs[2].num_person[0] = 0
    model = get_model(cfg, device="cpu", seed=0)
    _, _, _, losses = model.ssv_losses(
        *local_rows(brs), train_posenet_stage=True, use_l1_stage=True, train=True,
        generator=torch.Generator().manual_seed(0))
    names = list(losses)
    means = mesh.mean_over_ranks(torch.stack([losses[k].mean() for k in names]))
    return dict(zip(names, means.tolist()))


def saved_bytes(run) -> int:
    """The bytes of the tensors autograd keeps for the backward of ``run()``."""
    total = [0]

    def keep(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
        run()
    return total[0]


def batchnorm_case():
    """The port's BatchNorm3d in train mode on this rank's rows of the
    BN_SHAPE input: outputs, the gradients of sum(y * cot) (this rank's
    share of the weight's and bias's) and the running statistics, per
    mask; and what its backward keeps of a bfloat16 input."""
    rs = np.random.RandomState(5)
    x = rs.randn(*BN_SHAPE).astype(np.float32) * 2.0 + 0.5
    cot = rs.randn(*BN_SHAPE).astype(np.float32)
    scale = (0.5 + rs.rand(BN_SHAPE[-1])).astype(np.float32)
    bias = rs.randn(BN_SHAPE[-1]).astype(np.float32)
    b, r = BN_SHAPE[0] // mesh.world(), mesh.rank()
    rows = slice(r * b, (r + 1) * b)
    out = {}
    for name, mask in BN_MASKS.items():
        bn = BatchNorm3d(BN_SHAPE[-1]).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(x[rows]).permute(0, 4, 1, 2, 3).contiguous().requires_grad_()
        m = None if mask is None else torch.tensor(mask[rows])
        y = bn(xt, m)
        (y * torch.from_numpy(cot[rows]).permute(0, 4, 1, 2, 3)).sum().backward()
        out[name] = {"y": y.detach().permute(0, 2, 3, 4, 1).numpy(),
                     "dx": xt.grad.permute(0, 2, 3, 4, 1).numpy(),
                     "dw": bn.weight.grad.numpy().copy(), "db": bn.bias.grad.numpy().copy(),
                     "mean": bn.running_mean.numpy().copy(),
                     "var": bn.running_var.numpy().copy()}
        xb = xt.detach().bfloat16().requires_grad_()
        out[name]["saved"] = saved_bytes(lambda: bn(xb, m))
        out[name]["x_bytes"] = xb.numel() * xb.element_size()
    return out


def validate(model, frames):
    """``validate_3d`` of ``model`` on ``frames`` synthetic frames: the
    metric and what ``dataset.evaluate`` received."""
    cfg = model.cfg
    ds = SyntheticSceneDataset(cfg, "validation", False, num_frames=frames)
    seen = {}
    evaluate = ds.evaluate

    def capture(preds, roots=None, output_dir=""):
        seen["preds"], seen["roots"] = np.stack(preds), np.stack(roots)
        return evaluate(preds, roots, output_dir)

    ds.evaluate = capture
    precision = validate_3d(cfg, model, ds)
    return {"precision": precision, **seen}


def all_reduce_case():
    """``AllReduceSum`` of 2 x_r, x_r = rank + 1, under the cotangent rank
    + 1: the forward's value and x's gradient (the sum of every rank's
    cotangent, times 2)."""
    x = torch.tensor([1.0 + mesh.rank()], requires_grad=True)
    y = mesh.all_reduce_sum(2.0 * x)
    (y * (1.0 + mesh.rank())).sum().backward()
    return {"y": float(y), "dx": float(x.grad)}


def small_cases():
    """The cases whose results are small."""
    counts = [[1], [2]] if mesh.world() > 1 else [[1, 2]]
    model = get_model(ssv_cfg(), device="cpu", seed=0)
    return {
        "any_valid": any_valid_losses(),
        "k_cap": pick_k_cap((2, 3, 4), torch.tensor(counts[mesh.rank()]), 4),
        "validate_5": validate(model, 5),
        "validate_1": validate(model, 1),  # an empty stripe on rank 1
        "batchnorm": batchnorm_case(),
        "all_reduce": all_reduce_case(),
    }


class _Writer:
    def add_scalar(self, *a):
        pass

    def close(self):
        pass


def _meters(meters):
    return {k: (m.avg if hasattr(m, "avg") else m) for k, m in meters.items()
            if hasattr(m, "avg") or k in ("steps", "debug_dumps")}


def cli_runs(workdir, batch, distributed):
    """``cli.train_3d`` on the SSV config (CLI_SETS) at TRAIN.BATCH_SIZE
    ``batch``: epoch 0, then a run resumed from its checkpoint for epoch 1;
    ``distributed`` in this process's group. -> each run's epoch meters and
    validation metric, and the TensorBoard writers this process opened.
    TensorBoard's writer gives way to a stub (importing TensorBoard can
    pull in TensorFlow)."""
    writers = []
    train_3d.TBWriter = lambda log_dir: writers.append(log_dir) or _Writer()
    datasets = train_3d.datasets

    def two_frames(cfg):
        splits = datasets(cfg)
        for ds in splits:
            ds.num_frames = 2
        return splits

    train_3d.datasets = two_frames
    sets = {**CLI_SETS, "OUTPUT_DIR": f"{workdir}/out", "LOG_DIR": f"{workdir}/log",
            "TRAIN.BATCH_SIZE": batch}
    argv = ["--cfg", TINY, "--device", "cpu"] + ["--distributed"] * distributed
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    runs = []
    for more in ([], ["--set", "TRAIN.RESUME=true", "--set", "TRAIN.END_EPOCH=2"]):
        rep = {}
        precision = train_3d.main(argv + more, report=rep)
        runs.append({"epoch": _meters(rep["epoch"]), "precision": precision,
                     "aps": rep["validation"]["aps"]})
    return {"runs": runs, "writers": len(writers)}


def cli_checkpoint(workdir, epoch):
    """The checkpoint of ``epoch`` of ``cli_runs`` under ``workdir``: its
    meta and model."""
    out = f"{workdir}/out/synthetic/multi_person_posenet_ssv_18/tiny_ssv"
    payload = checkpoint.torch.load(f"{out}/checkpoints/epoch_{epoch}.pt", map_location="cpu",
                                    weights_only=True)
    return {"meta": payload["meta"], "model": payload["model"]}


def compare_checkpoints(got, want):
    """The pair's checkpoint against one process's: their meta, the largest
    parameter difference, and the running statistics' largest excess over
    rel 1e-4."""
    params, stats = 0.0, 0.0
    for k, w in want["model"].items():
        d = (got["model"][k].float() - w.float()).abs()
        if "running_" in k:
            stats = max(stats, float((d - 1e-4 * w.float().abs()).max()))
        elif "num_batches" not in k:
            params = max(params, float(d.max()))
    return {"meta": (got["meta"], want["meta"]), "params": params, "stats_excess": stats,
            "same_keys": set(got["model"]) == set(want["model"])}


def _join(workdir, name, rank, world):
    store = dist.FileStore(os.path.join(workdir, name), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)


def _small(rec):
    return {k: rec[k] for k in ("metrics", "launches", "ranks_equal", "digest")}


def main(i, workdir, queues):
    """Process ``i`` of PROCS; ``queues[name]`` carries rank 0's record of
    step ``name`` to the one-process side, ``queues[name + "_ack"]`` its
    acknowledgement back (the sender keeps the shared memory alive until
    then)."""
    torch.set_num_threads(1)
    role, group, rank, steps, small = PROCS[i]
    if role == "rank":
        _join(workdir, group, rank, 2)
    out = small_cases() if small else {}
    if group == "cli":
        own = f"{workdir}/cli_{'pair' if role == 'rank' else 'one'}"
        out["cli"] = cli_runs(own, 1 if role == "rank" else 2, role == "rank")
        if role != "rank":  # the pair's checkpoint, once rank 0 has written it
            while not os.path.exists(f"{workdir}/cli_pair/done"):
                time.sleep(0.05)
            out["cli_checkpoints"] = [compare_checkpoints(
                cli_checkpoint(f"{workdir}/cli_pair", e), cli_checkpoint(own, e)) for e in (1, 2)]
        elif rank == 0:
            open(f"{own}/done", "w").close()
    for name in steps:
        rec = step(name)
        if role == "rank":
            out[name + "_record"] = _small(rec)
            if rank == 0:
                queues[name].put(pack(rec))
        else:
            out[name] = compare(unpack(queues[name].get()), rec)
            out[name + "_one_process"] = _small(rec)
            queues[name + "_ack"].put(name)
    if role == "rank":
        dist.destroy_process_group()
        if rank == 0:
            for name in steps:
                queues[name + "_ack"].get()
        elif group == "a":  # the distributed path at world size 1
            _join(workdir, "single", 0, 1)
            out["ssv_world_1"] = _small(step("ssv"))
            dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"proc{i}.pt"))
