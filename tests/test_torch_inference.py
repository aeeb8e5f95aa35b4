"""The port's whole inference slice against JAX ``do_inference``.

Same numpy-seeded weights (JAX tree -> ``convert.from_jax``) and the same
synthetic scene through both packages. Bars are those of
tests/test_full_parity.py: proposals to 1e-3 mm with equal flags in the
same slot order, poses to < 1 mm per joint.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
import jax

from selfpose3d_tpu.data.synthetic import make_synthetic_branch as j_make_branch
from selfpose3d_tpu.models import get_model as j_get_model

from selfpose3d_tpu_torch.convert.from_jax import from_jax
from selfpose3d_tpu_torch.data.synthetic import make_synthetic_branch
from selfpose3d_tpu_torch.models import get_model

from tests.test_multi_person import small_cfg
from tests.test_torch_models import random_variables

REPO = Path(__file__).resolve().parents[1]


def _cfg(**mp):
    return small_cfg(MULTI_PERSON={"MAX_PEOPLE_NUM": 4, "THRESHOLD": -100.0, **mp})


@pytest.fixture(scope="module")
def models():
    cfg = _cfg()
    jm = j_get_model(cfg)
    jb, _ = j_make_branch(cfg, batch_size=1, seed=3, with_images=True)
    shapes = jax.eval_shape(
        lambda b: jm.init({"params": jax.random.PRNGKey(0), "synth": jax.random.PRNGKey(1)},
                          b, method="do_inference"), jb)
    var = random_variables(shapes, seed=11)
    # lift the root detection volume positive so top-k is not tie-bound
    # (tests/test_full_parity.py:80-83)
    var["params"]["root_net"]["v2v_net"]["output_layer"]["bias"] += 1.0
    port = get_model(cfg, device="cpu")
    port.load_state_dict(from_jax(var))
    return cfg, jm, var, port


def _branches(cfg, with_images, batch_size, seed):
    jb, _ = j_make_branch(cfg, batch_size=batch_size, num_person=3, seed=seed,
                          with_images=with_images)
    tb, _ = make_synthetic_branch(cfg, batch_size=batch_size, num_person=3, seed=seed,
                                  with_images=with_images, device="cpu")
    return jb, tb


def _assert_same_inference(jout, tout):
    pred_j, hm_j, gc_j = (np.asarray(a) for a in jout)
    pred_t, hm_t, gc_t = (a.numpy() for a in tout)
    np.testing.assert_allclose(hm_t, hm_j, rtol=1e-4, atol=1e-4 * np.abs(hm_j).max())
    np.testing.assert_allclose(gc_t[..., :3], gc_j[..., :3], atol=1e-3)
    np.testing.assert_array_equal(gc_t[..., 3], gc_j[..., 3])
    np.testing.assert_allclose(gc_t[..., 4], gc_j[..., 4], atol=1e-4)
    valid = gc_j[..., 3] >= 0
    assert valid.any()
    err = np.linalg.norm(pred_t[..., :3] - pred_j[..., :3], axis=-1)  # (B, K, J)
    assert err[valid].max() < 1.0, f"max per-joint error {err[valid].max():.3f} mm"
    assert (pred_t[~valid][..., :3] == 0).all()
    np.testing.assert_allclose(pred_t[..., 3:], pred_j[..., 3:], atol=1e-4)


@pytest.mark.parametrize("with_images", [False, True])
def test_do_inference_matches_jax(models, with_images):
    cfg, jm, var, port = models
    jb, tb = _branches(cfg, with_images, 1, seed=3)
    jout = jm.apply(var, jb, method="do_inference")
    tout = port.do_inference(tb)
    assert tout[0].shape == (1, 4, 15, 5)
    assert tout[1].shape == (1, 3, 32, 64, 15)
    assert tout[2].shape == (1, 4, 5)
    _assert_same_inference(jout, tout)


def test_root_cubes_match_jax(models):
    cfg, jm, var, port = models
    jb, tb = _branches(cfg, False, 1, seed=5)

    def root_cubes(mdl, br):
        hm = mdl._heatmaps(br, train=False)
        return mdl.root_net(mdl._root_heatmaps(hm), br.cam, br.trans, br.orig_wh)[0]

    want = np.asarray(jm.apply(var, jb, method=root_cubes))
    with torch.no_grad():
        got, _ = port.root_net(port.root_heatmaps(tb.input_heatmaps), tb.cam, tb.trans, tb.orig_wh)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_bucketed_do_inference_matches_jax(models):
    """Candidate buckets (2, 3) with a threshold that leaves at most two
    valid slots: the port runs the 2-candidate bucket and still equals the
    JAX package's switch-dispatched inference."""
    cfg, jm, var, port = models
    jb, tb = _branches(cfg, False, 1, seed=3)
    scores = port.do_inference(tb)[2][..., 4]
    thr = float(scores[:, 2].max()) + 1e-3
    cfg_b = _cfg(THRESHOLD=thr, CANDIDATE_BUCKETS=[2, 3])
    port_b = get_model(cfg_b, device="cpu")
    port_b.load_state_dict(port.state_dict())
    tout = port_b.do_inference(tb)
    assert port_b.pose_net.bucket(tout[2]) == 2
    assert (tout[2][:, 2:, 3] < 0).all() and (tout[2][..., 3] >= 0).any()
    jout = j_get_model(cfg_b).apply(var, jb, method="do_inference")
    _assert_same_inference(jout, tout)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "selfpose3d_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch_inference.py",
        REPO / "scripts" / "profile_torch_train.py"]
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "orbax", "selfpose3d_tpu"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad
