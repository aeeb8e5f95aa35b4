"""The port's slice-warp ablation probe against the JAX probe's kernel.

``make_kernel(mode)`` of ``scripts/microbench_sw_variants.py`` runs in
Pallas interpret mode (loaded with ``ast``, the script's batch, channel and
slice counts cut to B=1, J=2, S=SB=8; its row geometry kept: 64 x 128
points a slice, 256 x 128 heatmap planes, a 240 x 128 image), on a grid and
block specs as the script's ``run`` builds them. What the port runs on the
CPU, ``sw_variant``'s plain version, is held to it on seeded inputs, on the
entries the TPU kernel defines: all of them, except j1 (channel 0 only)
and notranspose (points whose clipped columns x0c, x1c are < 128).
Tolerance 1e-5 absolute (heatmap values in [0, 1); the float32 arithmetic
is the same, term for term).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from selfpose3d_tpu.ops import slicewarp as jsw
from selfpose3d_tpu_torch.microbench import sw_variants as port
from tests.torch_probe_loader import INTERPRET_PL, load_probe

SMALL = {"B": 1, "J": 2, "K": 1, "Z": 8, "S": 8}
CONSTS = ["B", "H", "W", "J", "K", "X", "Y", "Z", "S", "SB", "Wp", "Xp", "Yp", "Hp"]


@pytest.fixture(scope="module")
def probe():
    ns = load_probe("microbench_sw_variants.py", CONSTS + ["make_kernel"],
                    {"jax": jax, "jnp": jnp, "np": np, "pl": INTERPRET_PL, "pltpu": pltpu,
                     "LANE": jsw.LANE, "_gather_lanes": jsw._gather_lanes,
                     "_round_up": jsw._round_up, "_search_steps": jsw._search_steps, **SMALL})
    B, J, S, SB, Wp, Hp, Xp, Yp = (ns[k] for k in ("B", "J", "S", "SB", "Wp", "Hp", "Xp", "Yp"))

    def run(mode, hm, xs, ys):
        # the pallas_call of the script's run(), at the cut sizes
        f = INTERPRET_PL.pallas_call(
            ns["make_kernel"](mode),
            out_shape=jax.ShapeDtypeStruct((B, S // SB, SB, J, Xp, Yp), jnp.float32),
            grid=(B, S // SB),
            in_specs=[
                pl.BlockSpec((1, J, Wp, Hp), lambda b, s: (b, 0, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, 1, SB, Xp, Yp), lambda b, s: (b, s, 0, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, 1, SB, Xp, Yp), lambda b, s: (b, s, 0, 0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, 1, SB, J, Xp, Yp), lambda b, s: (b, s, 0, 0, 0, 0),
                                   memory_space=pltpu.VMEM),
        )
        return np.asarray(f(hm, xs, ys))

    return ns, run


@pytest.fixture(scope="module")
def inputs(probe):
    """The script's draws (hm uniform, xs sorted uniform in [0, 200), ys
    uniform in [0, 100)), seeded; slice row 5 of slice 3 reversed, so its
    sgn is -1, and slice row 9 of slice 0 unsorted."""
    ns, _ = probe
    B, J, S, SB, Wp, Hp, Xp, Yp = (ns[k] for k in ("B", "J", "S", "SB", "Wp", "Hp", "Xp", "Yp"))
    rng = np.random.default_rng(11)
    hm = rng.random((B, J, Wp, Hp), dtype=np.float32)
    xs = np.sort(rng.random((B, S // SB, SB, Xp, Yp), dtype=np.float32) * np.float32(200), -1)
    ys = rng.random((B, S // SB, SB, Xp, Yp), dtype=np.float32) * np.float32(100)
    xs[:, 0, 3, 5] = xs[:, 0, 3, 5, ::-1]
    xs[:, 0, 0, 9] = rng.permutation(xs[0, 0, 0, 9])
    return hm, xs, ys


def _defined(mode, xs, ns):
    """Mask (B, S/SB, SB, J, Xp, Yp) of the entries the TPU kernel defines."""
    B, J, S, SB, Xp, Yp, W = (ns[k] for k in ("B", "J", "S", "SB", "Xp", "Yp", "W"))
    mask = np.ones((B, S // SB, SB, J, Xp, Yp), bool)
    if mode == "j1":
        mask[:, :, :, 1:] = False
    if mode == "notranspose":
        x0 = np.floor(xs).astype(np.int64)
        ok = (np.clip(x0, 0, W - 1) < 128) & (np.clip(x0 + 1, 0, W - 1) < 128)
        mask &= ok[:, :, :, None]
    return mask


@pytest.mark.parametrize("mode", port.MODES)
def test_plain_matches_pallas_probe(probe, inputs, mode):
    ns, run = probe
    hm, xs, ys = inputs
    want = run(mode, *(jnp.asarray(a) for a in inputs))
    assert (ns["W"], ns["H"], ns["Y"]) == (port.W, port.H, port.Y)
    got = port.sw_variant(mode, *(torch.from_numpy(a) for a in inputs)).numpy()
    assert got.shape == want.shape
    mask = _defined(mode, xs, ns)
    assert mask.mean() > 0.3  # notranspose: most points have x0c < 128
    err = np.abs(got - want)[mask]
    assert np.isfinite(got).all()
    assert err.max() <= 1e-5, (mode, float(err.max()), int((err > 1e-5).sum()))


def test_rows_match_a_sorted_search():
    """On a monotone row the step-by-step search finds the segment that
    ``searchsorted`` finds, for both directions of the row."""
    rng = np.random.default_rng(2)
    y_len, h = port.Y, port.H
    xs = np.sort(rng.random((2, y_len), dtype=np.float32) * 200, -1)
    xs[1] = xs[1, ::-1].copy()
    ys = rng.random((2, y_len), dtype=np.float32) * 100
    r = port.row_r(torch.from_numpy(xs), torch.from_numpy(ys), 256).numpy()
    for row, sgn in ((0, 1.0), (1, -1.0)):
        xm = (xs[row] * sgn).astype(np.float32)
        cols = np.arange(256, dtype=np.float32) * np.float32(sgn)
        seg = np.clip(np.searchsorted(xm[: y_len - 1], cols, side="right") - 1, 0, y_len - 2)
        t = (cols - xm[seg]) / (xm[seg + 1] - xm[seg] + np.float32(1e-6))
        yh = np.clip(ys[row, seg] + t * (ys[row, seg + 1] - ys[row, seg]), -4.0, h + 3.0)
        np.testing.assert_array_equal(r[row], np.floor(yh).astype(np.int64))


def test_sw_variant_rejects_what_it_does_not_take():
    hm = torch.rand(1, 2, port.Wp, port.Hp)
    xs = torch.rand(1, 1, 2, 4, port.Yp) * 200
    with pytest.raises(ValueError, match="mode"):
        port.sw_variant("fast", hm, xs, xs)
    with pytest.raises(TypeError, match="float32"):
        port.sw_variant("full", hm.double(), xs, xs)
    with pytest.raises(ValueError, match="Yp"):
        port.sw_variant("full", hm, xs[..., :32], xs[..., :32])
    with pytest.raises(ValueError, match="Hp"):
        port.sw_variant("full", hm[..., :64], xs, xs)
    before = dict(port.LAUNCHES)
    out = port.sw_variant("full", hm, xs, xs)
    assert out.shape == (1, 1, 2, 2, 4, port.Yp) and port.LAUNCHES == before

