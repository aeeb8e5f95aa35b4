"""The port's conv3 probe against the JAX probe's Pallas conv.

``pallas_conv3`` of ``scripts/microbench_pallas_conv.py`` runs in Pallas
interpret mode (loaded with ``ast``; the script itself runs its benchmark
at import). What the port runs on the CPU, ``conv3``'s plain version, is
held to it on seeded bf16 inputs: within one bf16 ulp of every output
element (the two sum the same float32 products in another order before
the one rounding to bf16) and equal on at least 99 % of them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from selfpose3d_tpu_torch.microbench import conv3 as port
from tests.torch_probe_loader import INTERPRET_PL, load_probe


@pytest.fixture(scope="module")
def probe():
    return load_probe("microbench_pallas_conv.py", ["XCH", "_kernel", "pallas_conv3"],
                      {"functools": functools, "jax": jax, "jnp": jnp, "pl": INTERPRET_PL,
                       "pltpu": pltpu})


def _inputs(seed, shape, co):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    w = rng.random((3, 3, 3, shape[-1], co), dtype=np.float32) * np.float32(0.01)
    # bf16 values, both sides: jnp and torch round float32 to bf16 the same way
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    return xt, wt


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# (1, 16, 8, 8) crosses the Pallas kernel's 8-plane halo chunk
@pytest.mark.parametrize("shape, co", [((1, 16, 8, 8, 16), 32), ((1, 8, 8, 8, 4), 8)])
def test_plain_matches_pallas_probe(probe, shape, co):
    x, w = _inputs(sum(shape) + co, shape, co)
    want = torch.from_numpy(np.asarray(probe["pallas_conv3"](_to_jax(x), _to_jax(w)),
                                       np.float32))
    got = port.conv3(x, w)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape[:4] + (co,)
    got = got.float()
    diff = (got - want).abs()
    ulp = port.bf16_ulp(torch.maximum(got.abs(), want.abs()))
    assert bool((diff <= ulp).all()), float((diff / ulp).max())
    assert float((diff == 0).float().mean()) >= 0.99


def test_plain_matches_float32_conv():
    """The plain version against ``F.conv3d`` in float32 on the same bf16
    values: equal up to the final bf16 rounding."""
    x, w = _inputs(3, (2, 8, 6, 5, 3), 4)
    want = port.conv3_library(x.float(), w.float())
    got = port.conv3(x, w).float()
    ulp = port.bf16_ulp(want)
    assert bool(((got - want).abs() <= ulp / 2 + 1e-6 * want.abs()).all())


def test_conv3_rejects_what_it_does_not_take():
    x, w = _inputs(0, (1, 4, 4, 4, 16), 16)
    with pytest.raises(TypeError, match="bfloat16"):
        port.conv3(x.float(), w)
    with pytest.raises(ValueError, match="expected"):
        port.conv3(x, w[:, :, :, :8])
    before = dict(port.LAUNCHES)
    port.conv3(x, w)  # the CPU runs the plain version: no launch
    assert port.LAUNCHES == before



@pytest.mark.parametrize("ci, co", [(16, 32), (32, 32), (48, 16), (64, 128)])
def test_pack_weights_round_trip(ci, co):
    """The kernel's weight layout loses nothing: unpack(pack(w)) is w."""
    _, w = _inputs(ci + co, (1, 1, 1, 1, ci), co)
    p = port.pack_weights(w)
    assert tuple(p.shape) == (27 * ci // 16, 2, co, 8) and p.is_contiguous()
    assert torch.equal(port.unpack_weights(p), w)


def test_pack_weights_index_formula():
    """Every element where the kernel's B layout expects it:
    p[tap*CI/16 + ci//16, ci//8 % 2, co, ci % 8] = w[dx, dy, dz, ci, co]
    with tap = 9*dx + 3*dy + dz (a numpy loop over all indices)."""
    ci, co = 32, 16
    w = np.random.default_rng(1).random((3, 3, 3, ci, co), dtype=np.float32)
    p = port.pack_weights(torch.from_numpy(w)).numpy()
    want = np.empty_like(p)
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                tap = 9 * dx + 3 * dy + dz
                for c in range(ci):
                    for o in range(co):
                        want[tap * ci // 16 + c // 16, c // 8 % 2, o, c % 8] = w[dx, dy, dz, c, o]
    np.testing.assert_array_equal(p, want)


def test_pack_weights_rejects_ci_not_multiple_of_16():
    with pytest.raises(ValueError, match="multiple of 16"):
        port.pack_weights(torch.zeros((3, 3, 3, 8, 16), dtype=torch.bfloat16))
