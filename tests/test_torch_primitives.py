"""The port's primitive-rate probe against the JAX probe's kernel, and the
channel-major soft-argmax against the JAX package's.

``bench_kernel`` of ``scripts/microbench.py`` (loaded with ``ast``: the
script runs a V2V at 40 x 64^3 at import) builds its Pallas program on
ones and times it; here its ``timeit`` hands over the jitted program, which
runs in interpret mode on seeded inputs. What the port runs on the CPU,
``primitive``'s plain version, is held to it exactly, on the entries the
TPU kernel defines (transpose_64x256: columns :64). cmp_add accumulates
into an output the TPU kernel never initialises, so it is held to the
exact count in numpy instead.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from selfpose3d_tpu.ops.softargmax import soft_argmax as jax_soft_argmax
from selfpose3d_tpu_torch.microbench import primitives as port
from selfpose3d_tpu_torch.ops.softargmax import soft_argmax
from tests.torch_probe_loader import INTERPRET_PL, load_probe

BODY_FN = {"gather": "g_body", "transpose": "t_body", "cmp_add": "c_body",
           "transpose_64x256": "t2_body"}


@pytest.fixture(scope="module")
def probe():
    programs = []

    def timeit(fn, *args, **kwargs):
        programs.append(fn)
        return 1.0

    ns = load_probe("microbench.py", ["LANE", "REPS", "bench_kernel", *BODY_FN.values()],
                    {"jax": jax, "jnp": jnp, "pl": INTERPRET_PL, "pltpu": pltpu,
                     "timeit": timeit, "results": {}})

    def program(body, reps):
        """The probe's Pallas program for ``body`` at ``reps`` repetitions."""
        shapes = [port.BODIES[body][0], port.BODIES[body][1]]
        ns["bench_kernel"](ns[BODY_FN[body]], shapes, body, reps=reps)
        return programs.pop()

    return ns, program


def test_probe_constants_match(probe):
    ns, _ = probe
    assert (ns["LANE"], ns["REPS"]) == (port.LANE, port.REPS)


@pytest.mark.parametrize("reps", [5, 200])
@pytest.mark.parametrize("body", ["gather", "transpose", "transpose_64x256"])
def test_plain_matches_pallas_probe(probe, body, reps):
    _, program = probe
    x = port.make_input(body, "cpu", seed=reps)
    want = np.asarray(program(body, reps)(jnp.asarray(x.numpy())))
    got = port.primitive(body, x, reps).numpy()
    assert got.shape == want.shape == port.BODIES[body][1]
    cols = slice(0, 64) if body == "transpose_64x256" else slice(None)
    np.testing.assert_array_equal(got[:, cols], want[:, cols])
    if body == "transpose_64x256":
        assert not got[:, 64:].any()
    if body == "gather" and reps == 5:
        # the seeded table makes the gather move data (at 200 repetitions the
        # last one's index int(tbl) + 199 clips to column 127 everywhere)
        assert len(np.unique(got)) > 1000


@pytest.mark.parametrize("reps", [5, 200])
def test_cmp_add_counts_exactly(probe, reps):
    """Starting from zero, out = #{i < reps : a <= i}; the TPU program's
    own output starts from uninitialised memory (NaN in interpret mode)."""
    _, program = probe
    x = port.make_input("cmp_add", "cpu", seed=reps)
    a = x.numpy()
    want = (a[None] <= np.arange(reps, dtype=np.float32)[:, None, None]).sum(0)
    np.testing.assert_array_equal(port.primitive("cmp_add", x, reps).numpy(), want)
    assert np.isnan(np.asarray(program("cmp_add", reps)(jnp.asarray(a)))).all()


def test_primitive_rejects_what_it_does_not_take():
    x = port.make_input("gather", "cpu")
    with pytest.raises(ValueError, match="body"):
        port.primitive("scatter", x, 5)
    with pytest.raises(ValueError, match="input shape"):
        port.primitive("cmp_add", x, 5)
    with pytest.raises(TypeError, match="float32"):
        port.primitive("gather", x.double(), 5)
    with pytest.raises(ValueError, match="reps"):
        port.primitive("gather", x, 0)
    before = dict(port.LAUNCHES)
    port.primitive("gather", x, 2)
    assert port.LAUNCHES == before


@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_soft_argmax_matches_jax(lead):
    rng = np.random.default_rng(len(lead))
    j, n = 15, 4 * 5 * 6
    x = rng.standard_normal((*lead, j, n)).astype(np.float32) * np.float32(0.05)
    grids = (rng.random((*lead, n, 3)) * 4000 - 2000).astype(np.float32)
    want = np.asarray(jax_soft_argmax(jnp.asarray(x), jnp.asarray(grids), beta=100.0))
    got = soft_argmax(torch.from_numpy(x), torch.from_numpy(grids), beta=100.0).numpy()
    assert got.shape == (*lead, j, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_soft_argmax_agrees_with_separable_form():
    """On an axis-separable grid the channel-major form equals the port's
    NDHWC form (the inference path's)."""
    from selfpose3d_tpu_torch.ops.softargmax import soft_argmax_ndhwc

    g = torch.Generator().manual_seed(0)
    b, X, Y, Z, j = 2, 4, 5, 3, 15
    vol = torch.randn(b, X, Y, Z, j, generator=g) * 0.05
    axes = [torch.randn(b, n, generator=g) * 1000 for n in (X, Y, Z)]
    gx, gy, gz = (a[:, :, None, None] for a in axes)
    grid = torch.stack(torch.broadcast_tensors(gx, gy.transpose(1, 2), gz.transpose(1, 3)), -1)
    got = soft_argmax(vol.reshape(b, -1, j).transpose(1, 2), grid.reshape(b, -1, 3))
    torch.testing.assert_close(got, soft_argmax_ndhwc(vol, axes), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("probe_module", ["conv3", "sw_variants", "primitives"])
def test_probe_needs_a_card(probe_module):
    """Each probe's entry point defaults to the card and raises without one;
    it has no CPU mode."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    main = importlib.import_module(f"selfpose3d_tpu_torch.microbench.{probe_module}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main()
    with pytest.raises(ValueError, match="CUDA device"):
        main(device="cpu")
