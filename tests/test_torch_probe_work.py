"""The work counts the probes' bounds are priced from (``work`` in
``selfpose3d_tpu_torch/microbench/sw_variants.py`` and ``primitives.py``),
each held to a count worked by hand from the probe's shapes."""

import pytest

from selfpose3d_tpu_torch.microbench import primitives, sw_variants

# the slice-warp probe: B = 4, J = 15, planes 256 x 128, 640 slices of
# 64 x 128 points, i.e. 5,242,880 points a batch element
SW_HM = (4, 15, 256, 128)
SW_XS = (4, 80, 8, 64, 128)
PTS = 640 * 64 * 128


def test_sw_full_work_by_hand():
    w = sw_variants.work("full", SW_HM, SW_XS)
    # planes 4 * 15 * 32768, xs and ys 2 * 4 * PTS, output 4 * PTS * 15 floats
    assert w["bytes"] == 4 * (1_966_080 + 41_943_040 + 314_572_800) == 1_433_927_680
    assert w["flops"] == 4 * PTS * (8 * 15 + 12)
    assert w["smem_loads"] == 0


def test_sw_j1_work_by_hand():
    w = sw_variants.work("j1", SW_HM, SW_XS)
    # one plane a batch element, xs and ys, one output channel
    assert w["bytes"] == 4 * (131_072 + 41_943_040 + 20_971_520) == 252_182_528
    assert w["flops"] == 4 * PTS * 20


@pytest.mark.parametrize("mode", [m for m in sw_variants.MODES if m != "j1"])
def test_sw_modes_write_every_channel(mode):
    """Every mode but j1 writes all 15 channels, so it needs full's work."""
    assert sw_variants.work(mode, SW_HM, SW_XS) == sw_variants.work("full", SW_HM, SW_XS)


def test_gather_work_by_hand():
    w = primitives.work("gather", 200)
    # 2 shared-memory loads (index, value) an element and repetition
    assert w["smem_loads"] == 2 * 32768 * 200 == 13_107_200
    assert w["flops"] == 4 * 32768 * 200
    assert w["bytes"] == 4 * (32768 + 32768)


@pytest.mark.parametrize("body, loads, tile_bytes", [
    ("transpose", 32768 * 200, 4 * 2 * 32768),
    ("cmp_add", 16384 * 200, 4 * 2 * 16384),
    # 64 x 256 in, 256 x 128 out, half of it written by a repetition
    ("transpose_64x256", 16384 * 200, 4 * (16384 + 32768)),
])
def test_other_bodies_work_by_hand(body, loads, tile_bytes):
    w = primitives.work(body, 200)
    assert w["smem_loads"] == loads
    assert w["bytes"] == tile_bytes
    assert w["flops"] == loads * (2 if body == "cmp_add" else 1)


def test_primitive_work_scales_with_reps():
    for body in primitives.BODIES:
        a, b = primitives.work(body, 200), primitives.work(body, 400)
        assert b["smem_loads"] == 2 * a["smem_loads"] and b["flops"] == 2 * a["flops"]
        assert b["bytes"] == a["bytes"]


def test_primitive_bands_take_whole_rows():
    """Every band divides its body's output rows, and each body's default
    is one of its bands; a band the kernel does not take raises, on the CPU
    too."""
    for body, choices in primitives.BAND_CHOICES.items():
        rows = primitives.BODIES[body][1][0]
        assert all(rows % b == 0 for b in choices)
        assert primitives.BANDS[body] in choices
    x = primitives.make_input("gather", "cpu")
    with pytest.raises(ValueError, match="band"):
        primitives.primitive("gather", x, 3, band=3)
