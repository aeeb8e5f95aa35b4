"""The port's image reader, PNG writer, affine warp and RandAugment ops
(``utils/image_io``, ``utils/zipreader``, ``data/randaugment``) against
OpenCV and Pillow, which the JAX package calls for them, and against the
JAX package's RandAugment module.

Bars: PNG and PPM decoding equals ``cv2.imread`` exactly; ``warp_affine``
is within 1 uint8 level of ``cv2.warpAffine(INTER_LINEAR)`` everywhere
with a mean under 0.01 level, ``resize`` within 1 level of
``cv2.resize``; posterize, equalize and autocontrast equal Pillow's, the
four enhance ops are within 1 level of Pillow's; the policy and Cutout
draws leave the random stream where the JAX module leaves it, and the
augmented images are equal.
"""

import io
import struct
import sys
import zipfile
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image, ImageEnhance, ImageOps

import selfpose3d_tpu.data.randaugment as j_ra
from selfpose3d_tpu_torch.data import randaugment as ra
from selfpose3d_tpu_torch.geometry.transforms import get_affine_transform, get_scale
from selfpose3d_tpu_torch.utils import image_io
from selfpose3d_tpu_torch.utils.zipreader import imread_any


def _images():
    rs = np.random.RandomState(0)
    noise = rs.randint(0, 256, (37, 53, 3), np.uint8)
    ramp = (np.add.outer(np.arange(40), 2 * np.arange(50)) % 256).astype(np.uint8)
    return {
        "noise": noise,
        "smooth": cv2.GaussianBlur(rs.randint(0, 256, (40, 56, 3), np.uint8), (9, 9), 3),
        "ramp": np.repeat(ramp[..., None], 3, axis=2),
        "grey": rs.randint(0, 256, (30, 21), np.uint8),
        "rgba": rs.randint(0, 256, (17, 23, 4), np.uint8),
        "grey_alpha": rs.randint(0, 256, (19, 13, 2), np.uint8),
    }


def _pil_png(img):
    mode = "L" if img.ndim == 2 else {2: "LA", 3: "RGB", 4: "RGBA"}[img.shape[2]]
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="PNG")
    return buf.getvalue()


def _row_filters(data):
    """The filter byte of every row of an 8-bit PNG."""
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        hdr = struct.unpack(">IIBBBBB", body) if kind == b"IHDR" else hdr
        idat += [body] if kind == b"IDAT" else []
        pos += 12 + length
    raw = zlib.decompress(b"".join(idat))
    w, h, _, ctype = hdr[:4]
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] + 1
    return {raw[y * stride] for y in range(h)}


def _png_with_filter(rgb, kind):
    """An RGB PNG whose rows all use filter ``kind`` (the PNG spec's
    filters, written out plainly)."""
    h, w, _ = rgb.shape
    x = rgb.reshape(h, -1).astype(np.int64)
    rows = []
    for y in range(h):
        up = x[y - 1] if y else np.zeros_like(x[y])
        left = np.concatenate([np.zeros(3, np.int64), x[y, :-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        rows.append(bytes([kind]) + ((x[y] - pred) % 256).astype(np.uint8).tobytes())

    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b))

    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def _cv2_read(data, flags=cv2.IMREAD_COLOR):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flags)


@pytest.mark.parametrize("name", list(_images()))
def test_png_written_by_pillow_equals_cv2(name):
    data = _pil_png(_images()[name])
    np.testing.assert_array_equal(image_io.decode(data), _cv2_read(data))
    if name == "grey":
        np.testing.assert_array_equal(image_io.decode(data, color=False),
                                      _cv2_read(data, cv2.IMREAD_GRAYSCALE))


def test_pillow_writes_several_row_filters():
    seen = set().union(*(_row_filters(_pil_png(im)) for im in _images().values()))
    assert {0, 1, 2, 4} <= seen, seen


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_row_filter_equals_cv2(kind):
    rgb = np.random.RandomState(kind).randint(0, 256, (23, 31, 3), np.uint8)
    data = _png_with_filter(rgb, kind)
    assert _row_filters(data) == {kind}
    got = image_io.decode(data)
    np.testing.assert_array_equal(got, _cv2_read(data))
    np.testing.assert_array_equal(got, rgb[..., ::-1])


def test_png_round_trip(tmp_path):
    for name, img in _images().items():
        if img.ndim == 3 and img.shape[2] != 3:
            continue
        path = str(tmp_path / f"{name}.png")
        image_io.imwrite_png(path, img)  # BGR in, as cv2.imwrite
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(want, img)
        np.testing.assert_array_equal(imread_any(path, color=img.ndim == 3), img)
    with pytest.raises(ValueError):
        image_io.encode_png(np.zeros((4, 4, 3), np.float32))


def test_zip_uri_ppm_and_unreadable_inputs(tmp_path):
    img = _images()["noise"]
    png = cv2.imencode(".png", img)[1]
    ppm = b"P6\n# written by hand\n53 37\n255\n" + img[..., ::-1].tobytes()
    pgm = b"P5 53 37 255\n" + img[..., 0].tobytes()
    arc = tmp_path / "frames.zip"
    with zipfile.ZipFile(arc, "w") as zf:
        zf.writestr("a/x.png", png.tobytes())
        zf.writestr("a/y.ppm", ppm)
    np.testing.assert_array_equal(imread_any(f"{arc}@a/x.png"), img)
    np.testing.assert_array_equal(imread_any(f"{arc}@a/y.ppm"), img)
    (tmp_path / "y.pgm").write_bytes(pgm)
    np.testing.assert_array_equal(imread_any(str(tmp_path / "y.pgm")),
                                  cv2.imread(str(tmp_path / "y.pgm")))
    # missing file, missing member, not a zip, not an image, a corrupt PNG
    (tmp_path / "bad.zip").write_bytes(b"not a zip")
    (tmp_path / "text.png").write_bytes(b"hello")
    corrupt = bytearray(png.tobytes())
    corrupt[40] ^= 0xFF
    (tmp_path / "corrupt.png").write_bytes(bytes(corrupt))
    for path in (str(tmp_path / "missing.png"), f"{arc}@a/missing.png",
                 f"{tmp_path / 'bad.zip'}@x.png", str(tmp_path / "text.png"),
                 str(tmp_path / "corrupt.png")):
        assert imread_any(path) is None, path
        if "@" not in path:
            assert cv2.imread(path) is None, path


def test_jpeg_through_opencv_else_pillow_else_error(tmp_path, monkeypatch):
    img = cv2.GaussianBlur(_images()["noise"], (5, 5), 2)
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(imread_any(path), cv2.imread(path))
    monkeypatch.setitem(sys.modules, "cv2", None)
    pil = imread_any(path)  # Pillow's libjpeg may round differently
    assert pil.shape == img.shape and np.abs(pil.astype(int) - cv2.imread(path)).max() <= 8
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="JPEG"):
        imread_any(path)


def _panoptic(rot, scale, shift=(0.0, 0.0)):
    c = np.array([960.0, 540.0])
    s = get_scale((1920, 1080), (960, 512)) * scale
    return get_affine_transform(c, s, rot, (960, 512), shift=shift)


@pytest.mark.parametrize("case", ["panoptic", "rotated", "leaves_image"])
def test_warp_affine_within_one_level_of_cv2(case):
    img = np.random.RandomState(1).randint(0, 256, (1080, 1920, 3), np.uint8)
    M = {"panoptic": _panoptic(0, 1.0), "rotated": _panoptic(17, 1.35),
         "leaves_image": _panoptic(-30, 0.6, shift=(0.3, -0.2))}[case]
    got = image_io.warp_affine(img, M, (960, 512)).astype(int)
    want = cv2.warpAffine(img, M, (960, 512), flags=cv2.INTER_LINEAR)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and diff.mean() < 0.01, (diff.max(), diff.mean())
    if case == "leaves_image":
        assert (want == 0).all(axis=-1).mean() > 0.02  # the border is in the window
    grey = image_io.warp_affine(img[..., 0], M, (960, 512)).astype(int)
    assert np.abs(grey - want[..., 0]).max() <= 1


def test_resize_within_one_level_of_cv2():
    img = np.random.RandomState(2).randint(0, 256, (90, 160, 3), np.uint8)
    for size in ((640, 360), (40, 30), (161, 89)):
        assert np.abs(image_io.resize(img, size).astype(int) - cv2.resize(img, size)).max() <= 1


def _aug_inputs():
    rs = np.random.RandomState(3)
    return [rs.randint(0, 256, (37, 53, 3), np.uint8),
            cv2.GaussianBlur(rs.randint(0, 256, (48, 64, 3), np.uint8), (9, 9), 3),
            rs.randint(40, 180, (30, 30, 3)).astype(np.uint8),
            np.full((10, 12, 3), 77, np.uint8)]


@pytest.mark.parametrize("op", ["posterize", "equalize", "autocontrast"])
def test_lookup_ops_equal_pillow(op):
    for img in _aug_inputs():
        pil = Image.fromarray(img)
        if op == "posterize":
            for bits in range(4, 9):
                np.testing.assert_array_equal(ra.posterize(img, bits),
                                              np.asarray(ImageOps.posterize(pil, bits)))
        else:
            np.testing.assert_array_equal(getattr(ra, op)(img),
                                          np.asarray(getattr(ImageOps, op)(pil)))


@pytest.mark.parametrize("op", ["sharpness", "contrast", "color", "brightness"])
def test_enhance_ops_within_one_level_of_pillow(op):
    enhancer = getattr(ImageEnhance, op.capitalize())
    for img in _aug_inputs():
        for f in (0.1, 0.5, 1.0, 1.3, 1.9):
            want = np.asarray(enhancer(Image.fromarray(img)).enhance(f)).astype(int)
            assert np.abs(getattr(ra, op)(img, f).astype(int) - want).max() <= 1, (op, f)


def test_policy_and_cutout_draws_match_jax():
    imgs = _aug_inputs()[:3]
    applied = set()
    for seed in range(200):
        img = imgs[seed % 3]
        rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
        want = j_ra.RandAugmentCutout()(img, rj)
        got = ra.RandAugmentCutout()(img, rt)
        sj, st = rj.get_state(), rt.get_state()
        assert sj[2] == st[2] and np.array_equal(sj[1], st[1]), seed
        np.testing.assert_array_equal(got, want)
        applied.add(np.random.RandomState(seed).randint(7))  # the first op drawn
    assert applied == set(range(7))
