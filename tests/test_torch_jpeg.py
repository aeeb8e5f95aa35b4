"""The port's JPEG codec and PNG unfilter (``csrc/image_codec.cpp``,
``utils/jpeg.py``, ``utils/image_io.py``) against OpenCV, which the JAX
package reads and writes its images with.

Bars, all exact: every decode equals ``cv2.imdecode`` (IMREAD_COLOR and
IMREAD_GRAYSCALE) bit for bit, on inputs this file encodes with
``cv2.imencode``: qualities 50 to 100, the four chroma samplings, grey,
restart intervals, optimised Huffman tables, odd sizes down to 1x1, EXIF
orientations, corrupt and truncated files (None where OpenCV gives None,
the same pixels where it decodes); ``encode_jpeg`` writes
``cv2.imencode(".jpg")``'s bytes, so their decodes are equal too; the C
PNG unfilter equals the Python row loop it replaced; the committed
fixtures (``tests/torch_fixtures/jpeg/``) hold without OpenCV, as
``chip_smoke.py`` phase codec holds them on the card.
"""

import json
import os
import random
import struct
import threading

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from selfpose3d_tpu_torch.ops import build
from selfpose3d_tpu_torch.utils import image_io, jpeg

FIXTURES = os.path.join(os.path.dirname(__file__), "torch_fixtures", "jpeg")
SAMPLINGS = {"444": 0x111111, "422": 0x211111, "440": 0x121111, "420": 0x411111}


def _image(h, w, seed=0):
    """Half smooth gradient, half noise: both ends of the coefficient range."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w, 1), y * 255 // max(h, 1), (x + y) % 256], -1)
    img = img.astype(np.uint8)
    img[:, w // 2:] = rs.randint(0, 256, (h, w - w // 2, 3))
    return img


def _cv_encode(img, *params):
    return cv2.imencode(".jpg", img, list(params))[1].tobytes()


def _cv_decode(data, flag=cv2.IMREAD_COLOR):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flag)


def _same_as_cv2(data, modes=("color", "grayscale")):
    for mode in modes:
        flag = cv2.IMREAD_COLOR if mode == "color" else cv2.IMREAD_GRAYSCALE
        want, got = _cv_decode(data, flag), jpeg.decode_jpeg(data, mode)
        if want is None:
            assert got is None, mode
        else:
            assert got is not None, mode
            np.testing.assert_array_equal(got, want, err_msg=mode)


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_decode_equals_cv2(quality, sampling):
    img = _image(45, 67, seed=quality)
    _same_as_cv2(_cv_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]))


@pytest.mark.parametrize("hw", [(1, 1), (9, 17), (45, 67), (2, 3), (16, 16), (33, 8)])
def test_odd_sizes_and_grey(hw):
    img = _image(*hw, seed=hw[0])
    for s in SAMPLINGS.values():
        _same_as_cv2(_cv_encode(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, s))
    grey = _cv_encode(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    _same_as_cv2(grey)
    np.testing.assert_array_equal(image_io.decode(grey, color=False),
                                  _cv_decode(grey, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("params", [
    (cv2.IMWRITE_JPEG_RST_INTERVAL, 1), (cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
    (cv2.IMWRITE_JPEG_OPTIMIZE, 1),
    (cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111)],
    ids=["rst1", "rst3", "optimized", "optimized_422"])
def test_restarts_and_optimised_tables(params):
    _same_as_cv2(_cv_encode(_image(40, 70, seed=3), *params))


def _segments(data):
    """The marker segments of a JPEG up to its SOS, the SOS, and the
    entropy-coded data up to EOI."""
    pos, segs = 2, []
    while True:
        m, length = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos:pos + 2 + length]
        if m == 0xDA:
            return segs, seg, data[pos + 2 + length:-2]
        segs.append((m, seg))
        pos += 2 + length


def _three_scans(img):
    """A baseline JPEG of three non-interleaved scans, one a component
    (YCbCr 4:4:4, no JFIF marker), spliced from OpenCV's grey JPEGs of the
    planes: each scan at its own quality, with its own optimised Huffman
    tables, which redefine tables 0 between the scans."""
    planes = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2YCrCb)[..., [0, 2, 1]])
    h, w = img.shape[:2]
    out = (b"\xff\xd8\xff\xc0" + struct.pack(">HBHHB", 17, 8, h, w, 3)
           + bytes(b for k in range(3) for b in (k + 1, 0x11, k)))
    for k, (plane, quality) in enumerate(zip(planes, (90, 60, 75))):
        segs, _, entropy = _segments(_cv_encode(plane, cv2.IMWRITE_JPEG_QUALITY, quality,
                                                cv2.IMWRITE_JPEG_OPTIMIZE, 1))
        for m, seg in segs:
            if m == 0xDB:  # its table 0 becomes table k
                out += seg[:4] + bytes([k]) + seg[5:]
            elif m == 0xC4:
                out += seg
        out += b"\xff\xda" + struct.pack(">HB", 8, 1) + bytes([k + 1, 0, 0, 63, 0]) + entropy
    return out + b"\xff\xd9"


@pytest.mark.parametrize("hw", [(40, 70), (9, 17)])
def test_non_interleaved_scans_with_tables_redefined(hw):
    data = _three_scans(_image(*hw, seed=11))
    _same_as_cv2(data)
    assert _cv_decode(data)[..., 0].std() > 0
    _same_as_cv2(data[:-40])  # the last scan cut short: None, as OpenCV


@settings(max_examples=25, deadline=None, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(1, 100),
       sampling=st.sampled_from(sorted(SAMPLINGS.values())), grey=st.booleans(),
       rst=st.integers(0, 4), optimize=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_random_settings_equal_cv2(h, w, quality, sampling, grey, rst, optimize, seed):
    img = _image(h, w, seed)
    if grey:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    _same_as_cv2(_cv_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                            cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)))


def _sof(data):
    return next(i for i in range(2, len(data) - 1)
                if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1, 0xC2))


@pytest.mark.parametrize("mode,name", [
    ("progressive", "progressive"), ("lossless", "lossless"),
    ("arithmetic", "arithmetic-coded"), ("hierarchical", "hierarchical"),
    ("12-bit", "12-bit"), ("4 components", "4-component")])
def test_unsupported_modes_raise(mode, name):
    img = _image(16, 24)
    if mode == "progressive":
        data = _cv_encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
        assert _cv_decode(data) is not None  # OpenCV reads it; the port says so
    else:
        data = bytearray(_cv_encode(img))
        i = _sof(data)
        if mode == "12-bit":
            data[i + 4] = 12
        elif mode == "4 components":  # a whole SOF0 of four components
            body = bytes([8, 0, 16, 0, 24, 4]) + bytes(b for c in range(4) for b in (c + 1, 0x11, 0))
            data = data[:i] + b"\xff\xc0" + struct.pack(">H", 2 + len(body)) + body + data[i + 19:]
        else:
            data[i + 1] = {"lossless": 0xC3, "arithmetic": 0xC9, "hierarchical": 0xC5}[mode]
    with pytest.raises(ValueError, match=name):
        jpeg.decode_jpeg(bytes(data))
    with pytest.raises(ValueError, match=name):
        image_io.decode(bytes(data))


def test_truncated_and_corrupt_files_as_cv2():
    img = _image(37, 53, seed=7)
    data = _cv_encode(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    rst = _cv_encode(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    sos = data.index(b"\xff\xda") + 14
    # cut anywhere: OpenCV's in-memory source suspends and gives None
    for cut in (1, 3, 20, sos - 5, sos + 10, len(data) // 2, len(data) - 2, len(data) - 1):
        assert _cv_decode(data[:cut]) is None and jpeg.decode_jpeg(data[:cut]) is None, cut
    # a scan cut short but closed by EOI: libjpeg fills it, mid-grey
    short = data[: (sos + len(data)) // 2] + b"\xff\xd9"
    assert _cv_decode(short) is not None
    _same_as_cv2(short)
    rng = random.Random(0)
    for src in (data, rst):
        start = src.index(b"\xff\xda") + 14
        for _ in range(40):  # corrupt entropy-coded bytes: the same garbage
            bad = bytearray(src)
            bad[rng.randrange(start, len(src) - 2)] = rng.randrange(256)
            _same_as_cv2(bytes(bad), ("color",))
        for _ in range(40):  # corrupt headers: None or the same pixels
            bad = bytearray(src)
            bad[rng.randrange(3, start)] = rng.randrange(256)
            _same_as_cv2(bytes(bad), ("color",))
    # a corrupt SOF's size: above libjpeg's 65500 None, above OpenCV's
    # 2**30 pixels cv2.imdecode raises, and so does the port, before it
    # allocates anything
    sof = data.index(b"\xff\xc0") + 5
    for hw, cv_raises in (((65535, 16), False), ((65500, 65500), True), ((40000, 30000), True)):
        bad = data[:sof] + struct.pack(">HH", *hw) + data[sof + 4:]
        if cv_raises:
            with pytest.raises(cv2.error, match="CV_IO_MAX_IMAGE_PIXELS"):
                _cv_decode(bad)
            for mode in jpeg.MODES:
                with pytest.raises(ValueError, match="pixels"):
                    jpeg.decode_jpeg(bad, mode)
        else:
            assert _cv_decode(bad) is None and jpeg.decode_jpeg(bad) is None, hw
    assert jpeg.decode_jpeg(b"\xff\xd8\xff\xe0") is None
    assert image_io.decode(b"\xff\xd8\x00" + data[3:]) is None  # no JPEG signature


def _exif(orientation, little):
    e = "<" if little else ">"
    tiff = ((b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 2)
            + struct.pack(e + "HHI", 0x010F, 2, 4) + b"cam\0"
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
    return b"\xff\xe1" + struct.pack(">H", len(tiff) + 8) + b"Exif\0\0" + tiff


@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation_as_cv2(orientation):
    base = _cv_encode(_image(21, 34, seed=orientation))
    for little in (True, False):
        data = base[:2] + _exif(orientation, little) + base[2:]
        _same_as_cv2(data)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, "unchanged"),
                                      _cv_decode(data, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("quality", [95, 50, 100, 1])
def test_encoder_writes_cv2_bytes(quality):
    """cv2.imdecode of encode_jpeg's output equals that of cv2.imencode's;
    the bytes, from SOI to EOI, are equal too."""
    for name, img in (("colour", _image(45, 67, seed=quality)),
                      ("grey", cv2.cvtColor(_image(23, 9), cv2.COLOR_BGR2GRAY)),
                      ("1x1", _image(1, 1)), ("17x9", _image(9, 17))):
        ours = jpeg.encode_jpeg(img, quality)
        ref = _cv_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality)
        np.testing.assert_array_equal(_cv_decode(ours), _cv_decode(ref), err_msg=name)
        assert ours == ref, name
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((4, 4, 3), np.uint8), quality=0)


def test_imwrite_picks_the_format_by_extension(tmp_path):
    img = _image(30, 41, seed=5)
    for ext in (".jpg", ".jpeg", ".png"):
        path = str(tmp_path / f"x{ext}")
        image_io.imwrite(path, img)
        ref = str(tmp_path / f"ref{ext}")
        cv2.imwrite(ref, img)
        if ext == ".png":
            np.testing.assert_array_equal(cv2.imread(path), img)
        else:
            assert open(path, "rb").read() == open(ref, "rb").read()
        np.testing.assert_array_equal(image_io.decode(open(path, "rb").read()), cv2.imread(ref))
    with pytest.raises(ValueError, match="bmp"):
        image_io.imwrite(str(tmp_path / "x.bmp"), img)


def _unfilter_python(rows, bpp):
    """The Python row loop ``utils/image_io.py`` ran before the C unfilter."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = bytes(stride)
    for y in range(h):
        kind, raw = rows[y, 0], bytearray(rows[y, 1:].tobytes())
        for i in range(stride):
            a = raw[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) >> 1
            elif kind == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = 0
            raw[i] = (raw[i] + pred) & 0xFF
        out[y] = np.frombuffer(bytes(raw), np.uint8)
        prev = bytes(raw)
    return out


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_png_unfilter_equals_the_python_loop(bpp):
    rs = np.random.RandomState(bpp)
    h, w = 23, 17
    rows = rs.randint(0, 256, (h, 1 + w * bpp)).astype(np.uint8)
    rows[:, 0] = np.arange(h) % 5  # every filter type, Average and Paeth among them
    out = np.empty((h, w * bpp), np.uint8)
    assert image_io.png_unfilter(rows.tobytes(), h, w * bpp, bpp, out) == 0
    np.testing.assert_array_equal(out, _unfilter_python(rows, bpp))
    rows[5, 0] = 7  # not a PNG filter type
    assert image_io.png_unfilter(rows.tobytes(), h, w * bpp, bpp, out) != 0


def test_committed_fixtures_without_opencv():
    """The check phase codec of chip_smoke.py makes on the card, which has
    no OpenCV: each fixture JPEG decodes to OpenCV's decode beside it, and
    encode_jpeg of the source image writes OpenCV's bytes."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)

    def read(name):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            return f.read()

    assert len(manifest["decode"]) == 8
    for case in manifest["decode"]:
        want = image_io.decode(read(case["want"]), color=case["mode"] == "color")
        np.testing.assert_array_equal(jpeg.decode_jpeg(read(case["jpeg"]), case["mode"]), want,
                                      err_msg=case["jpeg"])
    for case in manifest["encode"]:
        src = image_io.decode(read(case["source"]))
        assert jpeg.encode_jpeg(src, case["quality"]) == read(case["want"])


def test_first_use_from_six_threads_builds_once(monkeypatch, tmp_path):
    """The loader's worker threads reach the codec first at the same time:
    one compiler runs, and every thread decodes."""
    data = _cv_encode(_image(24, 40, seed=3))
    want = _cv_decode(data)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    # unoptimised: a fresh library path, and a quick compile
    monkeypatch.setattr(build, "CXX_FLAGS", ("-O0",) + build.CXX_FLAGS[1:])
    popen, runs = build.subprocess.Popen, []
    monkeypatch.setattr(build.subprocess, "Popen", lambda *a, **k: runs.append(a) or popen(*a, **k))
    barrier = threading.Barrier(6)
    got = [None] * 6

    def worker(i):
        barrier.wait()
        got[i] = jpeg.decode_jpeg(data)

    build.library.cache_clear()
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        build.library.cache_clear()
    assert len(runs) == 1
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".so"] == [
        build.library_path("image_codec").name]
    for g in got:
        np.testing.assert_array_equal(g, want)


def test_a_failed_build_raises_naming_the_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")  # a compiler that fails at once
    with pytest.raises(RuntimeError, match="image_codec .*false exit 1"):
        build.build(["image_codec"])
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        build.build(["image_codec"])
