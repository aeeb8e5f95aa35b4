"""JPEG decoding and encoding through the port's own codec,
``csrc/image_codec.cpp`` (host C++, built by ``ops/build.py`` with the
host compiler at first use, called through ``ctypes``, which releases
the GIL for the length of a call): OpenCV's ``cv2.imdecode`` and
``cv2.imwrite(".jpg")`` bit for bit, with no OpenCV or Pillow.

``decode_jpeg`` reads baseline and extended sequential Huffman JPEG
(SOF0/SOF1), 8-bit, grey or three components, any sampling, restart
intervals; it applies the EXIF orientation as ``cv2.imdecode`` does,
except in "unchanged" mode. A file that ends before its EOI, or whose
header libjpeg would refuse, gives None, as ``cv2.imdecode`` gives. A
header of more than 2**30 pixels raises ``ValueError``, as OpenCV's size
check makes ``cv2.imdecode`` raise. Progressive, lossless, hierarchical,
arithmetic-coded, 12-bit and 2- or 4-component files raise ``ValueError``
naming the mode (never None, which the datasets would take for a missing
frame). ``encode_jpeg`` writes what
``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])`` writes:
baseline, 4:2:0 (or grey), the Annex K Huffman tables, a JFIF APP0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from selfpose3d_tpu_torch.ops import build

SIGNATURE = b"\xff\xd8\xff"  # what cv2.imdecode takes for JPEG
TRUNCATED, CORRUPT, TOO_LARGE = 1, 2, 4
MAX_PIXELS = 1 << 30  # OpenCV's CV_IO_MAX_IMAGE_PIXELS
UNSUPPORTED = {10: "progressive", 11: "lossless", 12: "arithmetic-coded",
               13: "hierarchical", 14: "12-bit", 15: "2- or 4-component"}
MODES = ("color", "grayscale", "unchanged")


def codec() -> ctypes.CDLL:
    """The codec's library (``csrc/image_codec.cpp``), built at first use."""
    return build.library("image_codec")


def _check(code: int) -> bool:
    """True for a decoded image; False where cv2.imdecode gives None."""
    if code == 0:
        return True
    if code in (TRUNCATED, CORRUPT):
        return False
    if code == TOO_LARGE:
        raise ValueError(f"JPEG of more than {MAX_PIXELS} pixels (OpenCV's "
                         "CV_IO_MAX_IMAGE_PIXELS, where cv2.imdecode raises)")
    if code in UNSUPPORTED:
        raise ValueError(
            f"{UNSUPPORTED[code]} JPEG: the port's codec decodes baseline and extended "
            "sequential Huffman JPEG, 8-bit, with 1 or 3 components")
    raise RuntimeError(f"the JPEG codec returned code {code}")


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation: EXIF values 2-8 flip and transpose."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    flip = {2: (slice(None), slice(None, None, -1)), 3: (slice(None, None, -1),) * 2,
            4: (slice(None, None, -1),), 6: (slice(None), slice(None, None, -1)),
            7: (slice(None, None, -1),) * 2, 8: (slice(None, None, -1),)}.get(orientation)
    if flip is not None:
        img = img[flip]
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, mode: str = "color") -> Optional[np.ndarray]:
    """The JPEG in ``data`` as uint8, or None where ``cv2.imdecode`` gives
    None. ``mode``: "color" (H, W, 3) BGR (``IMREAD_COLOR``), "grayscale"
    (H, W) (``IMREAD_GRAYSCALE``), "unchanged" as stored, grey or BGR, no
    EXIF orientation (``IMREAD_UNCHANGED``)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    data = bytes(data)
    if not data.startswith(SIGNATURE):
        return None
    lib = codec()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if not _check(lib.sp3d_jpeg_header(data, len(data), ctypes.byref(w), ctypes.byref(h),
                                       ctypes.byref(c))):
        return None
    grey = mode == "grayscale" or (mode == "unchanged" and c.value == 1)
    out = np.empty((h.value, w.value) if grey else (h.value, w.value, 3), np.uint8)
    if not _check(lib.sp3d_jpeg_decode(data, len(data), out.ctypes.data, w.value, h.value,
                                       int(not grey))):
        return None
    if mode == "unchanged":
        return out
    return _orient(out, lib.sp3d_jpeg_orientation(data, len(data)))


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """``img`` ((H, W) grey or (H, W, 3) BGR uint8, as ``cv2.imencode``
    takes it) as a baseline JPEG at ``quality`` (1-100)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    if not 1 <= quality <= 100:
        raise ValueError(f"quality {quality}: 1 to 100")
    h, w = img.shape[:2]
    comps = 1 if img.ndim == 2 else 3
    lib = codec()
    cap = h * w * comps + 4096
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        n = lib.sp3d_jpeg_encode(img.ctypes.data, w, h, comps, quality, out.ctypes.data, cap)
        if n > 0:
            return out[:n].tobytes()
        if n == 0:
            raise ValueError(f"encode_jpeg: image of {w}x{h} is outside JPEG's 1 to 65500")
        cap = -n  # the bytes it needs
    raise RuntimeError("the JPEG codec asked for more room twice")
