"""Image decoding and encoding and the bilinear affine warp, in numpy, the
standard library and the port's own codec (``csrc/image_codec.cpp``,
built with the host C++ compiler at first use): what OpenCV does for the
JAX package's data path (``cv2.imread``/``imdecode``, ``cv2.imwrite``,
``cv2.warpAffine``, ``cv2.cvtColor``), with no OpenCV or Pillow.

``decode`` picks the decoder by the first bytes, as ``cv2.imread`` does,
and returns the image in BGR order, as OpenCV does:

  * JPEG through ``utils/jpeg.py``: equal to ``cv2.imdecode`` bit for bit
    (baseline and extended sequential Huffman, 8-bit, grey or three
    components, any sampling, restart intervals, the EXIF orientation);
    a mode it does not decode (progressive, lossless, arithmetic-coded,
    12-bit, 4 components) raises ``ValueError``;
  * PNG, 8 bits a sample, grey, grey + alpha, RGB or RGBA, not interlaced:
    ``zlib`` inflates, the codec's ``sp3d_png_unfilter`` undoes the five row
    filters;
  * binary PPM (P6) and PGM (P5) with a maximum value of 255.

Anything else, a truncated file or a failed PNG checksum gives None, as
``cv2.imread`` gives; a PNG of a kind this module does not decode raises.
``imwrite`` writes by extension, as ``cv2.imwrite`` does: JPEG at quality
95 (``cv2.imwrite``'s bytes) or PNG (8-bit grey or RGB rows with the Up
filter); ``warp_affine`` and ``resize`` are OpenCV's bilinear
``warpAffine`` and ``resize`` within one level of 255.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from selfpose3d_tpu_torch.utils import jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = jpeg.SIGNATURE
# PNG colour type -> samples a pixel (grey, RGB, grey + alpha, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def decode(data: bytes, color: bool = True) -> Optional[np.ndarray]:
    """The image in ``data`` as uint8, or None if it is not one this
    module reads. ``color``: (H, W, 3) BGR, grey replicated and alpha
    dropped (``cv2.IMREAD_COLOR``); else as stored, alpha dropped: (H, W)
    grey or (H, W, 3) BGR."""
    if data.startswith(JPEG_SIGNATURE):
        return jpeg.decode_jpeg(data, "color" if color else "unchanged")
    if data.startswith(PNG_SIGNATURE):
        img = _decode_png(data)
    elif data[:2] in (b"P5", b"P6"):
        img = _decode_pnm(data)
    else:
        return None
    if img is None:
        return None
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2) if color else img
    return np.ascontiguousarray(img[..., 2::-1])  # RGB(A) -> BGR


def _decode_png(data: bytes) -> Optional[np.ndarray]:
    pos, header, idat = len(PNG_SIGNATURE), None, []
    try:
        while pos + 8 <= len(data):
            length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
            body = data[pos + 8 : pos + 8 + length]
            crc = data[pos + 8 + length : pos + 12 + length]
            if len(body) != length or len(crc) != 4:
                return None
            if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
                return None
            if ctype == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif ctype == b"IDAT":
                idat.append(body)
            elif ctype == b"IEND":
                break
            pos += 12 + length
        if header is None or not idat:
            return None
        raw = zlib.decompress(b"".join(idat))
    except (struct.error, zlib.error):
        return None
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"PNG with bit depth {depth}, colour type {ctype}, interlace {interlace}: "
            "only 8-bit non-interlaced grey, grey+alpha, RGB and RGBA are decoded")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    if len(raw) < h * (stride + 1):
        return None
    out = np.empty((h, stride), np.uint8)
    if png_unfilter(raw, h, stride, bpp, out):
        return None  # a filter type the PNG spec does not define
    img = out.reshape(h, w, bpp)
    if bpp in (1, 2):
        return img[..., 0]
    return img[..., :3]


def png_unfilter(raw: bytes, h: int, stride: int, bpp: int, out: np.ndarray) -> int:
    """Undo the row filters of ``h`` rows of ``1 + stride`` bytes in ``raw``
    (``bpp`` bytes a pixel) into ``out`` ((h, stride) uint8, C order);
    0, or the codec's code for an unknown filter type."""
    if out.shape != (h, stride) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"png_unfilter writes a C-ordered ({h}, {stride}) uint8 array, "
                         f"got {out.dtype} {out.shape}")
    if len(raw) < h * (stride + 1):
        raise ValueError(f"png_unfilter: {len(raw)} bytes for {h} rows of {stride + 1}")
    return jpeg.codec().sp3d_png_unfilter(raw, h, stride, bpp, out.ctypes.data)


def _decode_pnm(data: bytes) -> Optional[np.ndarray]:
    """Binary PGM (P5) / PPM (P6): magic, width, height, maxval separated by
    whitespace (``#`` comments allowed), one whitespace byte, raster."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            pos = data.find(b"\n", pos)
            if pos < 0:
                return None
            continue
        start = pos
        while pos < len(data) and data[pos : pos + 1].isdigit():
            pos += 1
        if start == pos:
            return None
        fields.append(int(data[start:pos]))
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"PNM with maximum value {maxval}: only 255 is decoded")
    c = 3 if data[:2] == b"P6" else 1
    raster = data[pos + 1 : pos + 1 + w * h * c]
    if len(raster) != w * h * c:
        return None
    img = np.frombuffer(raster, np.uint8).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit PNG of ``img`` ((H, W) grey or (H, W, 3) in RGB order),
    every row with the Up filter."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    flat = img.reshape(h, -1)
    up = flat.copy()
    up[1:] -= flat[:-1]  # uint8 wraps, as the filter's modulo 256
    rows = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ctype = 0 if img.ndim == 2 else 2
    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def imwrite(path: str, img_bgr: np.ndarray) -> None:
    """Write a BGR (or grey) uint8 image, as ``cv2.imwrite`` takes it, in
    the format its extension names: ``.jpg``/``.jpeg`` JPEG at quality 95
    (the bytes of ``cv2.imwrite``), ``.png`` PNG."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg", ".jpe"):
        data = jpeg.encode_jpeg(img_bgr, 95)
    elif ext == ".png":
        data = encode_png(img_bgr if img_bgr.ndim == 2 else img_bgr[..., ::-1])
    else:
        raise ValueError(f"imwrite writes .jpg, .jpeg, .jpe or .png, not {path!r}")
    with open(path, "wb") as f:
        f.write(data)


def bgr_to_rgb(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[..., ::-1])


def invert_affine(M: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine map (``cv2.invertAffineTransform``)."""
    M = np.asarray(M, np.float64).reshape(2, 3)
    d = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = M[1, 1] * d, M[0, 0] * d, -M[0, 1] * d, -M[1, 0] * d
    return np.array([[a11, a12, -a11 * M[0, 2] - a12 * M[1, 2]],
                     [a21, a22, -a21 * M[0, 2] - a22 * M[1, 2]]])


def warp_affine(img: np.ndarray, M: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, flags=INTER_LINEAR)`` with its
    default constant border of 0: output pixel (x, y) samples ``img``
    bilinearly at M^-1 (x, y), a tap outside the image counting as 0.
    Coordinates in float64, the blend in float32, rounded half to even."""
    w, h = dsize
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    H, W, C = src.shape
    inv = invert_affine(M)
    xs = np.arange(w, dtype=np.float64)
    ys = np.arange(h, dtype=np.float64)[:, None]
    # pad two zero pixels a side; coordinates clipped into [-1.5, size + 0.5]
    # keep both taps of a point outside the image on the padding
    sx = np.clip(inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2], -1.5, W + 0.5)
    sy = np.clip(inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2], -1.5, H + 0.5)
    x0, y0 = np.floor(sx), np.floor(sy)
    fx = (sx - x0).astype(np.float32)[..., None]
    fy = (sy - y0).astype(np.float32)[..., None]
    Wp = W + 4
    pad = np.zeros((H + 4, Wp, C), src.dtype)
    pad[2:-2, 2:-2] = src
    flat = pad.reshape(-1, C)
    i00 = ((y0.astype(np.int64) + 2) * Wp + x0.astype(np.int64) + 2).reshape(-1)
    v00, v01 = flat[i00].astype(np.float32), flat[i00 + 1].astype(np.float32)
    v10, v11 = flat[i00 + Wp].astype(np.float32), flat[i00 + Wp + 1].astype(np.float32)
    fx, fy = fx.reshape(-1, 1), fy.reshape(-1, 1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    out = np.rint(top + fy * (bot - top))
    out = np.clip(out, 0, 255).astype(np.uint8).reshape(h, w, C)
    return out[..., 0] if squeeze else out


def resize(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, dsize)`` (INTER_LINEAR): output pixel centres mapped
    to (x + 0.5) * W / w - 0.5, taps clamped to the edge; float32 blend,
    rounded."""
    w, h = dsize
    H, W = img.shape[:2]

    def axis(n_out, n_in):
        s = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
        i0 = np.floor(s).astype(np.int64)
        return i0, np.minimum(i0 + 1, n_in - 1), (s - i0).astype(np.float32)

    x0, x1, fx = axis(w, W)
    y0, y1, fy = axis(h, H)
    f = img.astype(np.float32)
    fx = fx.reshape((1, w) + (1,) * (img.ndim - 2))
    fy = fy.reshape((h, 1) + (1,) * (img.ndim - 2))
    rows = f[y0] + fy * (f[y1] - f[y0])
    out = rows[:, x0] + fx * (rows[:, x1] - rows[:, x0])
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
