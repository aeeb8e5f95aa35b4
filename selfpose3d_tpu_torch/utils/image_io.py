"""Image decoding, PNG encoding and the bilinear affine warp, in numpy and
the standard library: what OpenCV does for the JAX package's data path
(``cv2.imread``/``imdecode``, ``cv2.imwrite``, ``cv2.warpAffine``,
``cv2.cvtColor``).

``decode`` picks the decoder by the first bytes, as ``cv2.imread`` does,
and returns the image in BGR order, as OpenCV does:

  * PNG, 8 bits a sample, grey, grey + alpha, RGB or RGBA, not interlaced,
    all five row filters (None, Sub and Up rows are unfiltered with numpy;
    Average and Paeth rows, which depend on the pixel to their left, in a
    Python loop over the row's bytes, far slower: the encoders of OpenCV
    and Pillow choose Paeth for many rows of a photograph);
  * binary PPM (P6) and PGM (P5) with a maximum value of 255;
  * JPEG through OpenCV, else Pillow, where one of them is installed; else
    an ``ImportError`` that says so.

Anything else, a truncated file or a failed PNG checksum gives None, as
``cv2.imread`` gives; a PNG of a kind this module does not decode raises.
``encode_png`` writes 8-bit grey or RGB PNG rows with the Up filter;
``warp_affine`` and ``resize`` are OpenCV's bilinear ``warpAffine`` and
``resize`` within one level of 255.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# PNG colour type -> samples a pixel (grey, RGB, grey + alpha, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def decode(data: bytes, color: bool = True) -> Optional[np.ndarray]:
    """The image in ``data`` as uint8, or None if it is not one this
    module reads. ``color``: (H, W, 3) BGR, grey replicated and alpha
    dropped (``cv2.IMREAD_COLOR``); else as stored, alpha dropped: (H, W)
    grey or (H, W, 3) BGR."""
    if data.startswith(PNG_SIGNATURE):
        img = _decode_png(data)
    elif data[:2] in (b"P5", b"P6"):
        img = _decode_pnm(data)
    elif data.startswith(JPEG_SIGNATURE):
        img = _decode_jpeg(data)
    else:
        return None
    if img is None:
        return None
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2) if color else img
    return np.ascontiguousarray(img[..., 2::-1])  # RGB(A) -> BGR


def _paeth_row(raw: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(raw)):
        a = raw[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        raw[i] = (raw[i] + pred) & 0xFF


def _average_row(raw: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(raw)):
        a = raw[i - bpp] if i >= bpp else 0
        raw[i] = (raw[i] + ((a + prev[i]) >> 1)) & 0xFF


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
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[y] = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(buf), np.uint8)
        else:
            return None
        prev = out[y]
    img = out.reshape(h, w, bpp)
    if bpp in (1, 2):
        return img[..., 0]
    return img[..., :3]


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


def _decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """JPEG through OpenCV, else Pillow; returns RGB (or grey)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        return None if bgr is None else bgr[..., ::-1]
    try:
        from PIL import Image, UnidentifiedImageError
    except ImportError:
        raise ImportError(
            "decoding JPEG needs OpenCV (cv2) or Pillow, and neither is installed; "
            "store the images as PNG or PPM, which this module decodes itself") from None
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except (UnidentifiedImageError, OSError):
        return None


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


def imwrite_png(path: str, img_bgr: np.ndarray) -> None:
    """Write a BGR (or grey) uint8 image as PNG, as ``cv2.imwrite`` takes it."""
    img = img_bgr if img_bgr.ndim == 2 else img_bgr[..., ::-1]
    with open(path, "wb") as f:
        f.write(encode_png(img))


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
