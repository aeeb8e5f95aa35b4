"""Photometric RandAugment + Cutout for the input pipelines (ref:
lib/dataset/randaugment.py:18-67,355-531, the RandomAugumnetCutOut wrapper
of JointsDatasetSSV.py:27-42), the port's copy of
``selfpose3d_tpu/data/randaugment.py``.

The seven ops are Pillow's (``ImageEnhance`` Sharpness, Contrast, Color,
Brightness; ``ImageOps`` autocontrast, posterize, equalize) written in
numpy on uint8 RGB arrays: the lookup-table ops give Pillow's values
exactly, the four enhance ops blend with a degenerate image in float32
and truncate as Pillow's ``Image.blend`` does. The draws from the random
stream are the JAX module's in the same order, so one seed gives the same
policies, strengths and Cutout boxes. There is no fallback: the ops need
nothing but numpy.

  * policies are ordered pairs of ops drawn uniformly from 7 photometric
    ops x magnitude indices 1..9, each applied with probability 0.5;
  * enhance ops use strength 1 +- 0.1 * idx with a random sign;
    posterize keeps round(linspace(8, 4, 10))[idx] bits;
  * cutout draws 2..15 patches of size 20..39, each centred uniformly over
    the image and clipped at the borders, filled with RGB (125, 122, 113).
"""

from __future__ import annotations

import numpy as np

# fill color of reference Cutout patches (ref: randaugment.py:70)
_CUTOUT_FILL = (125, 122, 113)

# round(linspace(8, 4, 10)) (ref: randaugment.py:379)
_POSTERIZE_BITS = np.round(np.linspace(8, 4, 10)).astype(int)

# Pillow's ImageFilter.SMOOTH: 3x3 kernel (1 1 1 / 1 5 1 / 1 1 1) / 13
_SMOOTH = np.array([1, 1, 1, 1, 5, 1, 1, 1, 1], np.float32) / np.float32(13)


def _signed(mag_idx: int, rs) -> float:
    return 1.0 + 0.1 * mag_idx * (1 if rs.rand() < 0.5 else -1)


def _lut(img: np.ndarray, luts) -> np.ndarray:
    """Per-channel lookup tables (one shared table or one per channel),
    their entries clipped to [0, 255] as ``Image.point`` clips them."""
    luts = np.clip(np.asarray(luts, np.int64), 0, 255).astype(np.uint8).reshape(-1, 256)
    if len(luts) == 1:
        return luts[0][img]
    return np.stack([luts[c][img[..., c]] for c in range(img.shape[-1])], axis=-1)


def _grey(img: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    r, g, b = (img[..., c].astype(np.uint32) for c in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def blend(degenerate: np.ndarray, img: np.ndarray, factor: float) -> np.ndarray:
    """``Image.blend(degenerate, img, factor)``: float32 d + f * (i - d),
    truncated, clipped to [0, 255]."""
    d = degenerate.astype(np.float32)
    out = d + np.float32(factor) * (img.astype(np.float32) - d)
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def smooth(img: np.ndarray) -> np.ndarray:
    """``img.filter(ImageFilter.SMOOTH)``: the 3x3 kernel summed in float32
    row by row, rounded; the outermost rows and columns copied."""
    out = img.copy()
    h, w = img.shape[:2]
    if h < 3 or w < 3:
        return out
    f = img.astype(np.float32)
    acc = np.zeros((h - 2, w - 2) + img.shape[2:], np.float32)
    # Pillow sums the row below first, then this row, then the row above
    for k, dy in enumerate((2, 1, 0)):
        row = f[dy : dy + h - 2]
        acc += (row[:, 0 : w - 2] * _SMOOTH[3 * k] + row[:, 1 : w - 1] * _SMOOTH[3 * k + 1]
                + row[:, 2:w] * _SMOOTH[3 * k + 2])
    out[1:-1, 1:-1] = np.clip(acc + np.float32(0.5), 0.0, 255.0).astype(np.uint8)
    return out


def sharpness(img, factor):
    return blend(smooth(img), img, factor)


def contrast(img, factor):
    hist = np.bincount(_grey(img).reshape(-1), minlength=256)
    mean = int((hist * np.arange(256)).sum() / hist.sum() + 0.5)
    return blend(np.full_like(img, mean), img, factor)


def color(img, factor):
    return blend(np.repeat(_grey(img)[..., None], 3, axis=-1), img, factor)


def brightness(img, factor):
    return blend(np.zeros_like(img), img, factor)


def autocontrast(img):
    """``ImageOps.autocontrast`` (cutoff 0): each channel's [lo, hi]
    stretched to [0, 255] by int(i * 255 / (hi - lo) - lo * scale)."""
    luts = []
    for c in range(img.shape[-1]):
        present = np.flatnonzero(np.bincount(img[..., c].reshape(-1), minlength=256))
        lo, hi = int(present[0]), int(present[-1])
        if hi <= lo:
            luts.append(np.arange(256))
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        luts.append([min(max(int(i * scale + offset), 0), 255) for i in range(256)])
    return _lut(img, luts)


def posterize(img, bits):
    return _lut(img, np.arange(256) & ~(2 ** (8 - int(bits)) - 1))


def equalize(img):
    """``ImageOps.equalize``: each channel through its cumulative histogram
    in steps of (count - last bin) // 255."""
    luts = []
    for c in range(img.shape[-1]):
        h = np.bincount(img[..., c].reshape(-1), minlength=256)
        histo = h[h > 0]
        step = (int(histo.sum()) - int(histo[-1])) // 255 if len(histo) > 1 else 0
        if not step:
            luts.append(np.arange(256))
            continue
        n = step // 2 + np.concatenate([[0], np.cumsum(h)[:-1]])
        luts.append(n // step)
    return _lut(img, luts)


def _sharpness(img, mag_idx, rs):
    return sharpness(img, _signed(mag_idx, rs))


def _autocontrast(img, mag_idx, rs):
    return autocontrast(img)


def _posterize(img, mag_idx, rs):
    return posterize(img, _POSTERIZE_BITS[mag_idx])


def _equalize(img, mag_idx, rs):
    return equalize(img)


def _contrast(img, mag_idx, rs):
    return contrast(img, _signed(mag_idx, rs))


def _color(img, mag_idx, rs):
    return color(img, _signed(mag_idx, rs))


def _brightness(img, mag_idx, rs):
    return brightness(img, _signed(mag_idx, rs))


# reference trans_list order (ref: randaugment.py:480-489)
_OPS = [
    _sharpness,
    _autocontrast,
    _posterize,
    _equalize,
    _contrast,
    _color,
    _brightness,
]


def rand_augment(image: np.ndarray, rs: np.random.RandomState, n_ops: int = 2) -> np.ndarray:
    """Apply a random 2-op photometric policy (uint8 HWC RGB in/out): each
    of ``n_ops`` ops is drawn uniformly from ops x magnitudes 1..9 and
    applied with probability 0.5 (ref: randaugment.py:494-505,455-459)."""
    img = image
    for _ in range(n_ops):
        op = _OPS[rs.randint(len(_OPS))]
        mag_idx = int(rs.randint(1, 10))
        if rs.rand() < 0.5:
            img = op(img, mag_idx, rs)
    return img


def cutout_patch(image: np.ndarray, rs: np.random.RandomState, size: int) -> None:
    """One border-clipped cutout patch, in place (ref: randaugment.py:22-71)."""
    h, w = image.shape[:2]
    cy = rs.randint(0, h)
    cx = rs.randint(0, w)
    y0, x0 = max(0, cy - size // 2), max(0, cx - size // 2)
    y1, x1 = min(h, cy + size // 2), min(w, cx + size // 2)
    if y1 > y0 and x1 > x0:
        image[y0:y1, x0:x1] = np.array(
            _CUTOUT_FILL[: image.shape[2] if image.ndim == 3 else 1],
            dtype=image.dtype,
        )


def cutout(
    image: np.ndarray,
    rs: np.random.RandomState,
    min_holes: int = 2,
    max_holes: int = 16,
    min_size: int = 20,
    max_size: int = 40,
) -> np.ndarray:
    """2..15 gray patches of 20..39 px (ref: JointsDatasetSSV.py:36-42;
    bounds are numpy-randint half-open like the reference's)."""
    out = image.copy()
    for _ in range(rs.randint(min_holes, max_holes)):
        cutout_patch(out, rs, int(rs.randint(min_size, max_size)))
    return out


class RandAugmentCutout:
    """Composite policy used by the datasets (ref: JointsDatasetSSV.py:27-42)."""

    def __init__(self, use_randaug: bool = True, use_cutout: bool = True):
        self.use_randaug = use_randaug
        self.use_cutout = use_cutout

    def __call__(self, image: np.ndarray, rs: np.random.RandomState) -> np.ndarray:
        if image.dtype != np.uint8:
            image = np.clip(image, 0, 255).astype(np.uint8)
        if self.use_randaug:
            image = rand_augment(image, rs)
        if self.use_cutout:
            image = cutout(image, rs)
        return image
