"""Read images from plain paths or ``archive.zip@inner/path`` URIs, with a
zipfile handle cache (ref: lib/utils/zipreader.py), the port's copy of
``selfpose3d_tpu/utils/zipreader.py``. Decoding is ``utils/image_io``'s:
by content, not by extension, as ``cv2.imread`` does."""

from __future__ import annotations

import threading
import zipfile
from typing import Dict, Optional

import numpy as np

from selfpose3d_tpu_torch.utils.image_io import decode

_cache: Dict[str, zipfile.ZipFile] = {}
_lock = threading.Lock()


def split_zip_path(path: str):
    """'a/b.zip@img/x.jpg' -> ('a/b.zip', 'img/x.jpg')."""
    pos = path.index("@")
    return path[:pos], path[pos + 1:]


def is_zip_path(path: str) -> bool:
    return "@" in path


def read_bytes(path: str) -> bytes:
    zip_path, inner = split_zip_path(path)
    with _lock:
        zf = _cache.get(zip_path)
        if zf is None:
            zf = zipfile.ZipFile(zip_path, "r")
            _cache[zip_path] = zf
        return zf.read(inner)


def imread_any(path: str, color: bool = True) -> Optional[np.ndarray]:
    """The image at a plain path or zip URI, BGR as ``cv2.imread`` gives it
    (``color``: 3 channels; else as stored), or None where the file or the
    member is missing or is not an image this package decodes (the datasets
    treat None as a skippable record, ref: lib/dataset/JointsDataset.py:114-117)."""
    try:
        if is_zip_path(path):
            data = read_bytes(path)
        else:
            with open(path, "rb") as f:
                data = f.read()
    except (OSError, KeyError, zipfile.BadZipFile):
        return None
    return decode(data, color)
