"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface and loaded with ``ctypes``. The
library's file name carries a hash of its source, so a changed source is
rebuilt and an unchanged one is reused. Builds go to ``build/kernels/``
at the repository root (listed in ``.gitignore``) and happen at first
use; ``build()`` starts one ``nvcc`` per source, all at once. A source
may add flags of its own (``EXTRA_FLAGS``); they are part of the hash.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("slicewarp", "conv3", "sw_variants", "microbench_primitives")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# per-source flags: sw_variants floors interpolated rows, so a*b + c must
# round twice, as the reference computes it, and not once as an FMA
EXTRA_FLAGS = {"sw_variants": ("-fmad=false",)}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: every pointer and the stream as c_void_p, sizes as c_int
SIGNATURES = {
    "slicewarp": {
        "sp3d_sample_view": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "sp3d_sample_views_mean": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "sp3d_sample_view_adjoint": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "conv3": {"sp3d_conv3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    "sw_variants": {
        "sp3d_sw_variant": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "microbench_primitives": {"sp3d_primitive": [_P, _P, _I, _I, _P]},
}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the port's "
        "CUDA kernels cannot be built"
    )


def flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every library not built yet, one nvcc per source in parallel.

    Returns {name: {"seconds": wall time of its nvcc (0 when reused),
    "log": nvcc's output (register and spill counts from -Xptxas -v)}}.
    Raises RuntimeError naming the sources that failed.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    result = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            result[name] = {"seconds": 0.0, "log": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter(), tmp, out,
        )
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: concurrent build processes never see half a file
        result[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return result


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with argtypes set."""
    path = library_path(name)
    if not path.exists():
        build([name])
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib
