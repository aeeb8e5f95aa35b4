"""Build and load the port's CUDA kernels and its host code.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``, and
each host source ``csrc/<name>.cpp`` (HOST_SOURCES: the JPEG codec and PNG
unfilter) by the host C++ compiler (``$CXX``, else ``c++`` or ``g++`` on
PATH), into a shared library with a plain C interface, loaded with
``ctypes`` (which releases the GIL for the length of a call). The
library's file name carries a hash of its source and flags, so a changed
source is rebuilt and an unchanged one is reused. Builds go to
``build/kernels/`` at the repository root (listed in ``.gitignore``) and
happen at first use; ``build()`` starts one compiler per source, all at
once, and the first use of a ``MAIN_PATH`` source builds all of them.
Building and loading take a lock, so threads of one process that
reach a library first at the same time (the loader's workers decoding
their first image) build it once. A source may add flags of its own (``EXTRA_FLAGS``); they are part
of the hash.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("slicewarp", "conv3", "sw_variants", "microbench_primitives", "conv_epilogue")
HOST_SOURCES = ("image_codec",)
# the inference and train paths' sources: the first use of one builds all
# of them, one compiler each in parallel
MAIN_PATH = ("slicewarp", "conv_epilogue")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# per-source flags: sw_variants floors interpolated rows, so a*b + c must
# round twice, as the reference computes it, and not once as an FMA
EXTRA_FLAGS = {"sw_variants": ("-fmad=false",)}

# one build or load at a time in this process (re-entrant: library() builds)
_LOCK = threading.RLock()

_P, _I, _S, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_int64
# C signatures: every pointer and the stream as c_void_p, sizes as c_int
# (byte counts as c_size_t, element counts that may pass 2**31 as
# c_int64); each returns an int (a CUDA error code, or the codec's code)
# unless RESTYPES says otherwise
SIGNATURES = {
    "slicewarp": {
        "sp3d_forward_scratch_floats": [_P, _I, _I, _I, _I, _I, _I],
        "sp3d_sample_view": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
        "sp3d_sample_views_mean": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
        "sp3d_sample_view_adjoint": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "conv3": {"sp3d_conv3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    "sw_variants": {
        "sp3d_sw_scratch_floats": [_I, _I, _I, _I, _I],
        "sp3d_sw_variant": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "microbench_primitives": {"sp3d_primitive": [_P, _P, _I, _I, _I, _P]},
    "conv_epilogue": {
        "sp3d_conv_epilogue": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    },
    "image_codec": {
        "sp3d_jpeg_header": [_P, _S, _P, _P, _P],
        "sp3d_jpeg_orientation": [_P, _S],
        "sp3d_jpeg_decode": [_P, _S, _P, _I, _I, _I],
        "sp3d_jpeg_encode": [_P, _I, _I, _I, _I, _P, _S],
        "sp3d_png_unfilter": [_P, _I, _I, _I, _P],
    },
}
RESTYPES = {"sp3d_forward_scratch_floats": ctypes.c_int64,
            "sp3d_sw_scratch_floats": ctypes.c_int64,
            "sp3d_jpeg_encode": ctypes.c_longlong}


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


def cxx() -> str:
    """Path of the host C++ compiler: $CXX, then c++ and g++ on PATH."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler ($CXX, c++ or g++ on PATH): the port's image "
        "codec cannot be built"
    )


def source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def flags(name: str) -> tuple:
    base = CXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS
    return base + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = source(name).read_bytes()
    digest = hashlib.sha1(src + " ".join(flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every library not built yet, one compiler per source in
    parallel (nvcc for a CUDA source, the host compiler for HOST_SOURCES).

    Returns {name: {"seconds": wall time of its compiler (0 when reused),
    "log": its output (register and spill counts from nvcc's -Xptxas -v)}}.
    Raises RuntimeError naming the sources that failed, their compiler and
    its output.
    """
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        result = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                log = out.with_suffix(".log")
                result[name] = {"seconds": 0.0, "log": log.read_text() if log.exists() else ""}
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            compiler = cxx() if name in HOST_SOURCES else nvcc()
            cmd = [compiler, *flags(name), "-o", str(tmp), str(source(name))]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                time.perf_counter(), tmp, out,
            )
        failed = []
        for name, (proc, t0, tmp, out) in procs.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.args[0]} exit {proc.returncode}):\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: concurrent build processes never see half a file
            result[name] = {"seconds": seconds, "log": log}
        if failed:
            raise RuntimeError("build failed: " + "\n".join(failed))
        return result


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with argtypes set."""
    with _LOCK:  # lru_cache does not lock while this runs
        path = library_path(name)
        if not path.exists():
            build([name] + [n for n in MAIN_PATH if name in MAIN_PATH and n != name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = RESTYPES.get(fn, ctypes.c_int)
    return lib
