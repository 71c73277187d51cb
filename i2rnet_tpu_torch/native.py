"""The C++ host NMS (``native/nms.cpp``), built at first use and bound with ctypes.

The port's counterpart of ``i2rnet_tpu/native/__init__.py``: the same
library source (``i2r_box_nms``, ``i2r_oks_nms``, ``i2r_soft_oks_nms``), which
the host wrappers of ``ops/nms.py`` run. It is compiled from this checkout's
``native/nms.cpp`` by ``g++ -O3 -fPIC -shared -std=c++17`` into
``i2rnet_tpu_torch/_build/``, named by a hash of the source and the flags,
under a temporary name renamed into place (several processes may build at
once). Unlike the JAX binding, which returns None and lets its callers fall
back to JAX, a failed build or load raises: no path here falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "nms.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "i2r_box_nms": (_F, ctypes.c_int, ctypes.c_float, _I),
    "i2r_oks_nms": (_F, _F, _F, ctypes.c_int, ctypes.c_int, _F, ctypes.c_float, _I),
    "i2r_soft_oks_nms": (_F, _F, _F, ctypes.c_int, ctypes.c_int, _F, ctypes.c_float,
                         ctypes.c_int, _I),
}


def library_path() -> Path:
    if not SOURCE.exists():
        raise RuntimeError(f"the NMS source {SOURCE} is missing; the native NMS cannot be built")
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libi2rnms_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if this source has none yet; returns its path."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native NMS cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    run = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True,
                         text=True)
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({run.returncode}) on {SOURCE}:\n{run.stderr[-3000:]}")
    os.replace(tmp, so)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, built on first call in this process."""
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as err:
        raise RuntimeError(f"the native NMS library {path} does not load: {err}") from err
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _fp(a):
    return a.ctypes.data_as(_F)


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def box_nms(dets, thresh: float):
    """Greedy box NMS over ``dets`` [n, 5]: kept indices in score order."""
    dets = _f32(dets)
    keep = np.zeros(len(dets), np.int32)
    n = library().i2r_box_nms(_fp(dets), len(dets), thresh, keep.ctypes.data_as(_I))
    return keep[:n].tolist()


def oks_nms(kpts, areas, scores, sigmas, thresh: float):
    """Greedy OKS NMS, ``kpts`` [n, k, 3]: kept indices in score order."""
    kpts, areas, scores, sigmas = map(_f32, (kpts, areas, scores, sigmas))
    keep = np.zeros(len(scores), np.int32)
    n = library().i2r_oks_nms(_fp(kpts), _fp(areas), _fp(scores), len(scores), kpts.shape[1],
                              _fp(sigmas), thresh, keep.ctypes.data_as(_I))
    return keep[:n].tolist()


def soft_oks_nms(kpts, areas, scores, sigmas, thresh: float, max_dets: int = 20):
    """Soft OKS NMS (the library rescores a copy of ``scores``): picked
    indices in pick order."""
    kpts, areas, sigmas = map(_f32, (kpts, areas, sigmas))
    scores = np.array(scores, np.float32)
    keep = np.zeros(len(scores), np.int32)
    n = library().i2r_soft_oks_nms(_fp(kpts), _fp(areas), _fp(scores), len(scores),
                                   kpts.shape[1], _fp(sigmas), thresh, max_dets,
                                   keep.ctypes.data_as(_I))
    return keep[:n].tolist()
