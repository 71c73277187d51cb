"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library lands in ``i2rnet_tpu_torch/_build/``, named by a hash
of the sources and flags, so an edited source builds anew and an unchanged one
is loaded as it is. Nothing is downloaded: the build reads only the sources in
this checkout and the CUDA toolkit (``$CUDA_HOME``, else ``/usr/local/cuda``,
else ``nvcc`` on ``PATH``). A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types: pointers and the stream as void*
SIGNATURES = {
    "i2r_mhsa_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    "i2r_encoder_ffn_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _F, _I, _I, _P),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libi2r_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; returns its path.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``<name>.log``.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call in this process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err} at launch")
