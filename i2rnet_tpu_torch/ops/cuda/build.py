"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library lands in ``i2rnet_tpu_torch/_build/``, named by a hash
of the sources, the headers they share (``csrc/*.cuh``) and the flags, so an
edited source builds anew and an unchanged one is loaded as it is. Nothing is downloaded: the build reads only the sources in
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# C entry points and their argument types: pointers and the stream as void*
SIGNATURES = {
    "i2r_mhsa_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    "i2r_encoder_ffn_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _F, _I, _I, _P),
    "i2r_mhsa_train_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                           _P, _U, _U, _U, _F, _I, _P, _P),
    "i2r_mhsa_train_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _F, _I, _P, _U, _U, _U, _F, _I, _P, _P),
    "i2r_ffn_train_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I,
                          _P, _P, _U, _U, _U, _F, _I, _P),
    "i2r_ffn_train_bwd": (_P,) * 20 + (_I, _I, _I, _F, _I, _I, _I, _P, _P, _U, _U, _U, _F,
                                        _I, _P),
    "i2r_window_attn_fwd": (_P,) * 11 + (_I,) * 7 + (_F, _I, _P),
    "i2r_window_attn_train_fwd": (_P,) * 13 + (_I,) * 7 + (_F, _I, _P),
    "i2r_window_attn_train_bwd": (_P,) * 19 + (_I,) * 8 + (_F, _F, _I, _P),
    "i2r_mlp_block_fwd": (_P,) * 11 + (_I,) * 8 + (_F, _I, _P),
    "i2r_mlp_dwbn_fwd": (_P,) * 9 + (_I,) * 9 + (_P,),
    "i2r_full_block_fwd": (_P,) * 21 + (_I,) * 11 + (_F, _I, _P),
    "i2r_full_block_plan": (_I,) * 12 + (_P,),
    "i2r_conv_epilogue": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
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
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libi2r_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; returns its path.

    One ``nvcc -c`` per source, all started together, then one link. The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``<name>.log``.
    """
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = BUILD_DIR / f"{so.stem}.{os.getpid()}.obj"
    objs.mkdir(exist_ok=True)
    procs = [(src, objs / f"{src.stem}.o") for src in sources()]
    running = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
               for src, obj in procs]
    outs = [p.communicate()[0] for p in running]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o in procs)],
                          capture_output=True, text=True)
    log = "".join(f"== {src.name}\n{out}" for (src, _), out in zip(procs, outs))
    so.with_suffix(".log").write_text(log + link.stdout + link.stderr)
    shutil.rmtree(objs, ignore_errors=True)
    failed = [(src.name, p.returncode, out) for (src, _), p, out in zip(procs, running, outs)
              if p.returncode != 0]
    if failed or link.returncode != 0:
        tmp.unlink(missing_ok=True)
        detail = "".join(f"{n} ({rc}):\n{out[-3000:]}" for n, rc, out in failed)
        raise RuntimeError(f"nvcc failed: {detail or link.stderr[-3000:]}")
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
