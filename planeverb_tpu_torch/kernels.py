"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, into ``planeverb_tpu_torch/build/``, under a name tagged with a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing library. Nothing is built or loaded at
import time: the CPU-only test environment imports this module too.

A failed build raises with the compiler's output; there is no fallback.
The launch counters live on the wrappers in ``ops/fdtd_fused.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "nvcc", "build", "library", "check"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_SOURCES = ("fdtd_fused.cu",)
BUILD_DIR = os.path.join(_PKG, "build")

# -fmad=false: no multiply-add contraction, so every op rounds once, as in
# PyTorch's elementwise kernels (the plain versions). No fast math: the
# kernels rely on IEEE inf, no flush-to-zero, and an exact logf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "--ptxas-options=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # 7 field planes, pulse, rec, 6 accumulators, 4 velocity buffers,
    # nx, ny, T, lix, liy, courant, thr, src_dir_n, dry_n, wet_n, stream
    "pv_fdtd_sim": [_P] * 19 + [_I] * 5 + [_F] * 5 + [_P],
    # rec, onset, s0, s1, nx, ny, T, dry_n + 1, end, log10_scale, stream
    "pv_rt60_moments": [_P] * 4 + [_I] * 3 + [_F] * 3 + [_P],
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def nvcc() -> str:
    """Path of the CUDA compiler (from CUDA_HOME, PATH or the default
    toolkit location, as PyTorch's extension builder finds it)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit "
                           "to build the planeverb_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(force: bool = False) -> tuple[str, str]:
    """Compile the kernels; returns (library path, compiler log).

    The log holds ``ptxas -v``'s registers, shared memory and spills per
    kernel, and sits beside the library. Raises RuntimeError with nvcc's
    output when the build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libpv_kernels-{_tag()}.so")
    log_path = lib_path[:-3] + ".log"
    if force or not os.path.exists(lib_path):
        # build to a private name and rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(os.path.join(_CSRC, s) for s in _SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        with open(log_path, "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    log = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = f.read()
    return lib_path, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.pv_error_string.argtypes = [_I]
            lib.pv_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = library().pv_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({msg})")
