"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, into ``planeverb_tpu_torch/build/``, under a name tagged with a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing library. Nothing is built or loaded at
import time: the CPU-only test environment imports this module too.

A failed build raises with the compiler's output; there is no fallback.
The launch counters live on the wrappers in ``ops/fdtd_fused.py`` and
``ops/fdtd_tiled.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "nvcc", "build", "library", "check"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_SOURCES = ("fdtd_fused.cu", "fdtd_tiled.cu")
BUILD_DIR = os.path.join(_PKG, "build")

# -fmad=false: no multiply-add contraction, so every op rounds once, as in
# PyTorch's elementwise kernels (the plain versions). No fast math: the
# kernels rely on IEEE inf, no flush-to-zero, and an exact logf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
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
    # 7 field planes, pulse, rec, 6 accumulators, 2 x (p, vx, vy) state
    # slots, nx, ny, T, tile_x, tile_y, k, lix, liy, courant, thr,
    # src_dir_n, dry_n, wet_n, stream
    "pv_fdtd_sim_tiled": [_P] * 21 + [_I] * 8 + [_F] * 5 + [_P],
    # rec, onset, s0, s1, nx, ny, T, chunk, dry_n + 1, end, log10_scale,
    # stream
    "pv_rt60_moments_tiled": [_P] * 4 + [_I] * 4 + [_F] * 3 + [_P],
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

    Each source compiles in its own nvcc process, all at once. The log
    holds ``ptxas -v``'s registers, shared memory and spills per kernel,
    and sits beside the library. Raises RuntimeError with nvcc's
    output when the build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libpv_kernels-{_tag()}.so")
    log_path = lib_path[:-3] + ".log"
    if force or not os.path.exists(lib_path):
        # one nvcc per source, all started together, then one link; build
        # to a private name and rename, so concurrent builders never load a
        # half-written library
        cc = nvcc()
        tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
        try:
            procs = []
            for name in _SOURCES:
                obj = os.path.join(tmpdir, name + ".o")
                cmd = [cc, *NVCC_FLAGS, "-c", "-o", obj,
                       os.path.join(_CSRC, name)]
                procs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            outs = [(cmd, obj, proc.communicate()[0], proc.returncode)
                    for cmd, obj, proc in procs]
            tmp = os.path.join(tmpdir, "lib.so")
            link = [cc, "-shared", "-o", tmp, *(o for _, o, _, _ in outs)]
            for cmd, _, out, rc in outs:
                if rc != 0:
                    raise RuntimeError(
                        f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(link)}\n"
                    f"{proc.stdout}{proc.stderr}")
            with open(log_path, "w") as f:
                f.write("".join(out for _, _, out, _ in outs))
            os.replace(tmp, lib_path)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
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
