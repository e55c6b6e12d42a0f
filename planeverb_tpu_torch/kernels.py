"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, into ``planeverb_tpu_torch/build/``, under a name tagged with a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing library. Nothing is built or loaded at
import time: the CPU-only test environment imports this module too.

A failed build raises with the compiler's output; there is no fallback.
The wrappers' launch counters live on the wrappers in
``ops/fdtd_fused.py``, ``ops/fdtd_tiled.py``, ``ops/analyzer.py``,
``ops/doa.py`` and ``parallel/solver_fused.py``; the card's launches of
each kernel are counted by the C launchers and read with
:func:`device_launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "DEVICE_KERNELS", "RoundSource",
           "RoundRegion", "MomentsEntry", "ReverbRow", "AnalysisView",
           "ANALYSIS_MAX_VIEWS", "nvcc", "build", "library", "check",
           "device_launches"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_SOURCES = ("fdtd_fused.cu", "moments.cu", "fdtd_tiled.cu",
            "solver_rounds.cu", "dsp_scan.cu", "analysis.cu")
# included by the sources: part of the build's tag
_HEADERS = ("common.cuh", "windows.cuh")
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
    # 7 field planes, pulse, rec, accumulators, [B, 2] listener cells, nx,
    # ny, T, B, bf16, courant, thr, src_dir_n, dry_n, wet_n, stream
    "pv_fdtd_sim": [_P] * 11 + [_I] * 5 + [_F] * 5 + [_P],
    # nx, ny, bf16 -> clusters of B1 the card holds at once
    "pv_fdtd_cluster_occupancy": [_I] * 3,
    # MomentsEntry table, entries, tiles, T, bf16, dry_n + 1, end,
    # log10_scale, stream
    "pv_rt60_moments": [_P] + [_I] * 4 + [_F] * 3 + [_P],
    # the same, then the probe's mode (chip_smoke.py)
    "pv_rt60_moments_probe": [_P] + [_I] * 4 + [_F] * 3 + [_I] + [_P],
    # -> sizeof(Entry) in csrc/moments.cu
    "pv_moments_entry_bytes": [],
    # beta, Y, pulse, rec, 6 accumulators, 2 x (p, vx, vy) state slots,
    # grid-barrier words, nx, ny, T, tile_x, tile_y, k, lix, liy, gx, gy,
    # absorbing, courant, thr, src_dir_n, dry_n, wet_n, stream
    "pv_fdtd_sim_tiled": [_P] * 17 + [_I] * 11 + [_F] * 5 + [_P],
    # the same, then dry and global_acc (probe_tiled.py, chip_smoke.py)
    "pv_fdtd_sim_tiled_probe": [_P] * 17 + [_I] * 11 + [_F] * 5 + [_I] * 2
                               + [_P],
    # rec, onset, s0, s1, nx, ny, T, chunk, dry_n + 1, end, log10_scale,
    # stream
    "pv_rt60_moments_tiled": [_P] * 4 + [_I] * 4 + [_F] * 3 + [_P],
    # region table (device), pulse, barrier words, n_regions, tiles, tile_x,
    # tile_y, k, t0, nsteps, lix, liy, gx, gy, absorbing, banded, courant,
    # thr, src_dir_n, dry_n, wet_n, stream
    "pv_device_round": [_P] * 3 + [_I] * 13 + [_F] * 5 + [_P],
    # -> sizeof(Region) in csrc/solver_rounds.cu
    "pv_round_region_bytes": [],
    # out[n], n, reset -> the number of kernels counted
    "pv_device_launches": [_P, _I, _I],
    # D1: x, y1, y2, cutoff, out, y1_out, y2_out, S, N, fs, 2 pi, sqrt 2,
    # stream
    "pv_biquad_scan": [_P] * 7 + [_I] * 2 + [_F] * 3 + [_P],
    # D2: ReverbRow table, rows, N, 4 comb and 2 allpass delays, lc, la,
    # wrap, damping, 1 - damping, allpass gain, stream
    "pv_reverb_scan": [_P] + [_I] * 11 + [_F] * 3 + [_P],
    # -> sizeof(ReverbRow) in csrc/dsp_scan.cu
    "pv_reverb_row_bytes": [],
    # the DSP's chain probes (chip_smoke.py): kind, blocks, N, three
    # coefficients, out, cycles, stream
    "pv_dsp_chain_probe": [_I] * 3 + [_F] * 3 + [_P] * 3,
    # A1: AnalysisView table, views, occlusion, wet gain, rt60, lowpass,
    # delay, source directivity, direction, walk, first, gx, gy,
    # directions, efree, dx, dry_n, end, fs, c, LOS threshold, close and
    # loud thresholds, stream
    "pv_analysis_assemble": [_P, _I] + [_P] * 9 + [_I] * 3 + [_F] * 9
                            + [_P],
    # A2: [views][2] listener positions (host), views, walk, first,
    # direction, gx, gy, max hops, dx, stream
    "pv_analysis_directions": [_P, _I] + [_P] * 3 + [_I] * 3 + [_F] + [_P],
    # -> sizeof(View) in csrc/analysis.cu
    "pv_analysis_view_bytes": [],
}

# The library's kernels in the order of csrc/common.cuh DeviceKernel. The
# sharded rounds' one kernel (csrc/solver_rounds.cu round_kernel) is
# counted by the mode its launcher ran it in: B5 or B6.
DEVICE_KERNELS = ("fdtd_cluster_kernel", "rt60_moments_kernel",
                  "fdtd_tiled_kernel", "rt60_moments_tiled_kernel",
                  "biquad_scan_kernel", "reverb_scan_kernel",
                  "analysis_assemble_kernel", "analysis_directions_kernel",
                  "round_kernel B5", "round_kernel B6")

# the views an A1 or A2 launch takes (csrc/analysis.cu kMaxViews)
ANALYSIS_MAX_VIEWS = 16


class RoundSource(ctypes.Structure):
    """csrc/solver_rounds.cu ``Source``: one of the 3 x 3 states a round
    region reads at its start (a null ``p`` reads zeros)."""
    _fields_ = [("p", _P), ("plane", _I), ("row", _I), ("i0", _I),
                ("j0", _I)]


class RoundRegion(ctypes.Structure):
    """csrc/solver_rounds.cu ``Region``: one region of a round launch."""
    _fields_ = [("src", RoundSource * 9), ("statics", _P), ("scratch", _P),
                ("rec", _P), ("acc", _P), ("out", _P),
                ("splane", ctypes.c_longlong), ("ex", _I), ("ey", _I),
                ("kx", _I), ("ky", _I), ("bx", _I), ("by", _I),
                ("orow", _I), ("rows", _I), ("oi", _I), ("oj", _I),
                ("tile0", _I), ("tiles_y", _I)]


class MomentsEntry(ctypes.Structure):
    """csrc/moments.cu ``Entry``: one recording of a B2 launch, its onset,
    its s0/s1 outputs, its cells, its first block in the launch and whether
    every row starts 16-byte aligned."""
    _fields_ = [("rec", _P), ("onset", _P), ("s0", _P), ("s1", _P),
                ("cells", ctypes.c_longlong), ("tile0", _I), ("aligned", _I)]


class ReverbRow(ctypes.Structure):
    """csrc/dsp_scan.cu ``ReverbRow``: one row of a D2 launch (one channel
    of one reverb), its input, output, state in and state out; ``pos_out``
    is null on every row of a state but its first."""
    _fields_ = [("x", _P), ("out", _P), ("comb_in", _P), ("comb_out", _P),
                ("lp_in", _P), ("lp_out", _P), ("ap_in", _P), ("ap_out", _P),
                ("pos_in", _P), ("pos_out", _P), ("fb", _F * 4)]


class AnalysisView(ctypes.Structure):
    """csrc/analysis.cu ``View``: one view of an A1 launch, its seven input
    planes (e_dry, e_wet, s0, s1, onset, flux_x, flux_y) at their row
    pitches in elements, the listener's world position with the grid
    offset, and its cell for the free-field normaliser."""
    _fields_ = [("planes", _P * 7), ("pitch", ctypes.c_longlong * 7),
                ("lwx", _F), ("lwy", _F), ("lix", _I), ("liy", _I)]


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
    for name in _SOURCES + _HEADERS:
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
            if lib.pv_round_region_bytes() != ctypes.sizeof(RoundRegion):
                raise RuntimeError(
                    f"RoundRegion is {ctypes.sizeof(RoundRegion)} bytes, "
                    f"the library's Region {lib.pv_round_region_bytes()}")
            if lib.pv_moments_entry_bytes() != ctypes.sizeof(MomentsEntry):
                raise RuntimeError(
                    f"MomentsEntry is {ctypes.sizeof(MomentsEntry)} bytes, "
                    f"the library's Entry {lib.pv_moments_entry_bytes()}")
            if lib.pv_analysis_view_bytes() != ctypes.sizeof(AnalysisView):
                raise RuntimeError(
                    f"AnalysisView is {ctypes.sizeof(AnalysisView)} bytes, "
                    f"the library's View {lib.pv_analysis_view_bytes()}")
            if lib.pv_reverb_row_bytes() != ctypes.sizeof(ReverbRow):
                raise RuntimeError(
                    f"ReverbRow is {ctypes.sizeof(ReverbRow)} bytes, "
                    f"the library's ReverbRow {lib.pv_reverb_row_bytes()}")
            _LIB = lib
        return _LIB


def device_launches(reset: bool = False) -> dict[str, int]:
    """The card's launches of each kernel of :data:`DEVICE_KERNELS` since
    the counts were last reset, as the C launchers count them (one a launch
    the runtime accepted); ``reset`` zeroes them after reading."""
    counts = (ctypes.c_longlong * len(DEVICE_KERNELS))()
    n = library().pv_device_launches(counts, len(DEVICE_KERNELS), int(reset))
    if n != len(DEVICE_KERNELS):
        raise RuntimeError(f"the kernel library counts {n} kernels, "
                           f"DEVICE_KERNELS names {len(DEVICE_KERNELS)}")
    return dict(zip(DEVICE_KERNELS, counts))


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = library().pv_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({msg})")
