"""Build and load the port's CUDA kernels, and build its native host
library (``build_native``, loaded by ``io/native.py``).

Every ``seeksv_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
Hopper (``sm_90a``), one compiler process per source, all started
together, and linked into one shared library with a plain C interface,
at first use, under ``build/seeksv_tpu_torch/<source hash>/`` in the
checkout.  The library is loaded with ``ctypes``; each entry point takes
device pointers and the CUDA stream as ``c_void_p`` and returns the
launch's ``cudaGetLastError()`` code.  Nothing here includes PyTorch's
headers, so a build takes seconds, not minutes.

No fallback: a missing ``nvcc`` or a failed build raises with the
compiler's output.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "seeksv_tpu_torch")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]
LIB_NAME = "libseeksv_tpu_torch_kernels.so"
# the native host library: the repo's C++ source, flags as csrc/Makefile
NATIVE_SRC = os.path.join(os.path.dirname(_PKG), "csrc", "seeksv_native.cpp")
NATIVE_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
NATIVE_LIB_NAME = "libseeksv_native.so"

_lock = threading.RLock()
_lib = None
# filled by the first build: seconds spent in nvcc (0.0 when the library
# was already built for these sources) and the compiler's output
build_info = {"seconds": None, "log": "", "path": None}
# the same for the native host library (build_native)
native_info = {"seconds": None, "path": None, "libdeflate": None}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures of the entry points (all return cudaError_t as int)
_SIGNATURES = {
    # q4, qlen, tstart, tlen, h0, refp, n_codes, B, LQ, LT, reverse,
    # order, seg, out, stream
    "seeksv_extend_resident": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                               _P, _P, _P, _P],
    # q, qlen, t, tlen, h0, B, LQ, LT, order, seg, out, stream
    "seeksv_extend_windows": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                              _P],
    # mat, lens, N, LP, k, keys, n_keys, key_bits, prefix_tab, tab_size,
    # shift, max_occ, lo, cnt, stream
    "seeksv_seed_lookup": [_P, _P, _I, _I, _I, _P, _LL, _I, _P, _LL, _I, _I,
                           _P, _P, _P],
    # q, t, dlo, m, n, B, LQ, LT, K, score, dirs, stream
    "seeksv_banded_dir": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # dirs, m, n, dlo, B, LQ, K, runs_len, runs_op, n_runs, stream
    "seeksv_traceback": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    # seq_l, len_l, LL, seq_r, len_r, LR, n_reads, NG, G, S, num, den,
    # support, n_slots, slot_of, overflow, src_l, src_r, stream
    "seeksv_consensus_scan": [_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _LL,
                              _LL, _P, _P, _P, _P, _P, _P, _P],
    # pos, end, lq, mpos, mtid, fwd, mfwd, base_ok, R, lo, hi, beg, up_pos,
    # down_pos, down_tid, same_tid, case_code, min_ins, max_ins, J,
    # window_cap, out, stream
    "seeksv_discordant_count": [_P] * 8 + [_LL] + [_P] * 10 + [_I, _LL, _P,
                                                              _P],
}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from seeksv_tpu_torch/csrc at first use")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return srcs, h.hexdigest()[:16]


def _build() -> str:
    srcs, key = _sources()
    out_dir = os.path.join(BUILD_ROOT, key)
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        build_info.update(seconds=0.0, path=lib_path)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = os.path.join(out_dir, f".{LIB_NAME}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in srcs:
        obj = os.path.join(out_dir, f".{os.path.basename(src)}."
                                    f"{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _obj, proc in jobs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"exit {proc.returncode}: {' '.join(cmd)}")
    build_info["log"] = "".join(logs)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed) + "\n"
                           + build_info["log"])
    cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *(obj for _c, obj, _p in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for _c, obj, _p in jobs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)   # atomic: concurrent builds never tear
    build_info.update(seconds=time.perf_counter() - t0, path=lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(_build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.seeksv_extend_bins.argtypes = []
            handle.seeksv_extend_bins.restype = ctypes.c_int
            handle.seeksv_extend_bin_edge.argtypes = [_I]
            handle.seeksv_extend_bin_edge.restype = ctypes.c_int
            handle.seeksv_cuda_error_string.argtypes = [_I]
            handle.seeksv_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def _cpu_identity() -> str:
    """What ``-march=native`` depends on: the machine and its CPU's
    feature flags, so a library built on one host is not loaded on
    another that lacks its instructions."""
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return ident + line
    except OSError:
        pass
    return ident


def build_native() -> str:
    """Build the native host library (BAM decode, host extension and
    finalize ladder, seeding, index build) from the repo's C++ source
    ``csrc/seeksv_native.cpp`` with ``g++``, flags as ``csrc/Makefile``
    has them, into ``build/seeksv_tpu_torch/native/<hash>/``, and return
    the library's path.  Nothing is written beside the source.

    ``-DUSE_LIBDEFLATE -ldeflate`` is added only where the preprocessor
    finds ``libdeflate.h`` (the Makefile's own probe passes a backslash to
    the preprocessor under GNU make >= 4.3 and so always says yes).  The
    library lands by an atomic rename, so concurrent builds (test
    workers) never see a torn file and need no lock.  Raises
    RuntimeError when the source or the compiler is missing or the
    build fails; ``io.native`` turns that into "not available"."""
    with _lock:
        if native_info["path"]:
            return native_info["path"]
        if not os.path.exists(NATIVE_SRC):
            raise RuntimeError(f"native source not found: {NATIVE_SRC}")
        cxx = os.environ.get("CXX", "g++")
        with open(NATIVE_SRC, "rb") as f:
            h = hashlib.sha256(f.read())
        h.update(" ".join([cxx, *NATIVE_CXXFLAGS]).encode())
        h.update(_cpu_identity().encode())
        out_dir = os.path.join(BUILD_ROOT, "native", h.hexdigest()[:16])
        lib_path = os.path.join(out_dir, NATIVE_LIB_NAME)
        # what the header probe said when the library was built
        probe_path = os.path.join(out_dir, "libdeflate")
        if os.path.exists(lib_path) and os.path.exists(probe_path):
            with open(probe_path) as f:
                native_info.update(seconds=0.0, path=lib_path,
                                   libdeflate=f.read().strip() == "yes")
            return lib_path
        t0 = time.perf_counter()
        try:
            probe = subprocess.run(
                [cxx, "-E", "-x", "c++", "-"],
                input="#include <libdeflate.h>\n", capture_output=True,
                text=True)
        except OSError as exc:
            raise RuntimeError(f"{cxx} not found: {exc}") from exc
        deflate = probe.returncode == 0
        os.makedirs(out_dir, exist_ok=True)
        tmp = os.path.join(out_dir, f".{NATIVE_LIB_NAME}.{os.getpid()}.tmp")
        cmd = [cxx, *NATIVE_CXXFLAGS,
               *(["-DUSE_LIBDEFLATE"] if deflate else []),
               "-shared", "-o", tmp, NATIVE_SRC, "-lz", "-lpthread",
               *(["-ldeflate"] if deflate else [])]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"native build failed (exit "
                               f"{proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        with open(tmp + ".probe", "w") as f:
            f.write("yes\n" if deflate else "no\n")
        os.replace(tmp + ".probe", probe_path)   # before the library lands
        os.replace(tmp, lib_path)
        native_info.update(seconds=time.perf_counter() - t0, path=lib_path,
                           libdeflate=deflate)
        return lib_path


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        msg = lib().seeksv_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({rc})")
