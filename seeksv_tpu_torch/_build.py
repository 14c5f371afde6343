"""Build and load the port's CUDA kernels.

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

_lock = threading.RLock()
_lib = None
# filled by the first build: seconds spent in nvcc (0.0 when the library
# was already built for these sources) and the compiler's output
build_info = {"seconds": None, "log": "", "path": None}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures of the entry points (all return cudaError_t as int)
_SIGNATURES = {
    # q4, qlen, tstart, tlen, h0, refp, n_codes, B, LQ, LT, reverse,
    # out, stream
    "seeksv_extend_resident": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                               _P, _P],
    # q, qlen, t, tlen, h0, B, LQ, LT, out, stream
    "seeksv_extend_windows": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    # mat, lens, N, LP, k, keys, n_keys, key_bits, prefix_tab, tab_size,
    # shift, max_occ, lo, cnt, stream
    "seeksv_seed_lookup": [_P, _P, _I, _I, _I, _P, _LL, _I, _P, _LL, _I, _I,
                           _P, _P, _P],
    # q, t, dlo, m, n, B, LQ, LT, K, score, dirs, stream
    "seeksv_banded_dir": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # dirs, m, n, dlo, B, LQ, K, runs_len, runs_op, n_runs, stream
    "seeksv_traceback": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
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
            handle.seeksv_extend_cells_per_thread.argtypes = [_I]
            handle.seeksv_extend_cells_per_thread.restype = ctypes.c_int
            handle.seeksv_cuda_error_string.argtypes = [_I]
            handle.seeksv_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def ensure_native() -> bool:
    """Build the shared native host library (``csrc/libseeksv_native.so``,
    through ``csrc/Makefile``) when it is missing or older than its
    source, then report whether ``seeksv_tpu.io.native`` loads it.

    The Makefile's own libdeflate probe passes a backslash to the
    preprocessor under GNU make >= 4.3 and so claims libdeflate wherever
    a compiler exists; the build then fails on hosts without the header
    and every host stage falls back to its slow numpy/python form.  Here
    the header is probed directly and the result handed to make, and a
    failed earlier load in this process is retried."""
    from seeksv_tpu.io import native
    csrc = os.path.join(os.path.dirname(_PKG), "csrc")
    so = os.path.join(csrc, "libseeksv_native.so")
    src = os.path.join(csrc, "seeksv_native.cpp")
    fresh = os.path.exists(so) and (
        not os.path.exists(src)
        or os.path.getmtime(so) >= os.path.getmtime(src))
    if not fresh and os.path.exists(src):
        lock = os.path.join(csrc, ".build_lock")   # shared with native.py
        try:
            os.mkdir(lock)
        except FileExistsError:
            t0 = time.monotonic()
            while os.path.exists(lock) and time.monotonic() - t0 < 300:
                time.sleep(0.1)
        else:
            try:
                probe = subprocess.run(
                    [os.environ.get("CXX", "g++"), "-E", "-x", "c++", "-"],
                    input="#include <libdeflate.h>\n", capture_output=True,
                    text=True)
                have = "1" if probe.returncode == 0 else "0"
                subprocess.run(["make", "-s", f"HAVE_LIBDEFLATE={have}"],
                               cwd=csrc, capture_output=True, timeout=300)
            finally:
                os.rmdir(lock)
        if native._LIB is None:
            native._TRIED = False   # a load attempted before the build
    return native.available()


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        msg = lib().seeksv_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({rc})")
