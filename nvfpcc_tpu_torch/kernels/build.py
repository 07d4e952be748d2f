"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into
one plain-C shared library under ``nvfpcc_tpu_torch/_build/`` at first use,
keyed by a hash of the sources and flags, and loaded with ``ctypes``; a
second process finds the library built and only loads it. The kernel
wrappers (``kernels/edt.py``, ``kernels/conv_transpose.py``,
``kernels/conv3d.py``) bind their entry points on the one loaded library.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
_lock = threading.Lock()


def library_path() -> str:
    """Where the build of the current ``csrc/*.cu`` sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnvfpcc_kernels_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile ``csrc/*.cu`` with nvcc unless this source hash is built.
    Returns the library path; ptxas' register/shared-memory report is kept
    beside it as ``<lib>.log``. Raises if nvcc is missing or fails."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (no CUDA toolkit); cannot build the CUDA kernels")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *sources], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {r.returncode}):\n{r.stdout}\n{r.stderr}")
    with open(lib + ".log", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded library, built first when needed; every entry point's
    ``argtypes``/``restype`` set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.nvfpcc_edt3d.restype = ctypes.c_int
            lib.nvfpcc_edt3d.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # occ, out, scratch
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # D, H, W
                ctypes.c_int, ctypes.c_int,  # radius, lane_bits
                ctypes.c_void_p,  # stream
            ]
            lib.nvfpcc_conv_transpose3d.restype = ctypes.c_int
            lib.nvfpcc_conv_transpose3d.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, w, bias, out
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # bf16, N, Cin, Cout
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # k, stride, padding
                ctypes.c_void_p, ctypes.c_void_p,  # axes (3 x 6 int32), tables (3 x 4 x MAX_EDGE int16)
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # cin chunk, cout tile, phase groups
                ctypes.c_void_p,  # stream
            ]
            lib.nvfpcc_conv3d.restype = ctypes.c_int
            lib.nvfpcc_conv3d.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, w, bias, out
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # N, Cin, Cout, k, padding
                ctypes.c_void_p,  # geometry (16 int32)
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # the instantiation: k or 0, COT, R
                ctypes.c_void_p,  # stream
            ]
            lib.nvfpcc_kernel_error_string.restype = ctypes.c_char_p
            lib.nvfpcc_kernel_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


def error_string(code: int) -> str:
    return load_library().nvfpcc_kernel_error_string(code).decode()
