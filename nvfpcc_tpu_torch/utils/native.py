"""Builds the host C++ coders (``native/*.cpp`` at the repo root) for the port.

The sources are the same files the JAX package builds with ``native/Makefile``
into ``native/build/``; the port compiles them itself, with the Makefile's
flags, into ``nvfpcc_tpu_torch/_build/``, so the two packages never write the
same shared library. Each library is keyed by a hash of its source and flags
and written atomically (temp file + rename), so concurrent processes that
build the same source agree on one file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")  # native/Makefile's


def build(source: str) -> str:
    """Compile ``native/<source>`` into a shared library unless this source
    hash is built; returns its path. Raises ``OSError`` without a compiler
    and ``subprocess.CalledProcessError`` if the compile fails."""
    src = os.path.join(NATIVE_DIR, source)
    with open(src, "rb") as f:
        h = hashlib.sha256(" ".join(CXXFLAGS).encode() + b"\0" + f.read()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{os.path.splitext(source)[0]}_{h}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    subprocess.run(
        [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, src], check=True, capture_output=True
    )
    os.replace(tmp, lib)
    return lib
