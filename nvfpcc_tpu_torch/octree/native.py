"""ctypes binding for the native C++ octree partitioner (``native/octree.cpp``).

First-class native rebuild of the reference's octree tool capability
(``get_octree.cpp``): same outputs (leaf origins in traversal order + BFS
occupancy string) via Morton radix sort instead of a pointer tree. The pure
numpy implementation in ``nvfpcc_tpu_torch.octree.partition`` is the reference
semantics; this is the fast path for large clouds and the fallback if the
toolchain is unavailable.

Copy of ``nvfpcc_tpu/octree/native.py`` (held equal by
``tests/test_torch_shared_copies.py``); the port builds ``native/octree.cpp``
into its own ``_build/`` (``utils/native.py``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from nvfpcc_tpu_torch.utils import native as _native

_lib = None
_lib_failed = False
_lock = threading.Lock()


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(_native.build("octree.cpp"))
            lib.nvfpcc_octree_origins.restype = ctypes.c_long
            lib.nvfpcc_octree_origins.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_long,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_long,
            ]
            lib.nvfpcc_octree_occupancy.restype = ctypes.c_long
            lib.nvfpcc_octree_occupancy.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_long,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_char_p,
                ctypes.c_long,
            ]
            _lib = lib
        except Exception:
            _lib_failed = True
        return _lib


def available() -> bool:
    return _load_lib() is not None


def leaf_origins(points: np.ndarray, depth: int, level: int) -> np.ndarray:
    """Native origins (int64 (M, 3)), reference traversal order."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native octree library unavailable")
    coords = np.ascontiguousarray(points, np.int32)
    n = len(coords)
    cap = max(n, 1)
    out = np.empty((cap, 3), np.int32)
    m = lib.nvfpcc_octree_origins(
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        depth,
        level,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap,
    )
    if m < 0:
        raise ValueError("native octree partition failed (bad coords?)")
    return out[:m].astype(np.int64)


def subtree_occupancy_string(points: np.ndarray, depth: int, level: int) -> str:
    """Native BFS occupancy string (same as partition.subtree_occupancy_string)."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native octree library unavailable")
    coords = np.ascontiguousarray(points, np.int32)
    n = len(coords)
    cap = 16 * max(n, 1) + 8
    buf = ctypes.create_string_buffer(cap)
    m = lib.nvfpcc_octree_occupancy(
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        depth,
        level,
        buf,
        cap,
    )
    if m < 0:
        raise ValueError("native octree occupancy failed")
    return buf.raw[:m].decode("ascii")


def partition_cloud(points: np.ndarray, depth: int, level: int) -> Tuple[np.ndarray, str]:
    return (
        leaf_origins(points, depth, level),
        subtree_occupancy_string(points, depth, level),
    )
