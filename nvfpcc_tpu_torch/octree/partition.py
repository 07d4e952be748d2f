"""Octree leaf-block partitioner (host, numpy).

Capability rebuild of ``get_octree.cpp``: given a voxelized cloud in a
``2^depth`` cube (depth=10 for vox10), emit

- the origins of all occupied level-``level`` blocks, in the reference's
  traversal order, and
- the breadth-first 8-bit-per-node subtree occupancy string down to
  ``level``.

The reference builds an explicit pointer octree with neighbor/corner LUTs
(``get_octree.cpp:354-469``) but its *outputs* depend only on which blocks are
occupied and the traversal order. The pointer tree is a CPU artifact; here the
same outputs fall out of a Morton sort:

- The reference's depth-first traversal visits children in flag order
  ``flag = (x>=mid) + 2*(y>=mid) + 4*(z>=mid)`` (``get_octree.cpp:375-388``,
  ``Tree::traverse`` ``:334-342``), so leaf origins appear in Morton order
  with bit interleave (z, y, x) from the most significant level. A single
  vectorized Morton-key sort reproduces it exactly (golden-tested against a
  direct simulation of the reference traversal).
- The BFS occupancy string (``get_binary_representation``,
  ``get_octree.cpp:574-595``) is re-derived level by level from the unique
  block prefixes.

Copy of ``nvfpcc_tpu/octree/partition.py`` (the origins payload of a pack is
a format contract; ``tests/test_torch_shared_copies.py`` holds the two equal).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def morton_key_zyx(coords: np.ndarray, depth: int) -> np.ndarray:
    """Morton (Z-order) key with z as the most significant bit of each triple,
    matching the reference's child-flag ordering (z*4 + y*2 + x)."""
    coords = np.asarray(coords, dtype=np.uint64)
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    key = np.zeros(len(coords), dtype=np.uint64)
    for b in range(depth):
        key |= ((x >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b)
        key |= ((y >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + 1)
        key |= ((z >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + 2)
    return key


_NATIVE_MIN_POINTS = 50_000  # below this, numpy is already instant


def leaf_origins(
    points: np.ndarray, depth: int = 10, level: int = 5, use_native: Optional[bool] = None
) -> np.ndarray:
    """Origins of occupied level-``level`` blocks in reference traversal order.

    ``points`` is (N, 3) integer voxel coords in [0, 2^depth). Block size is
    ``2^(depth-level)`` (32 for vox10/l5). Returns int64 (M, 3).

    Large clouds route through the native C++ radix-sort partitioner
    (``native/octree.cpp``) when it is buildable; the numpy path is the
    reference semantics and the fallback (equality is property-tested).
    """
    pts = np.asarray(points, dtype=np.int64)
    if use_native is None:
        use_native = len(pts) >= _NATIVE_MIN_POINTS
    if use_native:
        from nvfpcc_tpu_torch.octree import native

        if native.available():
            return native.leaf_origins(pts, depth, level)
    shift = depth - level
    blocks = np.unique(pts >> shift, axis=0)
    order = np.argsort(morton_key_zyx(blocks, level), kind="stable")
    return blocks[order] << shift


def subtree_occupancy_string(points: np.ndarray, depth: int = 10, level: int = 5) -> str:
    """Breadth-first 8-bit-per-node occupancy string.

    Mirrors ``get_binary_representation`` (``get_octree.cpp:574-595``): start
    from the root, and for every dequeued node emit 8 chars marking which
    children exist (child index = x_bit + 2*y_bit + 4*z_bit); children with
    ``child_level <= level`` are enqueued. Note the reference therefore emits
    occupancy bits down to ``level+1`` (level-``level`` nodes also emit their
    children); we reproduce that faithfully.
    """
    pts = np.asarray(points, dtype=np.int64)
    # occupied node coords at each tree level  (level L -> coords >> (depth-L))
    occupied = {
        lv: np.unique(pts >> (depth - lv), axis=0) for lv in range(0, level + 2)
    }
    occ_sets = {lv: {tuple(c) for c in occupied[lv]} for lv in occupied}

    out = []
    # BFS queue of (level, coord); root is level 0 coord (0,0,0)
    queue = [(0, (0, 0, 0))]
    while queue:
        lv, (cx, cy, cz) = queue.pop(0)
        child_lv = lv + 1
        for flag in range(8):
            xb, yb, zb = flag & 1, (flag >> 1) & 1, (flag >> 2) & 1
            child = (2 * cx + xb, 2 * cy + yb, 2 * cz + zb)
            if child_lv in occ_sets and child in occ_sets[child_lv]:
                out.append("1")
                if child_lv <= level:
                    queue.append((child_lv, child))
            else:
                out.append("0")
    return "".join(out)


def occupancy_to_origins(
    occ_string: str, depth: int, level: int, with_leaf_children: bool = True
) -> np.ndarray:
    """Decode a BFS occupancy string back to leaf origins in reference
    traversal (Morton) order — the inverse of :func:`subtree_occupancy_string`
    restricted to level-``level`` leaves.

    The reference string encodes the subtree down to level+1 (leaf nodes also
    emit their children, ``get_octree.cpp:574-595``) — ``with_leaf_children=
    True`` parses that form. The pack uses the trimmed form (leaves are the
    deepest bits: ``subtree_occupancy_string(..., level-1)``), ~2.5 bits per
    block: the reference ships the string in subtree.txt but then transmits
    raw 3x int16 origins anyway (``NVFPCC.py:436-439``) — 48 bits/block we
    don't spend.
    """
    queue_below = level if with_leaf_children else level - 1
    pos = 0
    queue = [(0, (0, 0, 0))]
    leaves = []
    qi = 0
    while qi < len(queue):
        lv, (cx, cy, cz) = queue[qi]
        qi += 1
        child_lv = lv + 1
        for flag in range(8):
            if pos >= len(occ_string):
                raise ValueError("truncated occupancy string")
            hit = occ_string[pos] == "1"
            pos += 1
            if not hit:
                continue
            child = (2 * cx + (flag & 1), 2 * cy + ((flag >> 1) & 1), 2 * cz + ((flag >> 2) & 1))
            if child_lv == level:
                leaves.append(child)
            if child_lv <= queue_below:
                queue.append((child_lv, child))
    blocks = np.asarray(leaves, dtype=np.int64).reshape(-1, 3)
    order = np.argsort(morton_key_zyx(blocks, level), kind="stable")
    return blocks[order] << (depth - level)


def pack_occupancy_bits(occ_string: str) -> bytes:
    """Bit-pack a '0'/'1' occupancy string (MSB-first)."""
    bits = np.frombuffer(occ_string.encode("ascii"), np.uint8) - ord("0")
    return np.packbits(bits).tobytes()


def unpack_occupancy_bits(data: bytes, n_bits: int) -> str:
    bits = np.unpackbits(np.frombuffer(data, np.uint8))[:n_bits]
    return "".join("1" if b else "0" for b in bits)


def write_origins_txt(path: str, origins: np.ndarray) -> None:
    """CSV origins file in the reference format (``get_octree.cpp:787-795``)."""
    with open(path, "w") as f:
        for o in np.asarray(origins, dtype=np.int64):
            f.write(f"{o[0]},{o[1]},{o[2]}\n")


def partition_cloud(points: np.ndarray, depth: int = 10, level: int = 5):
    """Full partitioner output: (origins, subtree_string)."""
    return leaf_origins(points, depth, level), subtree_occupancy_string(points, depth, level)
