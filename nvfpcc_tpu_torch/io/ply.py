"""Minimal PLY point-cloud I/O (host, numpy).

Replaces the reference's Open3D dependency for PLY reading/writing
(``utils/dataloader.py:2``, ``NVFPCC.py:548-554``, ``util_get_grids.py:32``).
Supports ASCII and binary_little_endian vertex clouds; only x/y/z are used
(the reference parses ints and drops color, ``get_octree.cpp:773-778``).

Copy of ``nvfpcc_tpu/io/ply.py`` (held byte-equal by
``tests/test_torch_shared_copies.py``).
"""

from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


def read_ply_points(path: str) -> np.ndarray:
    """Read vertex x/y/z from an ASCII or binary_little_endian PLY.

    Returns float64 (N, 3).
    """
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = None
        props = []  # (name, dtype) for the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError("list properties unsupported in vertex element")
                props.append((tok[2], _PLY_DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        if fmt is None or n_vertex is None:
            raise ValueError(f"{path}: malformed PLY header")

        names = [p[0] for p in props]
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n_vertex, ndmin=2)
            cols = [names.index(c) for c in ("x", "y", "z")]
            return data[:, cols]
        elif fmt == "binary_little_endian":
            dt = np.dtype([(n, "<" + d) for n, d in props])
            data = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt, count=n_vertex)
            return np.stack(
                [data["x"], data["y"], data["z"]], axis=-1
            ).astype(np.float64)
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")


def write_ply_points(path: str, points: np.ndarray, ascii: bool = True) -> None:
    """Write an (N, 3) point cloud as PLY with double x/y/z vertices
    (the coordinate layout Open3D emits for ``rc_enc.ply``/``rc_dec.ply``)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    header = [
        "ply",
        "format ascii 1.0" if ascii else "format binary_little_endian 1.0",
        f"element vertex {len(pts)}",
        "property double x",
        "property double y",
        "property double z",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if ascii:
            np.savetxt(f, pts, fmt="%.10g")
        else:
            f.write(pts.astype("<f8").tobytes())
