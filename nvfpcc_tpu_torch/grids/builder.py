"""Ground-truth grid builder: occupancy + distance grids per leaf block
(port of ``nvfpcc_tpu/grids/builder.py``).

The cloud is scattered into its bounding grid on the device, the exact
squared EDT runs over it (the CUDA kernel on the card), and each block's
crop is gathered back: ``gt`` (N, B, B, B) uint8 and ``dist`` (N, B, B, B)
float32 = sqrt of the integer squared distance. Every build is
probe-checked against brute force (``validate_dist_grids``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nvfpcc_tpu_torch.grids.edt import squared_edt_3d

_ALIGN = 8  # grid dims are multiples of this (the EDT kernel's contract)
# single-grid budget (int32 bytes); larger bounding grids go through z-slabs
MAX_GRID_BYTES = 3 << 30


def _block_radius(block: int) -> int:
    """Clamp radius: the largest possible in-block distance (block diagonal)."""
    return int(math.ceil(math.sqrt(3.0) * (block - 1))) + 1


def _one_grid(pts, orgs, lo, dims, block: int, radius: int, device: torch.device):
    """Scatter + EDT + per-block crops of one grid, on ``device``."""
    dims = tuple(int(d) for d in dims)
    rel = torch.as_tensor(pts - lo, dtype=torch.int64, device=device)
    occ = torch.zeros(dims, dtype=torch.bool, device=device)
    occ[rel[:, 0], rel[:, 1], rel[:, 2]] = True
    sq = squared_edt_3d(occ, radius)
    # flat index of every block voxel: block base offset + in-block offset
    ro = torch.as_tensor(orgs - lo, dtype=torch.int64, device=device)
    strides = torch.tensor([dims[1] * dims[2], dims[2], 1], dtype=torch.int64, device=device)
    ar = torch.arange(block, dtype=torch.int64, device=device)
    local = (ar[:, None, None] * strides[0] + ar[None, :, None] * strides[1] + ar[None, None, :]).reshape(-1)
    idx = (ro * strides).sum(1)[:, None] + local[None, :]
    shape = (len(orgs), block, block, block)
    gt = occ.reshape(-1)[idx].reshape(shape).to(torch.uint8)
    # sqrt in f64, then one rounding to f32: the correctly rounded f32 sqrt
    # (torch's vectorized f32 sqrt on the CPU is off by 1 ulp for some ints)
    dist = torch.sqrt(sq.reshape(-1)[idx].to(torch.float64)).to(torch.float32).reshape(shape)
    return gt.cpu().numpy(), dist.cpu().numpy()


def build_block_grids(
    points: np.ndarray,
    origins: np.ndarray,
    block: int = 32,
    radius: int | None = None,
    *,
    device: torch.device | str,
    max_grid_bytes: int = MAX_GRID_BYTES,
):
    """Build (gt uint8 (N,B,B,B), dist float32 (N,B,B,B)).

    ``points``: (P, 3) integer voxel coordinates; ``origins``: (N, 3) block
    origins. When the bounding grid exceeds ``max_grid_bytes`` the volume is
    processed in z-slabs of whole blocks with a ``radius`` halo; the
    window-clamped EDT's support is bounded by ``radius`` per axis, so the
    slab results are exact.
    """
    device = torch.device(device)
    pts = np.asarray(points, dtype=np.int64)
    orgs = np.asarray(origins, dtype=np.int64)
    if radius is None:
        radius = _block_radius(block)
    # bounding grid over all blocks, padded by the clamp radius, aligned
    lo = orgs.min(axis=0) - radius
    hi = orgs.max(axis=0) + block + radius
    dims = ((hi - lo + _ALIGN - 1) // _ALIGN) * _ALIGN
    if int(np.prod(dims)) * 4 <= max_grid_bytes:
        return _one_grid(pts, orgs, lo, dims, block, radius, device)

    # --- slab-tiled path: z-bands of whole blocks, each with its halo ---
    xy_cells = int(dims[0] * dims[1])
    z_budget = max(block, int(max_grid_bytes // (4 * xy_cells)) - 2 * radius)
    z_budget = (z_budget // block) * block or block
    slab_dims = np.array(
        [dims[0], dims[1], ((z_budget + 2 * radius + _ALIGN - 1) // _ALIGN) * _ALIGN]
    )
    gt = np.empty((len(orgs), block, block, block), np.uint8)
    dist = np.empty((len(orgs), block, block, block), np.float32)
    z0, z_end = int(orgs[:, 2].min()), int(orgs[:, 2].max())
    while z0 <= z_end:
        sel = (orgs[:, 2] >= z0) & (orgs[:, 2] < z0 + z_budget)
        if sel.any():
            o_b = orgs[sel]
            z_lo = int(o_b[:, 2].min()) - radius
            p_b = pts[(pts[:, 2] >= z_lo) & (pts[:, 2] < z_lo + slab_dims[2])]
            lo_b = np.array([lo[0], lo[1], z_lo])
            gt[sel], dist[sel] = _one_grid(p_b, o_b, lo_b, slab_dims, block, radius, device)
        z0 += z_budget
    return gt, dist


def validate_dist_grids(
    points: np.ndarray,
    origins: np.ndarray,
    dist: np.ndarray,
    block: int,
    radius: int | None = None,
    n_probes: int = 256,
    seed: int = 0,
) -> None:
    """Probe-check distance grids against brute-force NN (host numpy): samples
    ``n_probes`` random block voxels and raises on any mismatch."""
    pts = np.asarray(points, np.int64)
    orgs = np.asarray(origins, np.int64)
    if radius is None:
        radius = _block_radius(block)
    cap_sq = radius * radius + 1
    rng = np.random.default_rng(seed)
    bi = rng.integers(0, len(orgs), n_probes)
    vi = rng.integers(0, block, (n_probes, 3))
    for t in range(n_probes):
        p = orgs[bi[t]] + vi[t]
        best = cap_sq
        for c in range(0, len(pts), 500_000):
            d = int(((pts[c : c + 500_000] - p) ** 2).sum(1).min())
            best = min(best, d)
        want_sq = min(best, cap_sq)
        got = float(dist[bi[t], vi[t, 0], vi[t, 1], vi[t, 2]])
        # distances are sqrt(int); compare the squared integers so 1-ulp
        # f32 sqrt differences between device and host don't false-alarm
        if int(round(got * got)) != want_sq:
            raise RuntimeError(
                f"distance-grid validation failed at block {bi[t]} voxel "
                f"{tuple(vi[t])}: got {got} (d^2~{got*got:.2f}), brute force "
                f"d^2={want_sq} — device EDT fault?"
            )


def build_artifacts(
    points,
    depth: int = 10,
    level: int = 5,
    *,
    device: torch.device | str,
):
    """origins + gt + dist (the reference's three preprocessing artifacts);
    the distance field is always probe-checked against brute force."""
    from nvfpcc_tpu_torch.octree.partition import leaf_origins

    block = 1 << (depth - level)
    origins = leaf_origins(points, depth, level)
    gt, dist = build_block_grids(points, origins, block, device=device)
    validate_dist_grids(points, origins, dist, block)
    return origins, gt, dist
