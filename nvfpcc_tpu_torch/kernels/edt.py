"""The exact windowed squared EDT: CUDA kernel wrapper + its plain version.

``squared_edt_3d(occ, radius)`` is the port of the Pallas TPU kernel
``nvfpcc_tpu/ops/pallas/edt_pallas.py:squared_edt_3d_pallas``: a (D, H, W)
occupancy grid, every dim a multiple of 8, to int32 squared distances to
the nearest occupied voxel, saturated at ``radius**2 + 1``.

- A CUDA tensor goes to the hand-written kernel ``csrc/edt.cu`` (three
  launches, one per axis: an O(1)-per-voxel row pass, then two register-
  blocked min-plus passes on packed int16 lanes, or int32 lanes above
  R = 127; see the source for the design). It is compiled with ``nvcc``
  for ``sm_90a`` into the port's plain-C kernel library at first use
  (``kernels/build.py``) and bound with ``ctypes``. A build or launch failure raises;
  there is no fallback.
- A CPU tensor goes to ``squared_edt_3d_ref``, the plain PyTorch version
  (a port of the XLA shift-and-min chain, ``nvfpcc_tpu/grids/edt.py``).

``LAUNCHES`` counts the wrapper's kernel runs (one per call on a CUDA
tensor), so a caller can show that a path really went through the kernel.
"""

from __future__ import annotations

import torch

from nvfpcc_tpu_torch.kernels.build import (  # noqa: F401  (the build's names, as before)
    BUILD_DIR, CSRC_DIR, NVCC_FLAGS, build_library, error_string, library_path, load_library,
)

# shared tile of the strided passes: (256 + 2R) x 32 words <= 227 KB
MAX_RADIUS = 780
# the row pass keeps 12 bytes per 32 voxels of a row for each of its 8 warps
MAX_ROW = 1 << 16

LAUNCHES = 0


def _check(occ: torch.Tensor, radius: int) -> None:
    if occ.ndim != 3:
        raise ValueError(f"occupancy must be 3-D, got shape {tuple(occ.shape)}")
    if any(d % 8 for d in occ.shape):
        raise ValueError(f"grid dims must be multiples of 8, got {tuple(occ.shape)}")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius must be in [1, {MAX_RADIUS}], got {radius}")


def lane_bits(radius: int) -> int:
    """Lane width of the kernel's strided passes at this radius: 16 when
    every min-plus term (at most cap + R^2 = 2R^2 + 1) fits int16, else 32."""
    return 16 if 2 * radius * radius + 1 <= 32767 else 32


def squared_edt_3d(occ: torch.Tensor, radius: int) -> torch.Tensor:
    """Exact (window-clamped) squared EDT: the CUDA kernel for a CUDA tensor
    (bool or uint8, contiguous), the plain version for a CPU tensor."""
    global LAUNCHES
    radius = int(radius)
    _check(occ, radius)
    if occ.device.type == "cpu":
        return squared_edt_3d_ref(occ, radius)
    if occ.device.type != "cuda":
        raise ValueError(f"no EDT for device {occ.device}")
    if occ.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"occupancy must be bool or uint8, got {occ.dtype}")
    if not occ.is_contiguous():
        raise ValueError("occupancy must be contiguous")
    d, h, w = occ.shape
    if d * h >= 2**31 or w > MAX_ROW or d > 65535:
        raise ValueError(f"grid {tuple(occ.shape)} is too large for one launch")
    lib = load_library()
    bits = lane_bits(radius)
    out = torch.empty(occ.shape, dtype=torch.int32, device=occ.device)
    scratch = torch.empty(occ.shape, dtype=torch.int16 if bits == 16 else torch.int32, device=occ.device)
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        rc = lib.nvfpcc_edt3d(
            occ.data_ptr(), out.data_ptr(), scratch.data_ptr(), d, h, w, radius, bits, stream
        )
    if rc != 0:
        raise RuntimeError(f"EDT kernel launch failed: {error_string(rc)}")
    LAUNCHES += 1
    return out


def _minplus_pass(f: torch.Tensor, dim: int, radius: int, cap: int) -> torch.Tensor:
    """``out[i] = min(cap, min_{|d|<=R} f[i+d] + d^2)`` along ``dim``, cap
    outside the grid (in-place temporaries: ~4 grids of memory)."""
    n = f.shape[dim]
    padded_shape = list(f.shape)
    padded_shape[dim] += 2 * radius
    padded = torch.full(padded_shape, cap, dtype=torch.int32, device=f.device)
    padded.narrow(dim, radius, n).copy_(f)
    out = torch.clamp_max(f, cap)
    tmp = torch.empty_like(out)
    for d in range(1, radius + 1):
        torch.minimum(padded.narrow(dim, radius - d, n), padded.narrow(dim, radius + d, n), out=tmp)
        tmp.add_(d * d)
        torch.minimum(out, tmp, out=out)
    return out.clamp_max_(cap)


def squared_edt_3d_ref(occ: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the separable
    shift-and-min chain, W pass then H then D."""
    radius = int(radius)
    _check(occ, radius)
    cap = radius * radius + 1
    f = torch.full(occ.shape, cap, dtype=torch.int32, device=occ.device)
    f.masked_fill_(occ.bool(), 0)
    for dim in (2, 1, 0):
        f = _minplus_pass(f, dim, radius, cap)
    return f
