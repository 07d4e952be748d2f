"""The CUDA EDT kernel against its plain PyTorch version, on the card.

Marked ``cuda``: the kernel has no CPU mode, so these skip without a card.
The file imports no jax, so it also runs where jax is not installed; there
``--noconftest`` keeps out ``tests/conftest.py`` (which imports jax and
registers the marker), so the command registers the marker itself:

    python -m pytest tests/test_torch_edt_cuda.py -m cuda --noconftest -o "markers=cuda: needs a CUDA card" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from nvfpcc_tpu_torch.kernels import edt as K

CASES = [
    ((16, 16, 16), 5, 0), ((24, 32, 40), 9, 1), ((8, 8, 256), 20, 2), ((64, 64, 64), 55, 3),
    ((256, 256, 256), 55, 5), ((200, 256, 136), 63, 6),
    # int16 lanes at their edge, int32 lanes above it, the generic radius
    ((40, 48, 56), 1, 7), ((136, 144, 152), 127, 8), ((136, 144, 152), 128, 9),
    ((200, 208, 216), 221, 10), ((96, 80, 72), 111, 11), ((16, 24, 32), 780, 12),
    ((264, 24, 16), 55, 13),
]
# special grids: (name, shape, radius)
SPECIAL = [("empty", (64, 72, 80), 55), ("full", (64, 72, 80), 63), ("corners", (72, 64, 136), 55),
           ("corners", (72, 64, 136), 128), ("empty", (40, 40, 40), 221)]


def special_grid(name: str, shape) -> np.ndarray:
    """An empty grid, a full grid, or a single voxel in each of the 8
    corners (each corner its own grid, stacked along a leading axis)."""
    if name == "empty":
        return np.zeros((1, *shape), bool)
    if name == "full":
        return np.ones((1, *shape), bool)
    grids = np.zeros((8, *shape), bool)
    for i in range(8):
        grids[i, tuple(-1 if i >> a & 1 else 0 for a in range(3))] = True
    return grids


@pytest.mark.cuda
@pytest.mark.parametrize("shape,radius,seed", CASES)
def test_cuda_kernel_matches_plain(shape, radius, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(seed)
    occ = torch.as_tensor(rng.uniform(0, 1, shape) < 0.02, device="cuda")
    before = K.LAUNCHES
    got = K.squared_edt_3d(occ, radius)
    want = K.squared_edt_3d_ref(occ, radius)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,radius", SPECIAL)
def test_cuda_kernel_special_grids(name, shape, radius):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for occ_np in special_grid(name, shape):
        occ = torch.as_tensor(occ_np, device="cuda")
        got = K.squared_edt_3d(occ, radius)
        want = K.squared_edt_3d_ref(occ, radius)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_wrapper_refusals():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with pytest.raises(TypeError, match="bool or uint8"):
        K.squared_edt_3d(torch.zeros((8, 8, 8), dtype=torch.int32, device="cuda"), 3)
    with pytest.raises(ValueError, match="contiguous"):
        K.squared_edt_3d(torch.zeros((8, 8, 16), dtype=torch.bool, device="cuda")[:, :, ::2], 3)
