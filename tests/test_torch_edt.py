"""The port's EDT: the plain PyTorch version against the JAX XLA
``squared_edt_3d`` (the oracle the Pallas kernel is held to) and brute
force, exactly; the CUDA kernel against the plain version on the card
(``test_torch_edt_cuda.py``, on the card); the wrapper's refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvfpcc_tpu.grids.edt import squared_edt_3d as jax_edt
from nvfpcc_tpu_torch.device import resolve_device
from nvfpcc_tpu_torch.grids.edt import brute_force_sq_dist, squared_edt_3d
from nvfpcc_tpu_torch.kernels import edt as K

# the shapes of tests/test_pallas_edt.py
CASES = [((16, 16, 16), 5, 0), ((24, 32, 40), 9, 1), ((8, 8, 256), 20, 2), ((64, 64, 64), 55, 3)]


@pytest.mark.parametrize("shape,radius,seed", CASES)
def test_plain_matches_jax_xla(shape, radius, seed):
    rng = np.random.default_rng(seed)
    occ = rng.uniform(0, 1, shape) < 0.01
    want = np.asarray(jax_edt(jnp.asarray(occ), radius))
    got = K.squared_edt_3d_ref(torch.as_tensor(occ), radius)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(squared_edt_3d(torch.as_tensor(occ), radius).numpy(), want)


def test_plain_matches_brute_force():
    rng = np.random.default_rng(4)
    occ = rng.uniform(0, 1, (24, 16, 32)) < 0.02
    radius = 12
    got = K.squared_edt_3d_ref(torch.as_tensor(occ), radius).numpy()
    vox = np.argwhere(np.ones(occ.shape, bool))
    want = np.minimum(brute_force_sq_dist(vox, np.argwhere(occ)), radius * radius + 1)
    np.testing.assert_array_equal(got.reshape(-1), want)


def test_empty_grid_saturates():
    got = K.squared_edt_3d_ref(torch.zeros((8, 8, 8), dtype=torch.bool), 3)
    assert (got == 10).all()


def _two_scan_row_pass(occ: np.ndarray, radius: int) -> np.ndarray:
    """What the kernel's row pass computes: ``d <= R ? d^2 : cap``, d the
    distance to the nearest occupied voxel of the row, from a forward and a
    backward scan of nearest-occupied positions."""
    rows, n = occ.shape
    far = 1 << 29
    left, right = np.empty((rows, n), np.int64), np.empty((rows, n), np.int64)
    carry = np.full(rows, -far)
    for w in range(n):
        carry = np.where(occ[:, w], w, carry)
        left[:, w] = carry
    carry = np.full(rows, far)
    for w in range(n - 1, -1, -1):
        carry = np.where(occ[:, w], w, carry)
        right[:, w] = carry
    d = np.minimum(np.arange(n) - left, right - np.arange(n))
    return np.where(d <= radius, np.minimum(d, radius + 1) ** 2, radius * radius + 1)


def _premise_rows(n: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    rows = [rng.uniform(0, 1, (6, n)) < p for p in (0.01, 0.05, 0.3)]
    edge = np.zeros((4, n), bool)
    edge[0, 0] = edge[1, -1] = edge[2, [0, -1]] = True
    edge[3, n // 2] = True
    rows += [np.zeros((1, n), bool), np.ones((1, n), bool), edge, np.eye(n, dtype=bool)]
    return np.concatenate(rows)


@pytest.mark.parametrize("radius", [1, 3, 20, 55, 127, 200])
def test_row_pass_premise_two_scan_equals_window(radius):
    """The windowed min-plus pass over a 0/cap row equals the O(1)-per-voxel
    nearest-occupied form the kernel's row pass uses, on random, empty and
    full rows and with occupancy at both borders."""
    occ = _premise_rows(96)
    cap = radius * radius + 1
    f = torch.full(occ.shape, cap, dtype=torch.int32)
    f.masked_fill_(torch.as_tensor(occ), 0)
    window = K._minplus_pass(f, 1, radius, cap).numpy()
    np.testing.assert_array_equal(_two_scan_row_pass(occ, radius), window)


@pytest.mark.parametrize("radius,bits", [(1, 16), (55, 16), (63, 16), (111, 16), (127, 16), (128, 32), (221, 32)])
def test_lane_choice_fits_every_term(radius, bits):
    """Every min-plus term of the strided passes is at most cap + R^2 =
    2R^2 + 1: the chosen lane type holds it, and int16 is taken wherever it
    does."""
    assert K.lane_bits(radius) == bits
    worst = 2 * radius * radius + 1
    assert worst <= np.iinfo(np.int16 if bits == 16 else np.int32).max
    assert (bits == 16) == (worst <= np.iinfo(np.int16).max)
    assert radius <= K.MAX_RADIUS


def test_wrapper_refusals():
    with pytest.raises(ValueError, match="multiples of 8"):
        squared_edt_3d(torch.zeros((10, 16, 16), dtype=torch.bool), 3)
    with pytest.raises(ValueError, match="radius"):
        squared_edt_3d(torch.zeros((8, 8, 8), dtype=torch.bool), 0)
    # a device that is neither CPU nor CUDA has no EDT, and no silent fallback
    with pytest.raises(ValueError, match="no EDT for device"):
        squared_edt_3d(torch.zeros((8, 8, 8), dtype=torch.bool, device="meta"), 3)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal path is not reachable")
    for platform in ("default", "device"):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            resolve_device(platform)
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_without_toolkit_raises():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        pytest.skip("a CUDA toolkit is installed: the refusal path is not reachable")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build_library()


def test_library_path_is_keyed_by_source():
    path = K.library_path()
    assert path.startswith(K.BUILD_DIR) and path.endswith(".so")
    assert path == K.library_path()
