"""The port's point-to-plane D2 metric (``nvfpcc_tpu_torch.metrics.d2``)
against nvfpcc_tpu.metrics.d2 on the CPU: ``d2_psnr`` equal to the JAX
package's on seeded clouds (the normals are the same numpy code and the
EDT distances are exact, so the mse values are equal, not close);
``nn_vectors`` against brute force, and the saturated EDT distance beyond
the window refused; the plane, tangential-shift, degenerate-normal and
identical-cloud properties of tests/test_d2.py; and ``eval --d2`` printing
the JAX CLI's D2 line. (tests/test_torch_shared_copies.py holds the copied
numpy helpers equal to the originals.)"""

import contextlib
import io

import numpy as np
import pytest

from nvfpcc_tpu import cli as jax_cli
from nvfpcc_tpu.io.ply import write_ply_points
from nvfpcc_tpu.metrics import d2_psnr as jax_d2_psnr
from nvfpcc_tpu_torch.cli import main
from nvfpcc_tpu_torch.metrics import d1_psnr, d2_psnr, nn_vectors
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

KEYS = ("mse_ab", "mse_ba", "mse", "psnr")


def _plane(z=5, n=16):
    g = np.arange(n)
    xx, yy = np.meshgrid(g, g, indexing="ij")
    return np.stack([xx.ravel(), yy.ravel(), np.full(n * n, z)], 1).astype(np.int64)


def _surface(seed, n=1200, size=48):
    """A bumpy closed surface (a torus-like ring) and a jittered copy of it."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 2 * np.pi, n)
    u = rng.uniform(0, 2 * np.pi, n)
    c, r1, r2 = size / 2, size * 0.3, size * 0.1
    pts = np.stack([c + (r1 + r2 * np.cos(u)) * np.cos(t), c + (r1 + r2 * np.cos(u)) * np.sin(t),
                    c + r2 * np.sin(u)], -1)
    a = np.unique(np.clip(np.rint(pts), 0, size - 1).astype(np.int64), axis=0)
    b = np.unique(np.clip(np.rint(pts + rng.normal(0, 0.8, pts.shape)), 0, size - 1).astype(np.int64), axis=0)
    return a, b


@pytest.mark.parametrize("seed,radius", [(0, 63), (1, 12)])
def test_d2_psnr_equals_jax(seed, radius):
    a, b = _surface(seed)
    want = jax_d2_psnr(a, b, depth=6, radius=radius, platform="cpu")
    got = d2_psnr(a, b, depth=6, radius=radius, device="cpu")
    assert {k: got[k] for k in KEYS} == want
    assert want["mse"] > 0 and got["normals_s"] > 0 and got["nn_s"] >= got["edt_s"] > 0


def test_nn_vectors_exact_vs_brute_force():
    rng = np.random.default_rng(3)
    a = np.unique(rng.integers(0, 30, (150, 3)), axis=0)
    b = np.unique(rng.integers(0, 30, (120, 3)), axis=0)
    e, j = nn_vectors(a, b, radius=60, device="cpu")
    diff = b[:, None, :] - a[None, :, :]
    np.testing.assert_array_equal((e * e).sum(-1), (diff * diff).sum(-1).min(0))
    np.testing.assert_array_equal(a + e, b[j])
    # beyond the window the EDT reports radius^2 + 1, which is refused
    with pytest.raises(ValueError, match="exceeds the EDT window"):
        nn_vectors(np.array([[0, 0, 0]]), np.array([[9, 0, 0]]), radius=8, device="cpu")


def test_normal_shift_d2_equals_d1():
    a, b = _plane(z=5), _plane(z=6)
    m1 = d1_psnr(a, b, depth=6, radius=4, device="cpu")
    m2 = d2_psnr(a, b, depth=6, radius=4, device="cpu")
    assert m1["mse"] == 1.0 and m2["mse"] == pytest.approx(1.0)
    assert m2["psnr"] == pytest.approx(m1["psnr"])


def test_tangential_shift_is_free_for_d2():
    a = _plane(z=5)
    b = a.copy()
    b[:, 0] += 1  # along the surface
    assert d1_psnr(a, b, depth=6, radius=4, device="cpu")["mse"] > 0.0
    m2 = d2_psnr(a, b, depth=6, radius=4, device="cpu")
    assert m2["mse"] < 1e-12 and m2["psnr"] == float("inf")


def test_degenerate_normals_keep_the_full_error_and_identical_clouds():
    a, b = np.array([[5, 5, 5]]), np.array([[5, 5, 7]])
    assert d2_psnr(a, b, depth=6, radius=4, device="cpu")["mse"] == 4.0
    assert d1_psnr(a, b, depth=6, radius=4, device="cpu")["mse"] == 4.0
    m = d2_psnr(_plane(), _plane(), depth=6, radius=4, device="cpu")
    assert m["mse"] == 0.0 and m["psnr"] == float("inf")


def test_eval_d2_prints_the_jax_d2_line(tmp_path):
    """The clouds of ``test_d2_psnr_equals_jax[0-63]``, so that the JAX
    package's EDT programs are compiled once for this file."""
    a, b = _surface(0)
    pa, pb = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    write_ply_points(pa, a)
    write_ply_points(pb, b)
    outs = []
    for run in (main, jax_cli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run(["eval", pa, pb, "--d2", "--depth", "6", "--platform", "cpu"]) == 0
        outs.append([ln for ln in buf.getvalue().splitlines() if ln.startswith("[eval] D")])
    port, jax_lines = outs
    assert port[:2] == jax_lines and jax_lines[1].startswith("[eval] D2 PSNR")
    assert port[2].startswith("[eval] D2 seconds: normals")
