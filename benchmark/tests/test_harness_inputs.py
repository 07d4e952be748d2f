"""The inputs the benchmark makes from a seed: the torch grid generator
against bench.py's numpy construction, the origins against the program's
copy, and the same seed giving the same inputs."""

import numpy as np
import torch

from benchmark import generators as G
from benchmark.drivers.decode import frame
from benchmark.harness import Registry
from benchmark.reference.nvfpcc import Model

FLAGSHIP = {"ch": 3, "chanstr": "8,16,8,8", "entropy_mode": "channel", "n_points": 3000}
TRAFFIC = Registry().traffic("decode_closed_loop")


def numpy_grids(nrm, anchor, phase):
    """``bench.py:synthetic_flagship_grids`` after its draws, verbatim."""
    g = (np.arange(32) + 0.5).astype(np.float32)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    coords = np.stack([zz, yy, xx], -1)[None]
    rel = coords - anchor[:, None, None, None, :]
    sd = (rel * nrm[:, None, None, None, :]).sum(-1)
    sd = sd + 2.0 * np.sin(0.12 * rel[..., 0] + phase[:, None, None, None]) * np.cos(0.09 * rel[..., 1])
    gt = (np.abs(sd) < 0.52).astype(np.uint8)
    dist = np.maximum(np.abs(sd) - 0.52, 0.0).astype(np.float32) * (1 - gt)
    return gt, dist


def test_torch_grids_equal_bench_numpy():
    rng = np.random.default_rng(3)
    nrm = rng.standard_normal((5, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    anchor = rng.uniform(10.0, 22.0, (5, 3))
    phase = rng.uniform(0, 2 * np.pi, 5)
    gt, dist = G.flagship_grids(torch.from_numpy(nrm), torch.from_numpy(anchor), torch.from_numpy(phase), chunk=2)
    gt_np, dist_np = numpy_grids(nrm, anchor, phase)
    assert np.array_equal(gt.numpy(), gt_np)
    np.testing.assert_allclose(dist.numpy(), dist_np, rtol=0, atol=1e-6)
    share = gt_np.mean()
    assert 0.01 < share < 0.06  # a one-voxel shell: about 3% of a block


def test_same_seed_same_inputs():
    a = G.training_grids(2**33 + 5, 4, "cpu")
    b = G.training_grids(2**33 + 5, 4, "cpu")
    c = G.training_grids(2**33 + 6, 4, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    o1, o2 = G.synthetic_origins(50, 10, 5, 2**40), G.synthetic_origins(50, 10, 5, 2**40)
    assert np.array_equal(o1, o2)
    model = Model({**FLAGSHIP, "seed_tag": "nvfpcc-tpu/seed-stream/v1"}, "cpu")
    f1 = frame(FLAGSHIP, TRAFFIC, model, np.random.default_rng(9), o1[:4], "cpu")
    f2 = frame(FLAGSHIP, TRAFFIC, model, np.random.default_rng(9), o1[:4], "cpu")
    assert f1[2] == f2[2] and np.array_equal(f1[1], f2[1])
    assert all(np.array_equal(f1[0][k], f2[0][k]) for k in f1[0])


def test_origins_equal_the_programs_copy():
    from nvfpcc_tpu_torch.tools.bench import synthetic_origins

    for seed in (1, 7, 2**35):
        assert np.array_equal(G.synthetic_origins(917, 10, 5, seed), synthetic_origins(917, 10, 5, seed))
    assert np.array_equal(G.synthetic_origins(300, 11, 6, 4), synthetic_origins(300, 11, 6, 4))


def test_decode_frame_keeps_its_points():
    """The threshold splits the reference's occupancy at ``n_points`` voxels."""
    from benchmark.drivers.decode import occupancy

    model = Model({**FLAGSHIP, "seed_tag": "nvfpcc-tpu/seed-stream/v1"}, "cpu")
    origins = G.synthetic_origins(4, 10, 5, 11)
    params, latents, thh = frame(FLAGSHIP, TRAFFIC, model, np.random.default_rng(1), origins, "cpu")
    occ = occupancy(model, params, latents, "cpu")
    assert int((occ > np.float32(thh)).sum()) == FLAGSHIP["n_points"]
    for k in ("decoder/up0/kernel", "decoder/conv2/kernel"):
        assert np.array_equal(params[k] * 16, np.rint(params[k] * 16))  # on the 1/16 grid
