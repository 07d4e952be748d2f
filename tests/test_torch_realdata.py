"""The 8i-format real-data path through the port's CLI on the CPU, v1: the
fixture of ``tests/test_real_data_readiness.py`` (``ref_style_vox10.ply``:
ascii PLY, float x/y/z + uchar colours, 8i header comments, 8 blocks) goes
grids -> train -> encode -> decode -> eval with ``python -m
nvfpcc_tpu_torch.cli ... --platform cpu`` at the JAX test's settings (ch 2,
chanstr 4,8,4,4, 8 epochs, phase change 3, batch 4, eval every 4, thh 0.4;
``torch_train_helpers.realdata_pipeline``). v2 is
``tests/test_torch_realdata_v2.py``.

Held: ``rc_enc == rc_dec`` byte for byte, a non-empty reconstruction, eval
exit 0 with a finite D1; both packages read the fixture alike; the port's
grids npz equals the JAX package's (gt and dist exactly, as
``tests/test_torch_grids.py`` holds the builder); the JAX package decodes
the port's pack to the port's points, apart from voxels within 1e-4 of
``thh``."""

import re

import numpy as np
import pytest

from nvfpcc_tpu import codec as JC
from nvfpcc_tpu.grids.builder import build_artifacts as jax_build_artifacts
from nvfpcc_tpu_torch import codec as TC
from nvfpcc_tpu_torch.io.ply import read_ply_points
import torch_train_helpers as H
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

FIXTURE = "ref_style_vox10.ply"
BAND = 1e-4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return H.realdata_pipeline(tmp_path_factory.mktemp("v1"), FIXTURE, "0.4")


def test_fixture_reads_as_in_the_jax_package():
    assert H.assert_fixture_reads_alike(FIXTURE).shape == (4898, 3)


def test_round_trip_parity_and_a_non_empty_cloud(run):
    H.assert_round_trip(run)
    assert len(re.findall(r"TEST\]", run.out["train"])) == 2  # epochs 0 and 4


def test_eval_prints_a_finite_d1(run):
    H.assert_finite_d1(run)


def test_grids_equal_the_jax_packages(run):
    pts = np.rint(read_ply_points(run.cloud)).astype(np.int64)
    origins, gt, dist = jax_build_artifacts(pts, 10, 5, platform="cpu")
    assert len(origins) == 8 and int(gt.sum()) == len(pts)
    np.testing.assert_array_equal(run.art["origins"], origins)
    np.testing.assert_array_equal(run.art["gt"], gt)
    np.testing.assert_array_equal(run.art["dist"], dist)


def test_pack_decodes_in_the_jax_package(run):
    jpts, info = JC.decode(JC.load_pack(run.pack))
    ours = np.rint(read_ply_points(run.rc_dec)).astype(np.int64)
    assert info["n_blocks"] == 8 and len(jpts) > 0
    H.assert_only_band_differs(ours, np.asarray(jpts), TC.load_pack(run.pack), BAND)
