"""The 8i-format real-data path through the port's CLI on the CPU, v2: the
unfriendly fixture of ``tests/test_real_data_readiness.py``
(``ref_style_vox10_v2.ply``: an open creased sheet with a 50x density
gradient and a one-voxel filament, near-empty blocks) through grids ->
train -> encode -> decode -> eval at the JAX test's settings and its
lenient thh 0.05 (``torch_train_helpers.realdata_pipeline``; v1 is
``tests/test_torch_realdata.py``).

Held: ``rc_enc == rc_dec`` byte for byte, a non-empty reconstruction, eval
exit 0 with a finite D1; both packages read the fixture alike; the port's
grids keep every point of the near-empty blocks (the grid builder's probe check
passed on them); an encode threshold that keeps no voxel stops
``encode_eval`` with its message, never a -inf dB."""

import contextlib
import io

import numpy as np
import pytest

from nvfpcc_tpu_torch.io.ply import read_ply_points
from nvfpcc_tpu_torch.tools import encode_eval
import torch_train_helpers as H
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

FIXTURE = "ref_style_vox10_v2.ply"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return H.realdata_pipeline(tmp_path_factory.mktemp("v2"), FIXTURE, "0.05")


def test_fixture_reads_as_in_the_jax_package():
    pts = H.assert_fixture_reads_alike(FIXTURE)
    assert np.array_equal(pts, np.rint(pts)) and pts.min() >= 0 and pts.max() < 1024


def test_round_trip_parity_and_a_non_empty_cloud(run):
    H.assert_round_trip(run)


def test_eval_prints_a_finite_d1(run):
    H.assert_finite_d1(run)


def test_grids_hold_the_near_empty_blocks(run):
    """The filament's and the sparse end's blocks (5 points or fewer) keep
    every point, at distance 0."""
    pts = np.rint(read_ply_points(run.cloud)).astype(np.int64)
    per_block = run.art["gt"].reshape(len(run.art["gt"]), -1).sum(1)
    assert len(per_block) >= 30 and per_block.min() <= 5 and per_block.max() / per_block.min() >= 50
    assert int(per_block.sum()) == len(pts)
    assert run.art["dist"][run.art["gt"] == 1].max() == 0 and np.isfinite(run.art["dist"]).all()


def test_an_empty_reconstruction_stops_with_the_tools_message(run):
    """v2's trained occupancy is low: at thh 0.99 nothing is kept, and the
    tool stops with its message instead of scoring -inf dB."""
    with pytest.raises(SystemExit, match="reconstruction at thh 0.99 is empty"):
        with contextlib.redirect_stdout(io.StringIO()):
            encode_eval.main([run.cloud, "--ckpt", run.ckpt, "--thh", "0.99", "--no_d2", "--platform", "cpu"])
